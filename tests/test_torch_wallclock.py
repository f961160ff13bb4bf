"""The simulator's wall-clock projection in the port
(``repro_torch.sim.wallclock``) against the JAX package's, on the CPU.

``tests/test_sim.py``'s three wall-clock cases (scenario ordering, the price
floor, calibration from a measured step) run on the port; across the
packages, the roofline price of a step (``step_time_seconds`` with an
explicit ``HW``) and a run's calibrated projection are the reference's
exactly.  The cost model's FLOPs of the toy's step are not compared: the
30-dim problem is all small elementwise ops, which each framework splits
differently (``tests/test_torch_costmodel.py`` compares programs whose
products dominate)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sim as jsim
from repro.launch.roofline import HW as JHW
from repro_torch.core import (
    OptimizerConfig,
    build_topology,
    make_linear_regression,
    make_optimizer,
)
from repro_torch.launch.roofline import HW
from repro_torch.sim import (
    MIN_STEP_S,
    SimSpec,
    calibrate_from_dryrun,
    payload_bytes,
    project_wallclock,
    simulate,
    step_costs,
    step_time_seconds,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem8():
    return make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0,
                                  device="cpu")


def _grad(problem):
    return lambda x, _s: problem.grad(x)


def _sim(opt, topology, n, x0, grad_fn, **kw):
    return simulate(opt, SimSpec(topology=topology, n=n, **kw), x0, grad_fn)


def _x0():
    return torch.zeros((8, 6), dtype=torch.float32)


# ---------------------------------------------------------------------------
# tests/test_sim.py's wall-clock cases, on the port
# ---------------------------------------------------------------------------


def test_wallclock_projection_orders_scenarios(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    topo = build_topology("ring", 8)
    r_h = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=20,
               scenario="homogeneous")
    r_s = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=20,
               scenario="straggler_1slow", seed=0)
    p_h = project_wallclock(r_h, topo, opt=opt, grad_fn=_grad(problem8))
    p_s = project_wallclock(r_s, topo, opt=opt, grad_fn=_grad(problem8))
    for key in ("step_time_s", "wallclock_s", "steps_per_s", "dominant",
                "compute_s", "memory_s", "collective_s", "stall_s"):
        assert key in p_h
    assert p_h["step_time_s"] > 0
    assert p_s["wallclock_s"] > p_h["wallclock_s"]  # straggler costs time
    assert p_s["steps_per_s"] < p_h["steps_per_s"]
    assert p_h["stall_s"] == 0.0 and p_s["stall_s"] > 0.0


def test_wallclock_price_floor_is_physically_plausible(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    topo = build_topology("ring", 8)
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=20,
             scenario="homogeneous")
    p = project_wallclock(r, topo, opt=opt, grad_fn=_grad(problem8))
    assert p["step_time_s"] >= MIN_STEP_S
    assert p["dominant"] == "latency"  # the toy's roofline is below the floor
    assert p["roofline_s"] < p["step_time_s"]
    assert 0 < p["steps_per_s"] <= 8 / MIN_STEP_S * (1 + 1e-6)
    raw = step_time_seconds(topo, payload_bytes(r.params), min_step_s=0.0)
    assert raw["step_time_s"] == raw["roofline_s"] < MIN_STEP_S


def test_wallclock_calibration_from_dryrun_pinned(problem8, tmp_path):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    topo = build_topology("ring", 8)
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=20,
             scenario="straggler_1slow", seed=0)

    measured = 0.05  # 50 ms/step, as launch.train --measure-json reports it
    path = tmp_path / "measure.json"
    path.write_text(json.dumps({"measured_step_s": measured}))
    assert calibrate_from_dryrun(measured) == measured
    assert calibrate_from_dryrun({"measured_step_s": measured}) == measured
    assert calibrate_from_dryrun(str(path)) == measured
    with pytest.raises(ValueError):
        calibrate_from_dryrun({"wrong_key": 1.0})
    with pytest.raises(ValueError):
        calibrate_from_dryrun(0.0)

    p = project_wallclock(r, topo, opt=opt, grad_fn=_grad(problem8),
                          measured_step_s=calibrate_from_dryrun(str(path)))
    assert p["dominant"] == "measured"
    assert p["step_time_s"] == measured
    assert p["wallclock_s"] == r.sim_time * measured
    total_steps = int(r.steps[r.alive].sum())
    assert p["steps_per_s"] == pytest.approx(total_steps / (r.sim_time * measured))
    assert {"compute_s", "memory_s", "collective_s", "roofline_s"} <= set(p)


def test_calibration_reads_the_trainers_measure_json(tmp_path):
    """The file ``repro_torch.launch.train --measure-json`` writes."""
    from repro_torch.launch import train

    path = tmp_path / "m.json"
    res = train.main(["--nodes", "2", "--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                      "--seq-len", "16", "--per-node-batch", "1", "--device", "cpu",
                      "--measure-json", str(path)])
    assert calibrate_from_dryrun(str(path)) == res["step_s"] > 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "int8-row-ef"])
@pytest.mark.parametrize("topology", ["ring", "exp", "one-peer-exp", "full"])
def test_step_price_equals_the_references(topology, compression):
    """The same flops, bytes and payload on the same hardware numbers price
    to the reference's step exactly, floor and all."""
    hw = dict(peak_flops=67e12, hbm_bw=3.35e12, link_bw=450e9)
    for flops, nbytes, payload, floor in ((1e12, 4e9, 2.6e9, MIN_STEP_S),
                                          (10.0, 100.0, 96.0, MIN_STEP_S),
                                          (10.0, 100.0, 96.0, 0.0)):
        kw = dict(flops_per_node=flops, hbm_bytes_per_node=nbytes, gossips_per_step=2,
                  compression=compression, min_step_s=floor)
        got = step_time_seconds(build_topology(topology, 8), payload, hw=HW(**hw), **kw)
        want = jsim.step_time_seconds(jcore.build_topology(topology, 8), payload,
                                      hw=JHW(**hw), **kw)
        assert got == want


@pytest.mark.parametrize("scenario", ["homogeneous", "straggler_1slow"])
def test_calibrated_projection_equals_the_references(scenario):
    """Both packages simulate the same schedule (``tests/test_torch_sim.py``):
    pinned to one measured step, the projections agree exactly."""
    jprob = jcore.make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0)
    tprob = make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0,
                                   device="cpu")
    kw = dict(topology="ring", n=8, lr=1e-2, n_steps=20, scenario=scenario, seed=0)
    jopt = jcore.make_optimizer(jcore.OptimizerConfig(algorithm="decentlam", momentum=0.8))
    topt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    jr = jsim.simulate(jopt, jsim.SimSpec(**kw), jnp.zeros((8, 6), jnp.float32),
                       lambda x, _s: jprob.grad(x))
    tr = simulate(topt, SimSpec(**kw), _x0(), _grad(tprob))
    assert payload_bytes(tr.params) == jsim.payload_bytes(jr.params)
    hw = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
    want = jsim.project_wallclock(jr, jcore.build_topology("ring", 8), opt=jopt,
                                  hw=JHW(**hw), measured_step_s=0.612)
    got = project_wallclock(tr, build_topology("ring", 8), opt=topt, hw=HW(**hw),
                            measured_step_s=0.612)
    for key in ("sim_time", "wallclock_s", "steps_per_s", "stall_s", "device_hours",
                "step_time_s", "dominant", "collective_s", "gossip_egress_bytes"):
        assert got[key] == want[key], key


def test_step_costs_price_the_stacked_step_per_node(problem8):
    """The cost model over the simulator's stacked step, divided by n: the
    gradient's two products per node (A x and A^T r, m x d each way) are in
    it, and the price is positive."""
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    c = step_costs(opt, build_topology("ring", 8), _x0(), _grad(problem8))
    m, d = problem8.A.shape[1:]
    assert c["flops_per_node"] > 2 * 2 * m * d
    assert c["hbm_bytes_per_node"] > 0
    assert np.isfinite(c["flops_per_node"])
