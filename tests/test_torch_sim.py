"""The discrete-event simulator's engines in the port (``repro_torch.sim``)
against the JAX package, on the CPU.

The reference's own cases (``tests/test_sim.py``, all but its three
wall-clock tests) run on the port: the oracle stays the oracle (the event
engine at equal constant speeds, zero delay and no events == the port's
``run_stacked`` bit for bit, every algorithm x topology; the delayed engine
at delay 0 too), the vectorized engine == the per-node engine bit for bit,
determinism, SSP bounds, failures.  Across the packages, for the same seed
and scenario, the host-side schedule is the reference's exactly — which
node steps when, the version gaps each step sees, stall times, sim time,
events, kept nodes — and the iterates agree within f32 rounding."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sim as jsim
import repro.sim.runner as jrunner
import repro.sim.vectorized as jvec
import repro_torch.sim.runner as trunner
import repro_torch.sim.vectorized as tvec
from repro_torch.core import (
    ALGORITHMS,
    DelayedStackedChannel,
    OptimizerConfig,
    bias_to_optimum,
    build_topology,
    make_linear_regression,
    make_optimizer,
    run_stacked,
)
from repro_torch.interop import to_numpy
from repro_torch.sim import (
    ConstantDuration,
    EventQueue,
    FailStop,
    LognormalDuration,
    PeriodicStragglerDuration,
    Rejoin,
    Scenario,
    SimSpec,
    delay_matrix,
    effective_batch_fraction,
    get_scenario,
    is_diverged,
    node_rngs,
    run_delayed,
    simulate,
)
from repro_torch.utils import tree_leaves

N, D, M = 4, 4, 6
TOPOLOGIES = ["ring", "torus", "exp", "one-peer-exp", "random-match", "full"]
EVENT_SCENARIOS = [
    "homogeneous", "straggler_1slow", "straggler_1slow_async",
    "failstop_quarter", "churn", "straggler_tail",
]
# port vs reference iterates (parameters, the final metric), of each leaf's
# max |value|: both iterate in f32, XLA and torch round in their own orders
RUN_RTOL = 1e-4
# optimizer state, absolutely: DecentLaM's (x - mix) / lr carries the
# iterates' f32 roundoff amplified by 1/lr (tests/test_torch_reference.py)
STATE_ULPS = 10 * 2.0**-23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return make_linear_regression(n=N, m=M, d=D, noise=0.01, seed=0, heterogeneity=1.0,
                                  device="cpu")


@pytest.fixture(scope="module")
def problem8():
    return make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0,
                                  device="cpu")


def _grad(problem):
    return lambda x, _s: problem.grad(x)


def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _sim(opt, topology, n, x0, grad_fn, **kw):
    return simulate(opt, SimSpec(topology=topology, n=n, **kw), x0, grad_fn)


def _x0(n=8, d=6):
    return torch.zeros((n, d), dtype=torch.float32)


# ---------------------------------------------------------------------------
# The oracle remains the oracle (bit for bit, within the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_event_engine_matches_oracle(problem, algorithm, topology):
    """Homogeneous speeds, no events, zero delay == run_stacked bit for bit."""
    opt = make_optimizer(OptimizerConfig(algorithm=algorithm, momentum=0.8))
    x0 = _x0(N, D)
    p_ref, s_ref, _ = run_stacked(opt, build_topology(topology, N), x0, _grad(problem),
                                  lr=1e-2, n_steps=4)
    for engine in ("pernode", "vectorized"):
        res = _sim(opt, topology, N, x0, _grad(problem), lr=1e-2, n_steps=4,
                   scenario="homogeneous", engine=engine)
        assert (res.steps == 4).all()
        assert _tree_equal(res.params, p_ref), engine
        assert _tree_equal(res.opt_state, s_ref), engine


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_delayed_engine_zero_delay_matches_oracle(problem, algorithm):
    opt = make_optimizer(OptimizerConfig(algorithm=algorithm, momentum=0.8))
    x0 = _x0(N, D)
    topo = build_topology("ring", N)
    p_ref, s_ref, _ = run_stacked(opt, topo, x0, _grad(problem), lr=1e-2, n_steps=4)
    p, s, _ = run_delayed(opt, topo, x0, _grad(problem), delay=0, lr=1e-2, n_steps=4)
    assert _tree_equal(p, p_ref)
    assert _tree_equal(s, s_ref)


# ---------------------------------------------------------------------------
# Delayed gossip semantics
# ---------------------------------------------------------------------------


def test_delay_matrix_normalization():
    Dm = delay_matrix(3, 2)
    assert Dm.shape == (3, 3) and (np.diag(Dm) == 0).all() and Dm[0, 1] == 2
    with pytest.raises(ValueError):  # the port's check raises where the reference asserts
        delay_matrix(3, -1)


@pytest.mark.parametrize("delay", [1, 2, "per-edge"])
def test_delayed_gossip_matches_manual_model(delay):
    """mixed_t == sum_d W_d @ P_{t - min(d, t)} for distinct payloads P_t."""
    n, d = 4, 3
    topo = build_topology("ring", n)
    W = topo.W(0)
    if delay == "per-edge":
        Dm = np.zeros((n, n), int)
        Dm[0, 1] = Dm[1, 0] = 3
        Dm[2, 3] = Dm[3, 2] = 1
    else:
        Dm = delay_matrix(n, delay)
    ch = DelayedStackedChannel(topo, Dm)
    st = ch.init(torch.zeros((n, d)))
    P = [np.float32(np.random.default_rng(t).standard_normal((n, d))) for t in range(6)]
    for t in range(6):
        st, mixed = ch.apply(st, torch.from_numpy(P[t]), t)
        expected = np.zeros((n, d), np.float32)
        for dd in np.unique(Dm):
            Wd = np.where(Dm == dd, W, 0.0)
            expected += (Wd @ P[t - min(int(dd), t)]).astype(np.float32)
        np.testing.assert_allclose(mixed.numpy(), expected, atol=1e-5)


def test_delayed_gossip_time_varying_topology(problem):
    opt = make_optimizer(OptimizerConfig(algorithm="dmsgd", momentum=0.8))
    topo = build_topology("one-peer-exp", N)
    p, _, _ = run_delayed(opt, topo, _x0(N, D), _grad(problem), delay=2, lr=1e-2, n_steps=6)
    assert bool(torch.isfinite(p).all())


def test_delayed_engine_reports_version_gaps(problem):
    opt = make_optimizer(OptimizerConfig(algorithm="dsgd"))
    r = _sim(opt, "ring", N, _x0(N, D), _grad(problem), lr=1e-2, n_steps=6,
             scenario="stale_gossip_k2", record_dt=2.0)
    gaps = [e["max_gap"] for e in r.trace]
    assert gaps[-1] == 2 and gaps[0] == 0
    assert all(0 <= g <= 2 for g in gaps)


# ---------------------------------------------------------------------------
# Clocks + queue (numpy: the reference's streams exactly)
# ---------------------------------------------------------------------------


def test_event_queue_fifo_on_ties():
    q = EventQueue()
    q.push(1.0, 3)
    q.push(1.0, 1, tag=7)
    q.push(0.5, 2)
    assert [q.pop() for _ in range(3)] == [(0.5, 2, 0), (1.0, 3, 0), (1.0, 1, 7)]


def test_duration_models_and_node_rngs_are_the_references():
    rng = np.random.default_rng(0)
    assert ConstantDuration(2.0)(0, 0, rng) == 2.0
    model = PeriodicStragglerDuration(base=1.0, factor=3.0, period=4)
    assert [model(0, s, rng) for s in range(8)] == [3.0, 1.0, 1.0, 1.0, 3.0, 1.0, 1.0, 1.0]
    for seed in (0, 5):
        ours, theirs = node_rngs(seed, 4), jsim.node_rngs(seed, 4)
        for a, b in zip(ours, theirs):
            got = [LognormalDuration(2.0, 0.3)(0, s, a) for s in range(50)]
            want = [jsim.LognormalDuration(2.0, 0.3)(0, s, b) for s in range(50)]
            assert got == want
    a, b = node_rngs(0, 2)
    assert a.standard_normal() != b.standard_normal()


def test_scenario_registry_is_the_references():
    assert sorted(jsim.SCENARIOS) == sorted(
        __import__("repro_torch.sim", fromlist=["SCENARIOS"]).SCENARIOS)
    for name in jsim.SCENARIOS:
        ours, theirs = get_scenario(name, 8, 100), jsim.get_scenario(name, 8, 100)
        assert (ours.name, ours.engine, ours.gossip_delay, ours.max_staleness) == (
            theirs.name, theirs.engine, theirs.gossip_delay, theirs.max_staleness)
        assert [dataclasses.asdict(e) for e in ours.events] == [
            dataclasses.asdict(e) for e in theirs.events]
        assert [dataclasses.asdict(m) for m in ours.duration_models(8)] == [
            dataclasses.asdict(m) for m in theirs.duration_models(8)]
    with pytest.raises(ValueError, match="unknown scenario"):
        get_scenario("nope", 8, 100)


# ---------------------------------------------------------------------------
# Scenarios: determinism, staleness bound, BSP quality
# ---------------------------------------------------------------------------


def test_straggler_deterministic_from_seed(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    kw = dict(lr=1e-2, n_steps=20, scenario="straggler_1slow", seed=5)
    r1 = _sim(opt, "ring", 8, _x0(), _grad(problem8), **kw)
    r2 = _sim(opt, "ring", 8, _x0(), _grad(problem8), **kw)
    assert (r1.steps == r2.steps).all() and r1.sim_time == r2.sim_time
    assert _tree_equal(r1.params, r2.params)
    r3 = _sim(opt, "ring", 8, _x0(), _grad(problem8), **{**kw, "seed": 6})
    assert r3.sim_time != r1.sim_time


def test_straggler_ssp_neighbor_gap_bounded(problem8):
    scenario = get_scenario("straggler_1slow_async", 8, 30)
    opt = make_optimizer(OptimizerConfig(algorithm="dsgd"))
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=30,
             scenario=scenario, seed=0)
    W = build_topology("ring", 8).W(0)
    for i in range(8):
        for j in np.nonzero(W[i])[0]:
            assert abs(int(r.steps[i]) - int(r.steps[j])) <= scenario.max_staleness
    assert r.stall_time.sum() > 0 and r.steps.min() >= 30


def test_straggler_bsp_preserves_quality_and_accounts_stall(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    r_h = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=40,
               scenario="homogeneous", metric_fn=metric)
    r_s = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=40,
               scenario="straggler_1slow", seed=0, metric_fn=metric)
    assert r_s.stall_time.sum() > 0 and r_s.sim_time > r_h.sim_time
    assert r_s.final_metric == pytest.approx(r_h.final_metric, rel=0.05)
    assert r_s.stall_time.sum() > 0.5 * (8 - 1) * r_s.sim_time
    assert (r_s.stall_time[1:] > 0).all() and r_s.stall_time[0] == 0.0


def _restrict_for(problem):
    def restrict(idx):
        sel = torch.as_tensor(np.asarray(idx))
        sub = dataclasses.replace(problem, A=problem.A[sel], b=problem.b[sel])
        return lambda x, _s: sub.grad(x)

    return restrict


def test_failstop_within_budget_reroutes(problem8):
    sc = Scenario(name="fs1", events=(FailStop(at_step=4, nodes=(3,)),))
    opt = make_optimizer(OptimizerConfig(algorithm="dmsgd", momentum=0.8))
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=12, scenario=sc)
    assert r.recovery_mode == "reroute" and r.n_nodes == 8 and r.dead == (3,)
    assert r.steps[3] <= 5
    assert (r.steps[[i for i in range(8) if i != 3]] >= 12).all()
    assert effective_batch_fraction(r) < 1.0


def test_failstop_quarter_rescales(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    kw = dict(lr=1e-2, n_steps=15, scenario="failstop_quarter", metric_fn=metric,
              restrict=_restrict_for(problem8))
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), **kw)
    assert r.recovery_mode == "rescale" and r.n_nodes == 6 and r.n_start == 8
    assert r.kept == (2, 3, 4, 5, 6, 7)
    assert r.params.shape[0] == 6 and (r.steps >= 15).all() and np.isfinite(r.final_metric)
    r2 = _sim(opt, "ring", 8, _x0(), _grad(problem8), **kw)
    assert _tree_equal(r.params, r2.params) and r.final_metric == r2.final_metric
    with pytest.raises(ValueError, match="restrict"):
        _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=15,
             scenario="failstop_quarter")


def test_churn_rejoin_recovers_without_double_scheduling(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=24, scenario="churn",
             seed=1)
    kinds = [e["event"] for e in r.events_log]
    for k in ("failstop", "rejoin", "slowdown"):
        assert any(e.startswith(k) for e in kinds)
    assert r.dead == () and (r.steps >= 24).all() and bool(torch.isfinite(r.params).all())
    flap = Scenario(name="flap", events=(FailStop(at_step=5, nodes=(1,)),
                                         Rejoin(at_step=5, nodes=(1,))))
    dsgd = make_optimizer(OptimizerConfig(algorithm="dsgd"))
    r = _sim(dsgd, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=20, scenario=flap)
    assert r.dead == () and int(r.steps[1]) - int(r.steps.min()) <= 2


def test_trace_recording(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="dsgd"))
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    r = _sim(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=12,
             scenario="homogeneous", record_dt=4.0, metric_fn=metric)
    ticks = [e["t"] for e in r.trace]
    assert len(ticks) == len(set(ticks)) >= 3
    for e in r.trace:
        assert {"t", "min_step", "max_step", "consensus", "metric"} <= set(e)
    assert r.trace[-1]["min_step"] == 12
    assert r.sim_time == pytest.approx(12.0) and r.stall_time.sum() == 0.0
    assert effective_batch_fraction(r) == pytest.approx(1.0)


def test_event_engine_compression_threads_channel_state(problem8):
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam-sa", momentum=0.8))
    kw = dict(lr=1e-2, n_steps=40, scenario="straggler_1slow_async", seed=0, metric_fn=metric)
    base = _sim(opt, "ring", 8, _x0(), _grad(problem8), **kw)
    again = _sim(opt, "ring", 8, _x0(), _grad(problem8), compression=None, **kw)
    assert torch.equal(base.params, again.params)
    bf16 = _sim(opt, "ring", 8, _x0(), _grad(problem8), compression="bf16", **kw)
    assert np.isfinite(bf16.final_metric)
    assert bf16.final_metric <= base.final_metric * 2.0 + 1e-3
    k2 = _sim(opt, "ring", 8, _x0(), _grad(problem8), compression="int8",
              **{**kw, "scenario": "stale_gossip_k2"})
    assert np.isfinite(k2.final_metric)


def test_event_engine_decentlam_sa_async_straggler_converges(problem8):
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    kw = dict(lr=1e-2, n_steps=80, scenario="straggler_1slow_async", seed=0, metric_fn=metric)
    sa = make_optimizer(OptimizerConfig(algorithm="decentlam-sa", momentum=0.8))
    r = _sim(sa, "ring", 8, _x0(), _grad(problem8), **kw)
    assert np.isfinite(r.final_metric) and r.final_metric < 1.0
    assert np.isfinite(r.final_consensus)
    dm = make_optimizer(OptimizerConfig(algorithm="dmsgd", momentum=0.8))
    r_dm = _sim(dm, "ring", 8, _x0(), _grad(problem8), **kw)
    assert r.final_metric <= r_dm.final_metric * 1.5


def test_is_diverged_marks_unrankable_runs():
    assert is_diverged(float("inf")) and is_diverged(float("nan")) and is_diverged(None)
    assert is_diverged(1.6e26) and is_diverged(0.001, 2e7)
    assert not is_diverged(0.001, 0.9)


# ---------------------------------------------------------------------------
# Vectorized engine == per-node engine (bit for bit, within the port)
# ---------------------------------------------------------------------------


def _full_result_equal(r1, r2) -> bool:
    return (
        _tree_equal(r1.params, r2.params)
        and _tree_equal(r1.opt_state, r2.opt_state)
        and (r1.steps == r2.steps).all()
        and (r1.stall_time == r2.stall_time).all()
        and r1.sim_time == r2.sim_time
        and r1.n_nodes == r2.n_nodes
        and r1.recovery_mode == r2.recovery_mode
        and r1.dead == r2.dead
        and r1.kept == r2.kept
        and r1.trace == r2.trace
        and r1.events_log == r2.events_log
        and r1.final_metric == r2.final_metric
        and r1.final_consensus == r2.final_consensus
    )


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_vectorized_engine_bit_exact_with_pernode(problem8, algorithm):
    """Every algorithm x every event scenario: the whole SimResult."""
    opt = make_optimizer(OptimizerConfig(algorithm=algorithm, momentum=0.8))
    metric = functools.partial(bias_to_optimum, x_star=problem8.x_star)
    for scenario in EVENT_SCENARIOS:
        kw = dict(lr=1e-2, n_steps=15, scenario=scenario, seed=3, record_dt=3.0,
                  metric_fn=metric, restrict=_restrict_for(problem8))
        r_ref = _sim(opt, "ring", 8, _x0(), _grad(problem8), engine="pernode", **kw)
        r_vec = _sim(opt, "ring", 8, _x0(), _grad(problem8), engine="vectorized", **kw)
        assert _full_result_equal(r_ref, r_vec), (algorithm, scenario)


def test_vectorized_engine_bit_exact_on_time_varying_topology(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam-sa", momentum=0.8))
    for topology, comp in [("one-peer-exp", None), ("one-peer-ring", None),
                           ("ring", "topk:0.5")]:
        kw = dict(lr=1e-2, n_steps=20, scenario="straggler_1slow_async", seed=0,
                  compression=comp)
        r_ref = _sim(opt, topology, 8, _x0(), _grad(problem8), engine="pernode", **kw)
        r_vec = _sim(opt, topology, 8, _x0(), _grad(problem8), engine="vectorized", **kw)
        assert _full_result_equal(r_ref, r_vec), (topology, comp)


def test_vectorized_engine_leaves_the_initial_parameters_alone(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
    x0 = torch.ones((8, 6))
    _sim(opt, "ring", 8, x0, _grad(problem8), lr=1e-2, n_steps=5, engine="vectorized")
    assert torch.equal(x0, torch.ones((8, 6)))


# ---------------------------------------------------------------------------
# SimSpec front door, mailboxes
# ---------------------------------------------------------------------------


def test_simspec_validation_and_call_shape(problem8):
    opt = make_optimizer(OptimizerConfig(algorithm="dsgd"))
    with pytest.raises(TypeError, match="SimSpec"):
        simulate(opt, "ring", 8, _x0(), _grad(problem8), lr=1e-2, n_steps=12)
    with pytest.raises(ValueError, match="unknown engine"):
        SimSpec(engine="warp")
    with pytest.raises(ValueError, match="n >= 1"):  # the reference asserts
        SimSpec(n=0)
    with pytest.raises(ValueError, match="unknown sparse mode"):
        SimSpec(sparse="topk")
    with pytest.raises(ValueError, match="sparse_crossover"):
        SimSpec(sparse="exact", sparse_crossover=0.0)
    spec = SimSpec(topology="ring", n=8, n_steps=5)
    with pytest.raises(TypeError, match="exactly four"):
        simulate(opt, spec, _x0(), _grad(problem8), lr=1e-2)
    with pytest.raises(TypeError, match="exactly four"):
        simulate(opt, spec, _x0())
    # row-sparse gossip runs (tests/test_torch_sparse.py holds it against
    # the reference): its volume counters come back in ``comm``
    rs = simulate(opt, SimSpec(topology="ring", n=8, n_steps=5, sparse="exact"), _x0(),
                  _grad(problem8))
    assert rs.comm is not None and rs.comm["gossip_rounds"] > 0
    r1 = simulate(opt, spec, _x0(), _grad(problem8))
    r2 = simulate(opt, spec, _x0(), _grad(problem8))
    assert _full_result_equal(r1, r2)


def test_mailbox_retained_depth_semantics():
    depth = 3
    boxes = trunner._new_mailboxes(2, depth)
    box = boxes[0]
    for v in range(5):
        box.append((v, float(v), f"x{v}", f"s{v}", f"c{v}"))
    assert [snap[0] for snap in box] == [2, 3, 4]
    assert trunner._visible(box, deadline=10.0, version_cap=10)[0] == 4
    assert trunner._visible(box, deadline=3.5, version_cap=10)[0] == 3
    assert trunner._visible(box, deadline=10.0, version_cap=3)[0] == 3
    assert trunner._visible(box, deadline=3.0, version_cap=2)[0] == 2
    assert trunner._visible(box, deadline=0.5, version_cap=10)[0] == 2
    assert boxes[1] is not box and len(boxes[1]) == 0


def test_in_neighbors_equal_the_dense_scan_and_the_references():
    for name in TOPOLOGIES + ["one-peer-ring"]:
        topo, jtopo = build_topology(name, 8), jcore.build_topology(name, 8)
        dense = trunner._in_neighbors(topo)
        assert [set(s) for s in topo.in_neighbors()] == dense
        assert dense == jrunner._in_neighbors(jtopo)


def test_delta_mailbox_codec_matches_the_references():
    """The row-delta codec (the reference's, for its row-sparse mode): the
    same encodings, byte accounts and bit-exact decodes on the same rows."""
    rng = np.random.default_rng(0)
    ours, theirs = trunner._DeltaMailbox(2, 3, 0.5), jrunner._DeltaMailbox(2, 3, 0.5)
    row = {"a": rng.standard_normal((6, 3)).astype(np.float32),
           "b": np.float32(1.5), "c": rng.standard_normal(5).astype(np.float32)}
    for k in range(6):
        row = {n: v.copy() for n, v in row.items()}
        row["a"][k % 6] += 1.0  # one row of six changed: a delta
        if k == 3:
            row["c"] += 1.0  # every row of c changed: past the crossover, a re-pin
        enc = ours.encode(k % 2, {n: torch.as_tensor(v) for n, v in row.items()})
        want = theirs.encode(k % 2, row)
        assert enc[0] == want[0]
        for n, (g, w) in zip(sorted(row), zip(tree_leaves(ours.decode(k % 2, enc)),
                                              jax.tree.leaves(theirs.decode(k % 2, want)))):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=n)
        assert (ours.dense_bytes, ours.actual_bytes) == (theirs.dense_bytes, theirs.actual_bytes)
    full = ours.encode_full(0, {n: torch.as_tensor(v) for n, v in row.items()})
    assert full[0] == theirs.encode_full(0, row)[0] == "full"
    assert (ours.dense_bytes, ours.actual_bytes) == (theirs.dense_bytes, theirs.actual_bytes)


# ---------------------------------------------------------------------------
# Across the packages: the schedule exactly, the iterates within f32
# ---------------------------------------------------------------------------


def _logging(monkeypatch, runner_mod, vec_mod, log):
    """Wrap the engines' stacked step so each call logs (step, gaps)."""
    orig = runner_mod._make_step

    def make(opt, topology, grad_fn, lr_fn, spec):
        one, channel = orig(opt, topology, grad_fn, lr_fn, spec)

        def logged(params, state, chstate, step, node_gaps):
            log.append((int(step), tuple(int(g) for g in np.asarray(node_gaps))))
            return one(params, state, chstate, step, node_gaps)

        return logged, channel

    monkeypatch.setattr(runner_mod, "_make_step", make)
    monkeypatch.setattr(vec_mod, "_make_step", make)


def _close(got, want, what, atol=0.0):
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        err = float(np.max(np.abs(g.astype(np.float64) - w))) if g.size else 0.0
        scale = max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0
        assert err < atol or err / scale < RUN_RTOL, (what, err, err / scale)


@pytest.mark.parametrize("engine", ["pernode", "vectorized"])
@pytest.mark.parametrize("scenario", EVENT_SCENARIOS + ["stale_gossip_k2"])
def test_schedule_equals_the_references_and_iterates_agree(monkeypatch, scenario, engine):
    """decentlam-sa (its damping reads the gaps) on ring, n 8, 15 steps, seed
    3: every stacked step's (step index, version gaps) in the order the
    engine runs them, the steps, stall times, sim time, events, trace
    bookkeeping and membership equal the reference's exactly; parameters,
    optimizer state, the trace's metrics and the final metric within f32
    rounding."""
    jp = jcore.make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0)
    tp = make_linear_regression(n=8, m=10, d=6, noise=0.01, seed=1, heterogeneity=1.0,
                                device="cpu")
    jlog, tlog = [], []
    _logging(monkeypatch, jrunner, jvec, jlog)
    _logging(monkeypatch, trunner, tvec, tlog)
    kw = dict(topology="ring", n=8, lr=1e-2, n_steps=15, scenario=scenario, seed=3,
              record_dt=3.0, engine=engine)

    def j_restrict(idx):
        sel = np.asarray(idx)
        sub = dataclasses.replace(jp, A=jp.A[sel], b=jp.b[sel])
        return lambda x, _s: sub.grad(x)

    jopt = jcore.make_optimizer(jcore.OptimizerConfig(algorithm="decentlam-sa", momentum=0.8))
    topt = make_optimizer(OptimizerConfig(algorithm="decentlam-sa", momentum=0.8))
    want = jsim.simulate(jopt, jsim.SimSpec(
        **kw, metric_fn=functools.partial(jcore.bias_to_optimum, x_star=jp.x_star),
        restrict=j_restrict), jnp.zeros((8, 6), jnp.float32), lambda x, _s: jp.grad(x))
    got = simulate(topt, SimSpec(
        **kw, metric_fn=functools.partial(bias_to_optimum, x_star=tp.x_star),
        restrict=_restrict_for(tp)), _x0(), _grad(tp))

    assert tlog == jlog
    assert (got.steps == want.steps).all() and (got.stall_time == want.stall_time).all()
    assert got.sim_time == want.sim_time
    assert (got.n_nodes, got.recovery_mode, got.dead, got.kept) == (
        want.n_nodes, want.recovery_mode, want.dead, want.kept)
    assert got.events_log == want.events_log
    assert [{k: v for k, v in e.items() if k not in ("metric", "consensus")}
            for e in got.trace] == [
        {k: v for k, v in e.items() if k not in ("metric", "consensus")} for e in want.trace]
    _close(got.params, want.params, "params")
    atol = STATE_ULPS * float(np.max(np.abs(np.asarray(want.params)))) / 1e-2
    _close(got.opt_state, want.opt_state, "state", atol)
    for g, w in zip(got.trace, want.trace):
        for k in ("metric", "consensus"):
            assert abs(g[k] - w[k]) <= RUN_RTOL * abs(w[k]), (k, g, w)
    assert abs(got.final_metric - want.final_metric) <= RUN_RTOL * abs(want.final_metric)
