"""The stacked train step with stale and compressed gossip and microbatched
gradients, against a JAX oracle, and the staleness-aware tail's claims
within the port.

The oracle is ``test_torch_train.py``'s — vmapped JAX gradients and
``run_update`` — with ``repro``'s ``DelayedStackedChannel`` and its
``reference_stage``: ``repro``'s Pallas stage takes only a scalar ``sg``
(inside its shard_map each node sees its own), and the stacked step hands
the stage one damping per node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import schedules as jsched
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.core import schedules as tsched
from repro_torch.core import update_spec as tspec
from repro_torch.core.optimizers import make_optimizer
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.kernels import fused_update as tfused
from repro_torch.kernels.fused_update.kernel import stage_plain
from repro_torch.launch import train as tlaunch
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.train_state import init_train_state, model_plane_layout
from repro_torch.utils import tree_leaves

N_NODES, SEQ, PER_NODE, STEPS = 4, 32, 2, 3
SCHEDULE = dict(kind="warmup_cosine", peak_lr=0.05, warmup_steps=1, total_steps=STEPS)
# test_torch_train.py's tolerances: per-step losses (XLA and torch sum in
# other orders), and parameters and momentum after 3 steps ((x - mix) / lr
# amplifies roundoff by 1/lr per step)
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 2e-3, 2e-5
# int8 gossip: where the two payloads differ in their last bits, an int8
# code can round the other way and move its element by one quantum of its
# row's scale (then amplified by 1/lr in the momentum); up to this share of
# a tree's elements may differ so, every other element holds the tolerance
FLIP_SHARE = 0.02

RUNS = {
    "sa-delay1": dict(algorithm="decentlam-sa", delay=1, compression=None, accum=1),
    "sa-delay1-int8-row-ef": dict(algorithm="decentlam-sa", delay=1,
                                  compression="int8-row-ef", accum=1),
    "decentlam-int8-row-ef": dict(algorithm="decentlam", delay=0, compression="int8-row-ef",
                                  accum=1),
    "decentlam-accum2": dict(algorithm="decentlam", delay=0, compression=None, accum=2),
}


def _jax_oracle(cfg, params, batches, algorithm, delay, compression, accum):
    ocfg = jopt.OptimizerConfig(algorithm=algorithm, momentum=0.9)
    spec = jspec.update_spec(ocfg)
    gossip = jgossip.DelayedStackedChannel(jtopo.build_topology("exp", N_NODES), delay,
                                           calls_per_step=spec.gossips_per_step,
                                           compression=compression, telemetry=True)
    mean = jgossip.make_stacked_mean(N_NODES)
    lr_fn = jsched.build_schedule(jsched.ScheduleConfig(**SCHEDULE))
    rt = jT.RuntimeConfig(dtype="float32", remat=False)
    vg = jax.vmap(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, cfg, jlayers.TPContext(), rt)[0]
    ))
    mb = PER_NODE // accum

    @jax.jit
    def step(x, m, chan, batch, k):
        b = {n: v.reshape(N_NODES, accum, mb, SEQ) for n, v in batch.items()}
        if accum == 1:
            loss, g = vg(x, {n: v[:, 0] for n, v in b.items()})
        else:  # the reference step's scan: g += g_j / accum from zeros, in f32
            g = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), x)
            loss = jnp.zeros((N_NODES,), jnp.float32)
            for j in range(accum):
                lj, gj = vg(x, {n: v[:, j] for n, v in b.items()})
                g = jax.tree.map(lambda a, c: a + c.astype(jnp.float32) / accum, g, gj)
                loss = loss + lj / accum
        x, st, chan = jspec.run_update(
            spec, ocfg, x=x, g=g, state={"m": m}, lr=lr_fn(k), step_idx=k,
            gossip=gossip, mean=mean, comp_state=chan, stage=jspec.reference_stage,
        )
        return x, st["m"], chan, jnp.mean(loss)

    x = jax.tree.map(jnp.asarray, params)
    m = jax.tree.map(jnp.zeros_like, x)
    chan = gossip.init(x)
    losses, gaps = [], []
    for k, batch in enumerate(batches):
        x, m, chan, loss = step(x, m, chan, jax.tree.map(jnp.asarray, batch), jnp.int32(k))
        losses.append(float(loss))
        gaps.append(jgossip.fleet_node_gaps(gossip, chan).tolist())
    return losses, gaps, jax.device_get(x), jax.device_get(m), jax.device_get(chan)


def _setup():
    jcfg, tcfg = jget_config("qwen3-0.6b", smoke=True), tget_config("qwen3-0.6b", smoke=True)
    one = jT.init_params(jax.random.key(0), jcfg)
    params = jax.device_get(jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (N_NODES,) + a.shape), one
    ))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ,
                                         per_node_batch=PER_NODE, n_nodes=N_NODES,
                                         heterogeneity=0.2))
    return jcfg, tcfg, params, [data.batch(k) for k in range(STEPS)]


def _port_run(tcfg, params, batches, **kw):
    train = TrainConfig(topology="exp", momentum=0.9, schedule=tsched.ScheduleConfig(**SCHEDULE),
                        fused_update=True, **kw)
    step_fn, channel = build_train_step(tcfg, train, N_NODES)
    x = from_numpy(params)
    state = {"step": 0, "params": x, "opt": make_optimizer(train.opt_config()).init(x),
             "channel": channel.init(x)}
    losses, gaps = [], []
    for batch in batches:
        state, metrics = step_fn(state, from_numpy(batch))
        losses.append(float(metrics["loss"]))
        gaps.append(metrics["gossip_gap"])
    return losses, gaps, state, channel


def _close_tree(got, want, what, flips=0.0):
    off = total = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        where = f"{what}{jax.tree_util.keystr(path)}"
        if not flips:
            np.testing.assert_allclose(g, w, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=where)
        off += int((~np.isclose(g, w, rtol=STATE_RTOL, atol=STATE_ATOL)).sum())
        total += np.size(w)
    assert off <= flips * total, (what, off, total)


@pytest.mark.parametrize("run", RUNS)
def test_train_step_matches_jax_oracle(run):
    """3 steps of the fused stacked step (the kernel's plain version on the
    CPU) against the oracle: losses, parameters, momentum, the channel's
    ring, residual and telemetry, and the gaps the step reports."""
    r = RUNS[run]
    jcfg, tcfg, params, batches = _setup()
    want_losses, want_gaps, want_x, want_m, want_chan = _jax_oracle(
        jcfg, params, batches, r["algorithm"], r["delay"], r["compression"], r["accum"])
    losses, gaps, state, channel = _port_run(
        tcfg, params, batches, algorithm=r["algorithm"], gossip_delay=r["delay"],
        compression=r["compression"], grad_accum=r["accum"])
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert gaps == [float(max(g)) for g in want_gaps]
    assert gaps == ([0.0, 1.0, 1.0] if r["delay"] else [0.0] * STEPS)
    flips = FLIP_SHARE if r["compression"] else 0.0
    _close_tree(to_numpy(state["params"]), want_x, "x", flips)
    _close_tree(to_numpy(state["opt"]["m"]), want_m, "m", flips)
    chan = to_numpy(state["channel"])
    assert sorted(chan) == sorted(want_chan)
    assert int(chan["t"]["rounds"]) == int(want_chan["t"]["rounds"]) == STEPS
    assert float(chan["t"]["bytes"]) == float(want_chan["t"]["bytes"])
    if "comp" in want_chan:
        _close_tree(chan["comp"], want_chan["comp"], "comp", flips)
    if "delay" in want_chan:
        assert int(chan["delay"]["s0"]["count"]) == int(want_chan["delay"]["s0"]["count"])
        _close_tree(chan["delay"]["s0"]["hist"], want_chan["delay"]["s0"]["hist"], "hist",
                    flips)


@pytest.mark.parametrize("flat", [False, True], ids=["per-leaf", "planes"])
def test_decentlam_sa_at_gap_zero_is_decentlam_bitwise(flat):
    """On an undelayed channel every gap is 0, so sg = 1 and the
    staleness-aware tail equals decentlam's bit for bit (fused path)."""
    _, tcfg, params, batches = _setup()
    out = {}
    for algo in ("decentlam", "decentlam-sa"):
        train = TrainConfig(algorithm=algo, schedule=tsched.ScheduleConfig(**SCHEDULE),
                            fused_update=True, flat_planes=flat)
        step_fn, channel = build_train_step(tcfg, train, N_NODES)
        state = init_train_state(tcfg, make_optimizer(train.opt_config()), N_NODES,
                                 device=torch.device("cpu"), channel=channel,
                                 plane_layout=model_plane_layout(tcfg) if flat else None)
        losses = []
        for batch in batches:
            state, metrics = step_fn(state, from_numpy(batch))
            losses.append(float(metrics["loss"]))
        out[algo] = (losses, state)
    (la, sa), (lb, sb) = out["decentlam"], out["decentlam-sa"]
    assert la == lb
    for a, b in zip(tree_leaves(sa["params"]) + tree_leaves(sa["opt"]),
                    tree_leaves(sb["params"]) + tree_leaves(sb["opt"])):
        assert torch.equal(a, b)


def test_stage_plain_with_per_node_sg_equals_reference_stage():
    """The kernel's plain version fed an (n,) ``sg`` column (its per-node
    mode) == ``reference_stage`` broadcasting the same (n,) damping, for
    every ctx of the tail, bit for bit, per leaf and on a plane."""
    rng = np.random.default_rng(4)
    shapes = {"w": (N_NODES, 5, 7), "b": (N_NODES, 3)}
    sg = torch.tensor([1.0, 0.5, 0.25, 0.125])
    ctxs = [tspec.MathCtx(beta=0.9), tspec.MathCtx(beta=0.9, nesterov=True),
            tspec.MathCtx(beta=0.9, wd=1e-2, coupled_wd=True, decoupled_wd=False, clip=True)]
    for ctx in ctxs:
        ops = {n: {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for k, s in shapes.items()} for n in ("x", "mix", "m", "g")}
        s = {"lr": torch.tensor(0.05), "gs": torch.tensor([0.5, 1.0, 0.7, 0.9]), "r": 1.0,
             "sg": sg}
        want = tspec.reference_stage("post", "decentlam_sa_post", ctx, ops, s, ops["x"])
        got = tfused.make_stage("triton")("post", "decentlam_sa_post", ctx, ops, s, ops["x"])
        for k in shapes:
            for name in ("x", "m"):
                assert torch.equal(got[name][k], want[name][k]), (ctx, k, name)
        svec = torch.stack([s["lr"], torch.tensor(1.0), torch.tensor(1.0), torch.tensor(1.0)])
        leaf = {n: ops[n]["w"] for n in ("x", "mix", "m", "g")}
        direct = stage_plain("post", "decentlam_sa_post", ctx, svec, leaf,
                             {"x": torch.float32, "m": torch.float32},
                             {"sg": sg, "gs": s["gs"]})
        for name in ("x", "m"):
            assert torch.equal(direct[name], want[name]["w"])
    # per node: sg = 1 is decentlam_sa_post's decentlam row; the others damp
    ones = tfused.make_stage("triton")("post", "decentlam_sa_post", ctxs[0], ops,
                                       {**s, "sg": torch.ones(N_NODES)}, ops["x"])
    assert torch.equal(ones["x"]["w"][0], got["x"]["w"][0])
    assert not torch.equal(ones["x"]["w"][1], got["x"]["w"][1])


SERVE_CLI = ["--nodes", "4", "--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--seq-len",
             "16", "--per-node-batch", "2", "--log-every", "1", "--fused-update", "--device",
             "cpu", "--algorithm", "decentlam-sa", "--gossip-delay", "1",
             "--serve-while-training", "--publish-every", "2", "--serve-requests", "3"]


@pytest.mark.parametrize("flat", [False, True], ids=["per-leaf", "planes"])
def test_publish_gap_threshold_zero_rejects_stale_offers(flat, capsys):
    """At delay 1 node 0 carries gap 0 after step 0 and gap 1 from step 1
    on: with ``--publish-gap-threshold 0`` the gate ships the first offer
    and holds the two after it (the gate's rejecting branch)."""
    extra = ["--flat-planes"] if flat else []
    res = tlaunch.main(SERVE_CLI + extra + ["--publish-gap-threshold", "0"])
    ps = res["serve"]["publisher"]
    assert ps["offers"] == 3 and ps["published"] == 1 and ps["current_version"] == 1
    out = capsys.readouterr().out
    assert "publish v1 gap=0 -> shipped" in out
    assert "publish v3 gap=1 -> held (gate)" in out and "publish v5 gap=1 -> held (gate)" in out
    assert res["gossip_gaps"] == [0.0] + [1.0] * 5
    # threshold 1 ships them all
    res1 = tlaunch.main(SERVE_CLI + extra + ["--publish-gap-threshold", "1"])
    assert res1["serve"]["publisher"]["published"] == 3
    assert res1["losses"] == res["losses"]


@pytest.mark.parametrize("flat", [False, True], ids=["per-leaf", "planes"])
def test_payload_is_written_into_the_ring_slot(flat, monkeypatch):
    """An uncompressed delay ring offers its next slot as the payload
    stage's output buffer (views into the ring; none when compressed or
    undelayed), and the steps that write there equal, bit for bit, the
    steps that copy a separate payload into the ring."""
    from repro_torch.core import gossip as tgossip
    from repro_torch.core import topology as ttopo

    topo = ttopo.build_topology("exp", N_NODES)
    ch = tgossip.DelayedStackedChannel(topo, 1)
    st = ch.init({"w": torch.zeros(N_NODES, 3, 5)})
    slot = ch.payload_slot(st)
    hist = st["delay"]["s0"]["hist"]["w"]
    assert slot["w"].shape == (N_NODES, 3, 5) and slot["w"].data_ptr() == hist[0].data_ptr()
    assert tgossip.DelayedStackedChannel(topo, 1, compression="int8").payload_slot(st) is None
    assert tgossip.StackedChannel(topo).payload_slot(st) is None

    _, tcfg, params, batches = _setup()
    out = {}
    for mode in ("into the ring", "copied"):
        if mode == "copied":
            monkeypatch.setattr(tgossip.DelayedStackedChannel, "payload_slot",
                                lambda self, state: None)
        train = TrainConfig(algorithm="decentlam-sa", gossip_delay=1, flat_planes=flat,
                            schedule=tsched.ScheduleConfig(**SCHEDULE), fused_update=True)
        step_fn, channel = build_train_step(tcfg, train, N_NODES)
        state = init_train_state(tcfg, make_optimizer(train.opt_config()), N_NODES,
                                 device=torch.device("cpu"), channel=channel,
                                 plane_layout=model_plane_layout(tcfg) if flat else None)
        for batch in batches:
            state, _ = step_fn(state, from_numpy(batch))
        out[mode] = tree_leaves(state["params"]) + tree_leaves(state["opt"]) + \
            tree_leaves(state["channel"])
    for a, b in zip(out["into the ring"], out["copied"]):
        assert torch.equal(a, b)


def test_max_skipped_steps_aborts_a_persistently_nonfinite_run(monkeypatch):
    """Every step's gradient non-finite on one node: the finite guard skips
    its update each step, and --max-skipped-steps 1 aborts on the second."""
    from repro_torch.train import step as step_mod

    clean = step_mod._node_grads

    def poisoned(*args):
        grads, losses = clean(*args)
        tree_leaves(grads)[0][1].fill_(float("nan"))
        return grads, losses

    monkeypatch.setattr(step_mod, "_node_grads", poisoned)
    argv = SERVE_CLI[:SERVE_CLI.index("--serve-while-training")]
    with pytest.raises(RuntimeError, match="max-skipped-steps=1"):
        tlaunch.main(argv + ["--max-skipped-steps", "1"])
    res = tlaunch.main(argv + ["--steps", "2"])  # without a budget the run goes on
    assert len(res["losses"]) == 2
