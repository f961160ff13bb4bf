"""The port's flat parameter planes against the JAX package's.

* a port plane equals ``repro``'s ``PlaneLayout.pack`` of the same tree
  element for element (mixed f32/bf16, per node and stacked), and the
  qwen3-0.6b layout is the reference's;
* ``unpack``, ``host_pack`` and ``view_unpack`` round-trip, the views
  zero-copy; ``row_scalars`` scatters per leaf and per node;
* the plane update tail equals ``repro``'s plane tail — its reference stage
  on stacked planes with the stacked channel, and its Pallas plane kernel in
  interpret mode on one node's planes — for the 11 algorithms x {plain,
  lars-clip-wd}, at the tail tolerances of ``test_torch_core.py``;
* within the port, the plane stage equals the per-leaf stage bit for bit,
  zero pads stay zero, and the plane path issues one stage call per bucket
  and stage (the plain version's count of calls, on the CPU);
* the flat-plane train step equals the per-leaf one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import planes as jplanes
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro.kernels import fused_update as jfused
from repro.train import train_state as jts
from repro_torch.configs import get_config as tget_config
from repro_torch.core import gossip as tgossip
from repro_torch.core import optimizers as topt
from repro_torch.core import topology as ttopo
from repro_torch.core import update_spec as tspec
from repro_torch.core.planes import LANES, PlaneLayout, plane_scalars
from repro_torch.interop import from_numpy, planes_from_numpy, planes_to_numpy, to_numpy
from repro_torch.kernels import fused_update as tfused
from repro_torch.kernels.fused_update.kernel import reset_launches, stage_plain
from repro_torch.train import train_state as tts
from repro_torch.utils import tree_leaves, tree_map

N = 4
# the JAX package's own fused-vs-reference tolerance (as test_torch_core.py)
TAIL_RTOL, TAIL_ATOL = 2e-3, 2e-5
FEATURES = {
    "plain": dict(),
    "lars-clip-wd": dict(lars=True, grad_clip=1.0, weight_decay=1e-2, lars_trust=0.02),
}
SHAPES = {"w1": ((13, 7), np.float32), "w2": ((2000,), "bfloat16"),
          "emb": ((40, 33), "bfloat16"), "ln": ((9,), np.float32), "b": ((), np.float32)}


def _np_tree(seed, lead=(), f32=False):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in SHAPES.items():
        a = rng.standard_normal(lead + shape).astype(np.float32)
        out[k] = a if f32 or dt == np.float32 else a.astype(ml_dtypes.bfloat16)
    return out


def _layouts():
    tmpl = _np_tree(0)
    return jplanes.PlaneLayout.build(jax.tree.map(jnp.asarray, tmpl)), \
        PlaneLayout.build(from_numpy(tmpl))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a.view(np.uint32)


# ---------------------------------------------------------------------------
# layout mechanics against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (N,)], ids=["node", "stacked"])
def test_plane_equals_reference_pack(lead):
    jlay, tlay = _layouts()
    assert tlay.buckets == tuple(sorted(jlay.segments)) == ("bfloat16", "float32")
    assert tlay.rows == jlay.rows
    for key in jlay.segments:
        for a, b in zip(jlay.segments[key], tlay.segments[key]):
            assert (a.index, a.shape, a.row_start, a.rows, a.size) == \
                (b.index, b.shape, b.row_start, b.rows, b.size)
    tree = _np_tree(1, lead)
    want = jax.device_get(jlay.pack(jax.tree.map(jnp.asarray, tree), leading=len(lead)))
    got = planes_to_numpy(tlay.pack(from_numpy(tree), leading=len(lead)), tlay)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == lead + (tlay.rows[key], LANES)
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    back = planes_from_numpy(want, tlay)
    for key in want:
        assert torch.equal(back[key], tlay.pack(from_numpy(tree), leading=len(lead))[key])
    with pytest.raises(ValueError):
        planes_from_numpy({"float32": want["float32"]}, tlay)


def test_qwen3_full_width_layout_is_the_references():
    """qwen3-0.6b: one f32 bucket, 14 leaves, 648,000 rows — 663,548,416
    parameters plus 3,584 zeros of padding."""
    jlay = jts.model_plane_layout(jget_config("qwen3-0.6b"))
    tlay = tts.model_plane_layout(tget_config("qwen3-0.6b"))
    assert tlay.buckets == ("float32",) and tlay.rows == jlay.rows == {"float32": 648_000}
    (segs,) = tlay.segments.values()
    assert len(segs) == 14 == tlay.n_leaves
    assert [(s.shape, s.row_start, s.rows) for s in segs] == \
        [(s.shape, s.row_start, s.rows) for s in jlay.segments["float32"]]
    params = sum(s.size for s in segs)
    assert params == 663_548_416 and 648_000 * LANES - params == 3_584


def test_pack_unpack_host_pack_view_unpack_round_trips():
    _, lay = _layouts()
    tree = from_numpy(_np_tree(2))
    planes = lay.pack(tree)
    for t in (lay.unpack(planes), lay.view_unpack(planes),
              lay.view_unpack(lay.host_pack(tree))):
        for a, b in zip(tree_leaves(t), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    host = lay.host_pack(tree)
    for key in host:
        assert torch.equal(host[key], planes[key])
    # views are zero-copy: each leaf's storage lies inside its bucket
    views = lay.view_unpack(host)
    for key, segs in lay.segments.items():
        lo = host[key].data_ptr()
        hi = lo + host[key].numel() * host[key].element_size()
        for seg in segs:
            v = tree_leaves(views)[seg.index]
            assert lo <= v.data_ptr() < hi and v.untyped_storage().data_ptr() == \
                host[key].untyped_storage().data_ptr()
    host["float32"].zero_()  # the views see later writes; unpack's copies do not
    assert float(views["w1"].abs().sum()) == 0.0 and float(lay.unpack(planes)["w1"].abs()
                                                           .sum()) > 0.0
    # stacked: f32 pack of a gradient tree, views per node contiguous
    g = from_numpy(_np_tree(3, (N,), f32=True))
    gp = lay.pack(g, dtype=torch.float32, leading=1)
    gv = lay.view_unpack(gp, leading=1)
    assert all(p.dtype == torch.float32 for p in gp.values())
    for a, b in zip(tree_leaves(gv), tree_leaves(g)):
        assert torch.equal(a, b) and a[1].is_contiguous()
    with pytest.raises(ValueError):
        lay.pack({"w1": g["w1"]})
    # zero_pads writes zeros over the padding only
    dirty = {k: torch.full_like(p, float("nan")) for k, p in gp.items()}
    for a, b in zip(tree_leaves(lay.view_unpack(dirty, leading=1)), tree_leaves(g)):
        a.copy_(b)
    lay.zero_pads(dirty, leading=1)
    for key in gp:
        assert torch.equal(dirty[key], gp[key])


def test_row_scalars_scatter_per_leaf_and_per_node():
    jlay, lay = _layouts()
    names = sorted(SHAPES)
    per_leaf = {k: float(i + 2) for i, k in enumerate(names)}
    want = jax.device_get(jlay.row_scalars(per_leaf))
    got = lay.row_scalars({k: torch.tensor(v) for k, v in per_leaf.items()})
    for key in want:
        assert tuple(got[key].shape) == (lay.rows[key], 1)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    per_node = {k: torch.arange(N, dtype=torch.float32) + 10 * i for i, k in enumerate(names)}
    cols = lay.row_scalars(per_node)
    for key, segs in lay.segments.items():
        assert tuple(cols[key].shape) == (N, lay.rows[key], 1)
        for seg in segs:
            for i in range(N):
                sl = cols[key][i, seg.row_start: seg.row_start + seg.rows, 0]
                assert torch.all(sl == per_node[names[seg.index]][i])


# ---------------------------------------------------------------------------
# the plane tail against the reference's plane tail
# ---------------------------------------------------------------------------


def _port_tail(cfg, lay, x, grads, *, stacked, gossip, mean, stage):
    """Two steps of the port's run_update on planes; returns numpy planes."""
    spec = tspec.update_spec(cfg)
    lead = 1 if stacked else 0
    xp = lay.pack(from_numpy(x), leading=lead)
    st = {k: lay.pack(v, dtype=torch.float32, leading=lead)
          for k, v in topt.make_optimizer(cfg).init(from_numpy(x)).items()}
    comp = gossip.init(xp) if isinstance(gossip, tgossip.GossipChannel) else {}
    for k, g in enumerate(grads):
        xt, gt = lay.unpack(xp, leading=lead), from_numpy(g)
        sc = plane_scalars(cfg, lay, xt, gt, stacked=stacked)
        new, st, comp = tspec.run_update(
            spec, cfg, x=xp, g=lay.pack(gt, dtype=torch.float32, leading=lead), state=st,
            lr=0.05, step_idx=k, gossip=gossip, mean=mean, comp_state=comp, stage=stage,
            scalars=sc)
        xp = {key: v.to(xp[key].dtype) for key, v in new.items()}
    return to_numpy(xp), to_numpy(st)


def _jax_scalars(cfg, lay, tlay, x, g, stacked):
    """The reference's plane scalars; stacked, from the port's per-node ones
    (the reference's own would take one norm over all nodes), as jnp arrays
    shaped to broadcast: gs (n, 1, 1), r as (n, rows, 1) row columns."""
    if not stacked:
        return jplanes.plane_scalars(cfg, lay, jax.tree.map(jnp.asarray, x),
                                     jax.tree.map(jnp.asarray, g))
    s = plane_scalars(cfg, tlay, from_numpy(x), from_numpy(g), stacked=True)
    out = {}
    for k, v in s.items():
        if isinstance(v, dict):
            out[k] = {key: jnp.asarray(c.numpy()) for key, c in v.items()}
        elif isinstance(v, torch.Tensor) and v.ndim:
            out[k] = jnp.asarray(v.numpy()).reshape(-1, 1, 1)
        else:
            out[k] = jnp.float32(float(v))
    return out


def _jax_tail(cfg, lay, tlay, x, grads, *, stacked, stage):
    spec = jspec.update_spec(cfg)
    lead = 1 if stacked else 0
    if stacked:
        gossip = jgossip.StackedChannel(jtopo.build_topology("exp", N))
        mean = jgossip.make_stacked_mean(N)
    else:
        gossip, mean = (lambda t, s, c: (jax.tree.map(lambda a: 0.7 * a, t), c)), (lambda t: t)
    xj = jax.tree.map(jnp.asarray, x)
    xp = lay.pack(xj, leading=lead)
    init = jopt.make_optimizer(cfg).init(xj)
    st = {k: lay.pack(v, dtype=jnp.float32, leading=lead) for k, v in init.items()}
    comp = gossip.init(xp) if stacked else ()
    for k, g in enumerate(grads):
        xt = jax.device_get(lay.unpack(xp, leading=lead))
        sc = _jax_scalars(cfg, lay, tlay, xt, g, stacked)
        new, st, comp = jspec.run_update(
            spec, cfg, x=xp, g=lay.pack(jax.tree.map(jnp.asarray, g), dtype=jnp.float32,
                                        leading=lead),
            state=st, lr=0.05, step_idx=jnp.int32(k), gossip=gossip, mean=mean,
            comp_state=comp, stage=stage, scalars=sc)
        xp = jax.tree.map(lambda p, v: v.astype(p.dtype), xp, new)
    return jax.device_get(xp), jax.device_get(st)


def _close(got, want, what):
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   np.asarray(want[key], np.float32),
                                   rtol=TAIL_RTOL, atol=TAIL_ATOL, err_msg=f"{what}[{key}]")


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("algo", jopt.ALGORITHMS)
def test_plane_tail_matches_jax_plane_tail(algo, feat):
    """Stacked planes with the stacked channel against the reference stage
    on the reference's planes; one node's planes with an elementwise gossip
    against the reference's Pallas plane kernel (interpret mode)."""
    kw = dict(algorithm=algo, momentum=0.9, slowmo_period=2, **FEATURES[feat])
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jlay, tlay = _layouts()
    # stacked, 2 steps, with the real stacked channel
    x = _np_tree(5, (N,))
    grads = [_np_tree(6 + k, (N,), f32=True) for k in range(2)]
    want_x, want_s = _jax_tail(jcfg, jlay, tlay, x, grads, stacked=True,
                               stage=jfused.make_plane_stage("ref"))
    chan = tgossip.StackedChannel(ttopo.build_topology("exp", N))
    for stage in (tfused.make_plane_stage("torch"), tfused.make_plane_stage("triton")):
        got_x, got_s = _port_tail(tcfg, tlay, x, grads, stacked=True, gossip=chan,
                                  mean=tgossip.make_stacked_mean(N), stage=stage)
        _close(got_x, want_x, f"{algo} stacked x")
        assert set(got_s) == set(want_s)
        for sk in want_s:
            _close(got_s[sk], want_s[sk], f"{algo} stacked {sk}")
    # one node, 1 step, against the Pallas plane kernel in interpret mode
    x1, g1 = _np_tree(8), [_np_tree(9, f32=True)]
    want_x, want_s = _jax_tail(jcfg, jlay, tlay, x1, g1, stacked=False,
                               stage=jfused.make_plane_stage("pallas_interpret"))
    got_x, got_s = _port_tail(
        tcfg, tlay, x1, g1, stacked=False,
        gossip=lambda t, s, c: (tree_map(lambda a: 0.7 * a, t), c), mean=lambda t: t,
        stage=tfused.make_plane_stage("triton"))
    _close(got_x, want_x, f"{algo} node x")
    for sk in want_s:
        _close(got_s[sk], want_s[sk], f"{algo} node {sk}")


# ---------------------------------------------------------------------------
# within the port: plane == per leaf, inert pads, launch counts
# ---------------------------------------------------------------------------


def _both_paths(cfg, steps=2, seed=11):
    """The port's per-leaf and plane tails (the stage kernel's plain version
    on the CPU) on stacked trees with per-node scalars and an elementwise
    gossip, so that only the stage math differs between them."""
    _, lay = _layouts()
    spec = tspec.update_spec(cfg)
    gossip = lambda t, s, c: (tree_map(lambda a: 0.7 * a, t), c)
    mean = lambda t: tree_map(lambda a: a.mean(0, keepdim=True).expand(a.shape).contiguous(), t)
    x = from_numpy(_np_tree(seed, (N,)))
    xp = lay.pack(x, leading=1)
    st = topt.make_optimizer(cfg).init(x)
    stp = {k: lay.pack(v, dtype=torch.float32, leading=1) for k, v in st.items()}
    calls = []
    for k in range(steps):
        g = from_numpy(_np_tree(seed + 1 + k, (N,), f32=True))
        sc = tspec.node_grad_scalars(cfg, x, g)
        kw = dict(lr=0.05, step_idx=k, gossip=gossip, mean=mean, comp_state={})
        reset_launches()
        x1, st, _ = tspec.run_update(spec, cfg, x=x, g=g, state=st,
                                     stage=tfused.make_stage("triton"), scalars=sc, **kw)
        leaf_calls = stage_plain.calls
        reset_launches()
        xp1, stp, _ = tspec.run_update(
            spec, cfg, x=xp, g=lay.pack(g, dtype=torch.float32, leading=1), state=stp,
            stage=tfused.make_plane_stage("triton"),
            scalars=plane_scalars(cfg, lay, x, g, stacked=True), **kw)
        calls.append((leaf_calls, stage_plain.calls))
        x = tree_map(lambda p, v: v.to(p.dtype), x, x1)
        xp = {key: v.to(xp[key].dtype) for key, v in xp1.items()}
    return lay, x, st, xp, stp, calls


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("algo", jopt.ALGORITHMS)
def test_plane_equals_per_leaf_bitwise_and_counts_stage_calls(algo, feat):
    cfg = topt.OptimizerConfig(algorithm=algo, momentum=0.9, slowmo_period=2,
                               **FEATURES[feat])
    lay, x, st, xp, stp, calls = _both_paths(cfg)
    for a, b in zip(tree_leaves(lay.view_unpack(xp, leading=1)), tree_leaves(x)):
        assert a.dtype == b.dtype and torch.equal(a, b), algo
    for k in st:
        for a, b in zip(tree_leaves(lay.view_unpack(stp[k], leading=1)), tree_leaves(st[k])):
            assert torch.equal(a, b), (algo, k)
    # zero pads stay zero
    for planes in (xp, *stp.values()):
        for key, segs in lay.segments.items():
            mask = torch.ones(lay.rows[key] * LANES, dtype=torch.bool)
            for seg in segs:
                mask[seg.row_start * LANES: seg.row_start * LANES + seg.size] = False
            assert not planes[key].reshape(N, -1)[:, mask].any(), (algo, key)
    # O(buckets x stages) stage calls on planes, O(leaves x stages) per leaf
    stages = len(tspec.stage_plan(cfg))
    assert calls == [(len(SHAPES) * stages, len(lay.buckets) * stages)] * 2


def test_plane_stage_rejects_what_it_cannot_take():
    _, lay = _layouts()
    ctx = tspec.MathCtx(beta=0.9, clip=True)
    x = {"float32": torch.zeros(N, 64, LANES)}
    with pytest.raises(ValueError, match="rows"):
        tfused.make_plane_stage("triton")("pre", "grad_step", ctx,
                                          {"x": {"float32": torch.zeros(3, 5)},
                                           "g": {"float32": torch.zeros(3, 5)}},
                                          {"lr": 0.1}, {"float32": torch.zeros(3, 5)})
    with pytest.raises(ValueError, match="stacked"):
        tfused.make_plane_stage("triton")("pre", "grad_step", ctx,
                                          {"x": {"float32": x["float32"][0]},
                                           "g": {"float32": x["float32"][0]}},
                                          {"lr": 0.1, "gs": torch.ones(N)},
                                          {"float32": x["float32"][0]})
    # a per-node (n,) staleness damping is one float per node (SG_COL)
    sg = torch.linspace(0.25, 1.0, N)
    gen = torch.Generator().manual_seed(5)
    ops = {n: {"float32": torch.randn(N, 64, LANES, generator=gen)}
           for n in ("x", "mix", "m", "g")}
    got = tfused.make_plane_stage("triton")("post", "decentlam_sa_post",
                                            tspec.MathCtx(beta=0.9), ops,
                                            {"lr": 0.1, "sg": sg}, ops["x"])
    want = tspec.reference_stage("post", "decentlam_sa_post", tspec.MathCtx(beta=0.9), ops,
                                 {"lr": torch.tensor(0.1), "sg": sg}, ops["x"])
    for k in ("x", "m"):
        assert torch.equal(got[k]["float32"], want[k]["float32"])
    with pytest.raises(ValueError):
        tfused.make_plane_stage("pallas")


def test_flat_plane_train_step_matches_per_leaf_step():
    """The trainer on planes (parameters as views of the plane, the gradient
    written into a plane, 1 stage call per stage) == the per-leaf trainer,
    3 steps of decentlam and of pmsgd-lars with grad_clip and weight decay;
    a poisoned node keeps its momentum plane rows on the plane path too."""
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import TrainConfig, build_train_step

    cfg = tget_config("qwen3-0.6b", smoke=True)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         per_node_batch=2, n_nodes=N))
    sched = ScheduleConfig(kind="warmup_cosine", peak_lr=0.05, warmup_steps=1, total_steps=3)
    for extra in (dict(algorithm="decentlam"),
                  dict(algorithm="pmsgd-lars", grad_clip=0.5, weight_decay=1e-2)):
        out = {}
        for flat in (False, True):
            tc = TrainConfig(schedule=sched, fused_update=True, flat_planes=flat, **extra)
            step_fn, channel = build_train_step(cfg, tc, N)
            state = tts.init_train_state(
                cfg, topt.make_optimizer(tc.opt_config()), N, device=torch.device("cpu"),
                channel=channel, plane_layout=tts.model_plane_layout(cfg) if flat else None)
            losses = []
            for k in range(3):
                state, met = step_fn(state, from_numpy(data.batch(k)))
                losses.append(float(met["loss"]))
            out[flat] = (losses, state)
        (l0, s0), (l1, s1) = out[False], out[True]
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s0["params"])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        lay = tts.model_plane_layout(cfg)
        for a, b in zip(tree_leaves(lay.view_unpack(s1["opt"]["m"], leading=1)),
                        tree_leaves(s0["opt"]["m"])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        # the parameters are views of the planes the step updated
        (plane,) = s1["planes"].values()
        w = s1["params"]["lm_head"]["w"]
        assert plane.data_ptr() <= w.data_ptr() < plane.data_ptr() + plane.numel() * 4

    # the finite guard on planes: node 2's momentum rows stay as they were
    tc = TrainConfig(schedule=sched, fused_update=True, flat_planes=True)
    step_fn, channel = build_train_step(cfg, tc, N)
    state = tts.init_train_state(cfg, topt.make_optimizer(tc.opt_config()), N,
                                 device=torch.device("cpu"), channel=channel,
                                 plane_layout=tts.model_plane_layout(cfg))
    state, _ = step_fn(state, from_numpy(data.batch(0)))
    m_before = state["opt"]["m"]["float32"].clone()
    clean = step_mod._node_grads

    def poisoned(*args, **kw):
        grads, losses = clean(*args, **kw)
        grads["lm_head"]["w"][2, 0, 0] = float("nan")
        return grads, losses

    step_mod._node_grads = poisoned
    try:
        state, met = step_fn(state, from_numpy(data.batch(1)))
    finally:
        step_mod._node_grads = clean
    assert met["skipped_nonfinite"] == 1.0
    m_after = state["opt"]["m"]["float32"]
    assert torch.equal(m_after[2], m_before[2])
    assert all(not torch.equal(m_after[i], m_before[i]) for i in (0, 1, 3))
    assert torch.isfinite(state["planes"]["float32"]).all()
