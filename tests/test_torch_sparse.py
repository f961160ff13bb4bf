"""Row-sparse gossip in the port (``repro_torch.sparse``) against the JAX
package, on the CPU.

Within the port, bit for bit (the claims ``tests/test_sparse_gossip.py``
makes for the reference):

* all-dirty sparse == dense, every algorithm: exact mode at delay 0 and at
  delay, delta mode at delay 0, with and without compression;
* exact mode with genuinely sparse gradients: the touched rows take the
  dense trajectory's bits, the untouched rows stay at their consensus bits
  (dense gossip mixes them to within rounding: the ring's weights are 1/3);
* the simulator's engines (per node and vectorized) agree under sparse
  gradients, and sparse == dense at all-dirty in both.

Against ``repro``, from the same numpy-seeded payloads and masks: every
round's mix (1e-6 of the payloads' scale, the mixes sum in f32 in their
own orders), the dirty masks exactly, the volume counters and the
telemetry (1e-6 relative); the tracker's sources and masks exactly on
``qwen3-0.6b --smoke`` (untied embeddings) and ``granite-moe-1b-a400m
--smoke`` (MoE expert slabs); ``collect_rows``'s expert hits exactly; the
simulator's ``comm`` summary.  The reference's tp = 2 tracker case
(``test_tracker_sharded_layout_slices_rank_block``) waits for tensor
parallelism in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sparse as jsparse
from repro.configs import get_config as jget_config
from repro.models import transformer as jT
from repro.models.layers import TPContext
from repro.train import train_state as jts
from repro_torch.configs import get_config as tget_config
from repro_torch.core import (
    ALGORITHMS,
    DelayedStackedChannel,
    OptimizerConfig,
    StackedChannel,
    build_topology,
    make_optimizer,
    make_stacked_mean,
    wire_bytes,
)
from repro_torch.core.planes import LANES
from repro_torch.interop import from_numpy
from repro_torch.models import transformer as tT
from repro_torch.sparse import (
    RowTracker,
    SparseGossipChannel,
    SparseStackedChannel,
    build_sparse_channel,
    grad_row_masks,
)
from repro_torch.train import train_state as tts
from repro_torch.utils import tree_leaves

N = 4
# mixes: f32 sums in the two packages' own orders, 1e-6 of the scale
RTOL = 1e-6
SCALE = 6.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), SCALE)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the stacked channel through opt.step: within-port bitwise claims
# ---------------------------------------------------------------------------


def _run(channel, *, algo="decentlam", n_steps=5, mask_fn=None, seed=3, momentum=0.8,
         weight_decay=0.0):
    """A stacked linear-regression trajectory through ``opt.step``, the
    sparse channel marked from the gradient support each step (all rows,
    or ``mask_fn(step) -> (d,)`` with the gradient zeroed off it)."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((N, 6, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((N, 6)).astype(np.float32))
    opt = make_optimizer(OptimizerConfig(algorithm=algo, momentum=momentum,
                                         weight_decay=weight_decay))
    if callable(channel) and not hasattr(channel, "apply"):
        channel = channel(opt)
    mean = make_stacked_mean(N)
    # replicas start in consensus (the invariant exact mode needs)
    params = torch.from_numpy(rng.standard_normal((1, 5)).astype(np.float32)).repeat(N, 1)
    opt_state, chstate = opt.init(params), channel.init(params)
    for k in range(n_steps):
        r = torch.einsum("nij,nj->ni", A, params) - b
        grads = torch.einsum("nij,ni->nj", A, r) / 6.0
        if mask_fn is not None:
            grads = torch.where(torch.from_numpy(mask_fn(k))[None], grads, 0.0)
        if isinstance(channel, SparseStackedChannel):
            chstate = channel.mark(chstate, grad_row_masks(grads))
        with torch.no_grad():
            params, opt_state, chstate = opt.step(
                params, grads, opt_state, lr=torch.tensor(1e-2), step_idx=k, gossip=channel,
                mean=mean, comp_state=chstate)
    return params, chstate


TOPO = build_topology("ring", N)


@pytest.mark.parametrize("algo", ALGORITHMS)
@pytest.mark.parametrize("mode", ["exact", "delta"])
def test_all_dirty_bitexact_with_dense(algo, mode):
    dense, _ = _run(StackedChannel(TOPO), algo=algo)
    sparse, chstate = _run(lambda opt: SparseStackedChannel(
        TOPO, mode=mode, calls_per_step=opt.gossips_per_step), algo=algo)
    assert torch.equal(dense, sparse), algo
    vol = chstate["rows"]["vol"]
    assert (vol["rounds"] > 0).all() or algo in ("pmsgd", "pmsgd-lars")


@pytest.mark.parametrize("mode,comp", [("exact", "bf16"), ("exact", "int8-row"),
                                       ("exact", "int8-row-ef"), ("delta", "bf16"),
                                       ("delta", "int8-row")])
def test_all_dirty_bitexact_with_compression(mode, comp):
    dense, dst = _run(StackedChannel(TOPO, compression=comp))
    sparse, sst = _run(SparseStackedChannel(TOPO, mode=mode, compression=comp))
    assert torch.equal(dense, sparse)
    if comp.endswith("-ef"):
        assert _equal_trees(dst["comp"], sst["comp"])


@pytest.mark.parametrize("delay", [1, 2])
@pytest.mark.parametrize("algo", ["decentlam", "da-dmsgd", "dmsgd"])
def test_delayed_all_dirty_bitexact_with_delayed_dense(delay, algo):
    dense, _ = _run(lambda opt: DelayedStackedChannel(
        TOPO, delay, calls_per_step=opt.gossips_per_step), algo=algo)
    sparse, _ = _run(lambda opt: SparseStackedChannel(
        TOPO, delay, calls_per_step=opt.gossips_per_step), algo=algo)
    assert torch.equal(dense, sparse)


def test_exact_partial_masks_trajectory_equals_dense():
    """Gradients vanish off a fixed mask (wd 0), so untouched rows stay in
    consensus; the ring's weights (1/3) mix equal rows to within rounding,
    and the sparse channel leaves them exactly where they were; the
    touched rows take the dense channel's bits."""
    mask = lambda k: np.array([True, False, True, False, False])  # noqa: E731
    dense, _ = _run(StackedChannel(TOPO), mask_fn=mask)
    sparse, chstate = _run(SparseStackedChannel(TOPO), mask_fn=mask)
    torch.testing.assert_close(sparse, dense, rtol=0, atol=1e-6)
    assert torch.equal(sparse[:, mask(0)], dense[:, mask(0)])
    # clean rows never moved: equal on every node, bit for bit
    clean = sparse[:, ~mask(0)]
    assert torch.equal(clean, clean[:1].expand_as(clean))
    np.testing.assert_array_equal(chstate["rows"]["dirty"].numpy(),
                                  np.broadcast_to(mask(0), (N, 5)))


def test_exact_mask_is_monotone_and_global():
    ch = SparseStackedChannel(TOPO)
    x = torch.zeros((N, 6))
    st = ch.init(x)
    m = torch.zeros((N, 6), dtype=torch.bool)
    m[2, 1] = True
    st = ch.mark(st, m)
    st, _ = ch.apply(st, x, 0)
    assert st["rows"]["dirty"][:, 1].all() and st["rows"]["dirty"].sum() == N
    m2 = torch.zeros((N, 6), dtype=torch.bool)
    m2[0, 4] = True
    st, _ = ch.apply(ch.mark(st, m2), x, 1)
    assert st["rows"]["dirty"][:, [1, 4]].all() and st["rows"]["dirty"].sum() == 2 * N
    assert not st["rows"]["pending"].any()


def test_delta_heals_per_phase():
    topo = build_topology("one-peer-exp", N)
    ch = SparseStackedChannel(topo, mode="delta")
    x = torch.zeros((N, 3))
    st = ch.init(x)
    m = torch.zeros((N, 3), dtype=torch.bool)
    m[1, 0] = True
    st = ch.mark(st, m)
    st, _ = ch.apply(st, x, 0)
    d = st["rows"]["dirty"]
    assert d.shape == (N, topo.period, 3)
    assert not d[1, 0, 0] and d[1, 1:, 0].all() and int(d.sum()) == topo.period - 1
    st, _ = ch.apply(st, x, 1)
    assert not st["rows"]["dirty"][1, 1, 0]


def test_delta_rejects_delay_and_stateful_compression():
    with pytest.raises(ValueError, match="delay=0"):
        SparseStackedChannel(TOPO, 1, mode="delta")
    with pytest.raises(ValueError, match="stateless compressor"):
        SparseStackedChannel(TOPO, mode="delta", compression="int8-row-ef")
    with pytest.raises(ValueError, match="top-k"):
        SparseStackedChannel(TOPO, compression="topk:0.25")
    with pytest.raises(ValueError, match="mode="):
        SparseStackedChannel(TOPO, mode="lazy")
    with pytest.raises(ValueError, match="crossover"):
        SparseStackedChannel(TOPO, crossover=0.0)


def test_crossover_forces_dense_fallback():
    mask = lambda k: np.array([True, False, False, False, False])  # noqa: E731
    dense, _ = _run(StackedChannel(TOPO), mask_fn=mask)
    sparse, chstate = _run(SparseStackedChannel(TOPO, crossover=0.1), mask_fn=mask)
    assert torch.equal(dense, sparse)
    assert chstate["rows"]["dirty"].all()
    vol = chstate["rows"]["vol"]
    torch.testing.assert_close(vol["sparse"], vol["dense"])


def test_bytes_match_analytic_row_model():
    """R rows of 8 floats, k dirty: sends x min(k * (32 + 4), 32 R) per
    round, the dense equivalent sends x 32 R; ``bytes_per_step`` reports
    their per-round means."""
    ch = SparseStackedChannel(TOPO)
    x = torch.ones((N, 10, 8))
    st = ch.init(x)
    m = torch.zeros(10, dtype=torch.bool)
    m[[1, 7]] = True
    st, _ = ch.apply(ch.mark(st, m), x, 0)
    sends = len(TOPO.edge_classes(0))
    assert float(st["rows"]["vol"]["sparse"][0]) == sends * 2 * (wire_bytes(32.0, None) + 4)
    assert float(st["rows"]["vol"]["dense"][0]) == sends * 320.0
    bps = ch.bytes_per_step(4.0 * N * 80, st)
    assert bps["egress_bytes"] == sends * 72.0 and bps["dense_egress_bytes"] == sends * 320.0


def test_shipped_row_cost_capped_at_dense():
    ch = SparseStackedChannel(TOPO, crossover=1.0)
    x = torch.ones((N, 4, 1))
    st = ch.init(x)
    st, _ = ch.apply(ch.mark(st, torch.tensor([True, True, True, False])), x, 0)
    # 3 rows x (4 + 4) = 24 > the leaf's 16 dense bytes: capped
    assert float(st["rows"]["vol"]["sparse"][0]) == len(TOPO.edge_classes(0)) * 16.0


def test_grad_row_masks_shapes_and_support():
    g = {"a": torch.zeros((N, 3, 2, 2)), "b": torch.zeros(N), "c": torch.zeros((N, 5))}
    g["a"][1, 2, 1, 0] = 1.0
    g["b"][3] = -2.0
    g["c"][0, 4] = 0.5
    m = grad_row_masks(g)
    assert m["a"].shape == (N, 3) and m["b"].shape == (N, 1) and m["c"].shape == (N, 5)
    assert m["a"].sum() == 1 and m["a"][1, 2]
    assert m["b"][:, 0].tolist() == [False, False, False, True]
    assert m["c"].sum() == 1 and m["c"][0, 4]


def test_mark_broadcasts_and_accepts_counts():
    ch = SparseStackedChannel(TOPO)
    st = ch.init(torch.zeros((N, 4)))
    st = ch.mark(st, torch.tensor([0.0, 2.0, 0.0, 0.0]))
    assert st["rows"]["pending"][:, 1].all() and st["rows"]["pending"].sum() == N
    per = torch.zeros((N, 4), dtype=torch.bool)
    per[2, 3] = True
    st = ch.mark(st, per)
    assert st["rows"]["pending"][2, 3] and st["rows"]["pending"].sum() == N + 1


def test_build_sparse_channel_dispatch():
    assert isinstance(build_sparse_channel("stacked", TOPO), SparseStackedChannel)
    assert SparseGossipChannel is SparseStackedChannel
    assert build_sparse_channel("stacked", TOPO, delay=2)._depth == 2
    with pytest.raises(ValueError, match="node group"):
        build_sparse_channel("ppermute", TOPO)
    with pytest.raises(ValueError, match="unknown sparse"):
        build_sparse_channel("allgather", TOPO, group=object())


# ---------------------------------------------------------------------------
# the stacked channel against repro's, round by round
# ---------------------------------------------------------------------------

# (mode, delay, compression, topology, calls per step)
STACKED_CASES = {
    "exact-ring": ("exact", 0, None, "ring", 1),
    "exact-exp-int8-row-ef": ("exact", 0, "int8-row-ef", "exp", 1),
    "exact-one-peer-bf16": ("exact", 0, "bf16", "one-peer-exp", 1),
    "exact-d1-exp": ("exact", 1, None, "exp", 1),
    "exact-d2-exp-calls2": ("exact", 2, None, "exp", 2),
    "delta-one-peer": ("delta", 0, None, "one-peer-exp", 1),
    "delta-exp-calls2": ("delta", 0, None, "exp", 2),
    "delta-ring-int8-row": ("delta", 0, "int8-row", "ring", 1),
    "exact-crossover": ("exact", 0, None, "ring", 1),
}
LEAVES = {"p": (12, 8), "v": (9,)}


def _payload(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in LEAVES.items()}


def _masks(seed):
    """Per-sender row masks, about a fifth of the rows each round."""
    rng = np.random.default_rng(100 + seed)
    return {k: rng.random((N, s[0])) < 0.2 for k, s in LEAVES.items()}


@pytest.mark.parametrize("key", sorted(STACKED_CASES))
def test_stacked_channel_matches_repro_round_by_round(key):
    mode, delay, comp, topo_name, calls = STACKED_CASES[key]
    cross = 0.3 if key == "exact-crossover" else 0.9
    jch = jsparse.SparseStackedChannel(jcore.build_topology(topo_name, N), delay, mode=mode,
                                       crossover=cross, calls_per_step=calls,
                                       compression=comp, telemetry=True)
    tch = SparseStackedChannel(build_topology(topo_name, N), delay, mode=mode,
                               crossover=cross, calls_per_step=calls, compression=comp,
                               telemetry=True)
    x0 = _payload(0)
    jst = jch.init({k: jnp.asarray(v) for k, v in x0.items()})
    tst = tch.init({k: torch.from_numpy(v) for k, v in x0.items()})
    r = 0
    for step in range(4):
        for _ in range(calls):
            x, m = _payload(1 + r), _masks(r)
            jst = jch.mark(jst, {k: jnp.asarray(v) for k, v in m.items()})
            tst = tch.mark(tst, {k: torch.from_numpy(v) for k, v in m.items()})
            jst, jmix = jch.apply(jst, {k: jnp.asarray(v) for k, v in x.items()},
                                  jnp.int32(step))
            tst, tmix = tch.apply(tst, {k: torch.from_numpy(v) for k, v in x.items()}, step)
            for k in LEAVES:
                _close(tmix[k], jmix[k], f"{key} round {r} {k}")
            for k in LEAVES:
                np.testing.assert_array_equal(tst["rows"]["dirty"][k].numpy(),
                                              np.asarray(jst["rows"]["dirty"][k]))
            r += 1
    for part in ("sparse", "dense", "rounds"):
        np.testing.assert_allclose(tst["rows"]["vol"][part].numpy(),
                                   np.asarray(jst["rows"]["vol"][part]), rtol=1e-6)
    np.testing.assert_allclose(float(tst["t"]["bytes"]), float(jst["t"]["bytes"]), rtol=1e-6)
    if comp == "int8-row-ef":
        for k in LEAVES:
            _close(tst["comp"][k], jst["comp"][k], f"{key} residual {k}")
    assert tch.bytes_per_step(1.0, tst) == pytest.approx(jch.bytes_per_step(1.0, jst),
                                                         rel=1e-6)


# ---------------------------------------------------------------------------
# the tracker against repro's
# ---------------------------------------------------------------------------


def _layouts(arch):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    jlay, tlay = jts.model_plane_layout(jcfg), tts.model_plane_layout(tcfg)
    jtr = jsparse.RowTracker.for_model(jlay, jlay.local_template(),
                                       tied_embeddings=jcfg.tie_embeddings)
    ttr = RowTracker.for_model(tlay, tied_embeddings=tcfg.tie_embeddings)
    return jcfg, jtr, ttr


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_tracker_sources_and_masks_match_repro(arch):
    """The sources (names, buckets, row spans, unit sizes and intervals) and
    the masks of seeded token ids and router hits, exactly; a missing source
    is fully dirty in both."""
    cfg, jtr, ttr = _layouts(arch)
    assert not cfg.tie_embeddings
    assert len(jtr.sources) == len(ttr.sources) and ttr.source_names == jtr.source_names
    for js, ts in zip(jtr.sources, ttr.sources):
        for f in ("name", "kind", "bucket", "row_start", "rows", "units", "unit_size",
                  "unit_grid"):
            assert getattr(ts, f) == getattr(js, f), (arch, f)
        np.testing.assert_array_equal(ts.starts, js.starts)
        np.testing.assert_array_equal(ts.ends1, js.ends1)
    assert ttr.summary() == jtr.summary()
    rng = np.random.default_rng(7)
    for trial in range(3):
        units = {"embed": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
        for src in ttr.sources:
            if src.kind == "moe":
                units[src.name] = (rng.random(src.unit_grid) < 0.3).astype(np.float32)
        if trial == 2:
            units = {"embed": units["embed"]}  # the MoE sources go fully dirty
        want = jtr.step_masks({k: jnp.asarray(v) for k, v in units.items()})
        got = ttr.step_masks({k: torch.from_numpy(v) for k, v in units.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, v in ttr.all_dirty().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jtr.all_dirty()[k]))


def test_tracker_token_rows_pads_and_refusals():
    """A token id hits exactly its embedding row (d_model = LANES at the
    published width: one unit, one row); pad rows stay clean; a wrong hit
    size is refused, and a shard rank on an unsharded layout changes
    nothing (no source's unit grid is split)."""
    cfg, _, ttr = _layouts("granite-moe-1b-a400m")
    emb = next(s for s in ttr.sources if s.name == "embed")
    masks = ttr.step_masks({"embed": torch.tensor([3, 40, 10 ** 9])})
    got = masks[emb.bucket][emb.row_start: emb.row_start + emb.rows].numpy()
    want = np.zeros(emb.rows, bool)
    for tok in (3, 40):
        a, b = tok * emb.unit_size, (tok + 1) * emb.unit_size
        want[a // LANES: (b - 1) // LANES + 1] = True
    np.testing.assert_array_equal(got, want)
    lay = ttr.layout
    for key, segs in lay.segments.items():
        end = segs[-1].row_start + segs[-1].rows
        assert not masks[key][end:].any()
    moe = next(s for s in ttr.sources if s.kind == "moe")
    with pytest.raises(ValueError, match="expected"):
        ttr.step_masks({moe.name: torch.zeros(3)})
    plain, ranked = ttr.step_masks({}), ttr.step_masks({}, shard_rank=0)
    assert all(torch.equal(plain[k], ranked[k]) for k in plain)


def test_collect_rows_expert_hits_match_repro():
    """``forward_loss(collect_rows=True)``'s ``_row_info``: every MoE group's
    ``(Lg, E)`` expert hits equal the reference's; the other metrics are
    unchanged by it."""
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    params = jax.device_get(jT.init_params(jax.random.key(1), jcfg))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :16], "targets": toks[:, 1:]}
    _, wm = jT.forward_loss(params, jax.tree.map(jnp.asarray, batch), jcfg,
                            TPContext(size=1), jT.RuntimeConfig(dtype="float32", remat=False),
                            collect_rows=True)
    tparams = from_numpy(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, tm = tT.forward_loss(tparams, tb, tcfg, collect_rows=True)
        _, plain = tT.forward_loss(tparams, tb, tcfg)
    want = wm["_row_info"]
    got = tm.pop("_row_info")
    assert sorted(got) == sorted(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy() != 0, np.asarray(want[k]) != 0, err_msg=k)
    assert sorted(tm) == sorted(plain) and all(torch.equal(tm[k], plain[k]) for k in tm)


def test_stacked_step_refuses_sparse_gossip():
    from repro_torch.train.step import TrainConfig, build_train_step

    cfg = tget_config("qwen3-0.6b", smoke=True)
    with pytest.raises(ValueError, match="distributed step"):
        build_train_step(cfg, TrainConfig(sparse_gossip=True, flat_planes=True), N)


# ---------------------------------------------------------------------------
# the simulator's sparse mode
# ---------------------------------------------------------------------------

_G = None


def _grads():
    global _G
    if _G is None:
        rng = np.random.default_rng(0)
        A = (rng.standard_normal((8, 12, 12)) * 0.1 + np.eye(12)).astype(np.float32)
        b = rng.standard_normal((8, 12)).astype(np.float32)
        _G = (A, b)
    return _G


def _gfns(pkg):
    A, b = _grads()
    if pkg == "torch":
        At, bt = torch.from_numpy(A), torch.from_numpy(b)

        def dense(params, step):
            return torch.einsum("nij,nj->ni", At, params) - bt

        def sparse(params, step):
            rows = (torch.arange(12)[None, :] + step) % 3 == 0
            return torch.where(rows, dense(params, step), 0.0)
    else:
        Aj, bj = jnp.asarray(A), jnp.asarray(b)

        def dense(params, step):
            return jnp.einsum("nij,nj->ni", Aj, params) - bj

        def sparse(params, step):
            rows = (jnp.arange(12)[None, :] + jnp.asarray(step)) % 3 == 0
            return jnp.where(rows, dense(params, step), 0.0)
    return dense, sparse


def _sim(pkg, engine, sparse, which, **kw):
    dense_g, sparse_g = _gfns(pkg)
    g = dense_g if which == "dense" else sparse_g
    if pkg == "torch":
        from repro_torch.sim import SimSpec, simulate

        opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=0.8))
        x0 = torch.zeros((8, 12))
    else:
        from repro.sim import SimSpec, simulate

        opt = jcore.make_optimizer(jcore.OptimizerConfig(algorithm="decentlam", momentum=0.8))
        x0 = jnp.zeros((8, 12), jnp.float32)
    spec = SimSpec(topology="ring", n=8, lr=1e-2, n_steps=12, seed=0, engine=engine,
                   sparse=sparse, **kw)
    return simulate(opt, spec, x0, g)


def test_sim_all_dirty_sparse_equals_dense_both_engines():
    for engine in ("pernode", "vectorized"):
        rd = _sim("torch", engine, None, "dense")
        rs = _sim("torch", engine, "exact", "dense")
        assert torch.equal(rd.params, rs.params), engine
        assert rs.comm is not None and rd.comm is None


@pytest.mark.parametrize("mode", ["exact", "delta"])
def test_sim_engines_bit_equal_under_sparse_grads_and_match_repro(mode):
    rp = _sim("torch", "pernode", mode, "sparse")
    rv = _sim("torch", "vectorized", mode, "sparse")
    assert torch.equal(rp.params, rv.params), mode
    assert rp.comm["wire_sparse_bytes"] < rp.comm["wire_dense_bytes"]
    assert rp.comm["mailbox_bytes"] < rp.comm["mailbox_dense_bytes"]
    assert "mailbox_bytes" not in rv.comm
    jp = _sim("jax", "pernode", mode, "sparse")
    _close(rp.params, jp.params, mode, rtol=1e-5)
    assert sorted(rp.comm) == sorted(jp.comm)
    for k in jp.comm:
        assert rp.comm[k] == pytest.approx(jp.comm[k], rel=1e-6), k


def test_sim_delayed_engine_composes_with_sparse():
    r = _sim("torch", "pernode", "exact", "dense", scenario="stale_gossip_k2")
    j = _sim("jax", "pernode", "exact", "dense", scenario="stale_gossip_k2")
    assert r.comm["gossip_rounds"] > 0 and r.comm == pytest.approx(j.comm, rel=1e-6)
    _close(r.params, j.params, "delayed", rtol=1e-5)
