"""The port's cost model and roofline (``repro_torch.launch.costmodel``,
``roofline``) against the JAX package's, on the CPU.

* ``tests/test_costmodel.py``'s cases as torch programs on the same shapes —
  chained products (its scan unrolled in Python), nested loops of products,
  a gradient against its forward, collective bytes by group size, and a
  convolution — held
  against ``repro.launch.costmodel.analyze_lowered`` on the JAX versions
  within each case's tolerance (its remat case has no counterpart: the port
  has no remat);
* a tiny_lm train step (d_model 256, so that products dominate) against the
  reference's single-process step, built as ``tests/test_torch_train.py``
  builds it, within TRAIN_RTOL;
* launch counts: ``count_launches`` of the port's per-leaf and plane update
  tails == ``count_primitive(..., "pallas_call")`` of the reference's
  (``tests/test_planes.py``'s templates) for every algorithm, 28 per leaf
  step and 2 per plane step on qwen3-0.6b's layout;
* the ring rules: the recorded collective bytes of a 4-rank gloo step ==
  ``gossip_bytes_per_step`` (decentlam) or the psum mean's all-reduces
  (pmsgd), plus the step's metric reductions;
* the roofline arithmetic with an explicit ``HW`` == the reference's exactly,
  ``collective_egress`` == the reference's HLO parser on the same ops, and
  ``HW``'s defaults are the H100's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.roofline as jroof
from repro.configs import tiny_lm as jtiny_lm
from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import planes as jplanes
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro.kernels import fused_update as jfused
from repro.launch.costmodel import analyze_lowered, count_primitive
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch.configs import get_config
from repro_torch.configs import tiny_lm as ttiny_lm
from repro_torch.core import optimizers as topt
from repro_torch.core import update_spec as tspec
from repro_torch.core.gossip import _Wire
from repro_torch.core.planes import PlaneLayout, plane_scalars
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.interop import from_numpy
from repro_torch.kernels import fused_update as tfused
from repro_torch.launch import roofline as troof
from repro_torch.launch.costmodel import analyze, count_launches
from repro_torch.launch.mesh import NodeGroup, run_ranks
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.train_state import model_plane_layout

# the tiny_lm step's FLOPs against the reference's: the products agree; the
# elementwise rest (one per output element of every op) differs by what
# each framework materializes (views, casts, XLA's broadcasts)
TRAIN_RTOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_costmodel.py's cases
# ---------------------------------------------------------------------------


def test_chained_products_match_the_reference_scan():
    d, L = 128, 10

    def rolled(x, w):
        out, _ = jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)
        return out

    def chain(x, w):
        for i in range(L):
            x = x @ w[i]
        return x

    want = analyze_lowered(rolled, (jnp.zeros((d, d)), jnp.zeros((L, d, d))), {}).flops
    got = analyze(chain, (torch.zeros(d, d), torch.zeros(L, d, d)))
    assert abs(got.flops - want) / want < 0.02, (got.flops, want)
    assert got.product_flops == L * 2 * d**3
    assert got.naive_bytes_untripped == got.naive_bytes


def test_nested_loops_count_every_trip():
    def jf(x):
        def outer(c, _):
            ci, _ = jax.lax.scan(lambda ci, _: (ci @ ci, None), c, None, length=3)
            return ci, None

        out, _ = jax.lax.scan(outer, x, None, length=5)
        return out

    def tf(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    want = analyze_lowered(jf, (jnp.zeros((64, 64)),), {}).flops
    got = analyze(tf, (torch.zeros(64, 64),)).flops
    expect = 15 * 2 * 64**3
    assert abs(got - expect) / expect < 0.05
    assert abs(got - want) / want < 0.05


def test_gradient_counts_the_backward():
    def jloss(w, x):
        return jnp.sum((x @ w) ** 2)

    def tloss(w, x):
        return torch.sum((x @ w) ** 2)

    def tgrad(w, x):
        return torch.autograd.grad(tloss(w, x), w)

    w, x = torch.zeros(64, 64, requires_grad=True), torch.zeros(8, 64)
    fwd, both = analyze(tloss, (w, x)).flops, analyze(tgrad, (w, x)).flops
    jw, jx = jnp.zeros((64, 64)), jnp.zeros((8, 64))
    jfwd = analyze_lowered(jloss, (jw, jx), {}).flops
    jboth = analyze_lowered(jax.grad(jloss), (jw, jx), {}).flops
    assert both > 1.8 * fwd  # fwd product + dw backward product
    assert abs(fwd - jfwd) / jfwd < 0.05
    assert abs(both - jboth) / jboth < 0.05


def test_convolution_follows_the_references_rule():
    """2 * output elements * kernel elements per output channel, NHWC/HWIO
    in the reference, NCHW/OIHW here."""
    x, w = jnp.zeros((2, 8, 8, 16)), jnp.zeros((3, 3, 16, 32))
    want = analyze_lowered(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")), (x, w), {}).flops
    got = analyze(lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                  (torch.zeros(2, 16, 8, 8), torch.zeros(32, 16, 3, 3)))
    assert got.product_flops == 2 * (2 * 32 * 8 * 8) * (16 * 3 * 3)
    assert abs(got.flops - want) / want < 0.02


def _dry(world: int) -> NodeGroup:
    return NodeGroup(rank=0, world=world, backend="dry", device=torch.device("meta"))


def test_collective_bytes_by_group_size():
    """An all-reduce and a permute of 4 KiB over 8 ranks: the reference
    prices its psum + ppermute inside shard_map with axis size 8; the port
    records them at the wire of a dry 8-rank group — and prices a 1-rank
    group as 8 ranks through ``group_sizes``."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map

    def jf(x):
        y = jax.lax.psum(x, "data")
        return jax.lax.ppermute(y, "data", [(i, (i + 1) % 8) for i in range(8)])

    sm = shard_map(jf, mesh=jax.make_mesh((1,), ("data",)), in_specs=P(), out_specs=P(),
                   check_vma=False)
    want = analyze_lowered(sm, (jnp.zeros((1024,), jnp.float32),), {"data": 8})

    def tf(group):
        wire = _Wire(group)
        x = torch.empty(1024, device="meta")
        wire.all_reduce_(x)
        wire.stream(x, x.numel(), torch.float32, x.device, 1, 7, lambda *a: None)

    got = analyze(tf, (_dry(8),))
    expect = 2 * (7 / 8) * 4096 + 4096
    assert got.collective_bytes == pytest.approx(expect, rel=1e-12)
    assert got.collective_bytes == pytest.approx(want.collective_bytes, rel=1e-6)
    assert got.collective_counts == {"all-reduce": 1, "collective-permute": 1}
    assert want.collective_counts == got.collective_counts
    assert analyze(tf, (_dry(1),), {"node": 8}).collective_bytes == pytest.approx(expect)
    assert analyze(tf, (_dry(1),)).collective_bytes == 0.0  # a group of one moves nothing


def test_collectives_in_a_loop_are_counted_each_time():
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map

    def jf(x):
        out, _ = jax.lax.scan(lambda c, _: (jax.lax.psum(c, "data"), None), x, None, length=6)
        return out

    sm = shard_map(jf, mesh=jax.make_mesh((1,), ("data",)), in_specs=P(), out_specs=P(),
                   check_vma=False)
    want = analyze_lowered(sm, (jnp.zeros((256,), jnp.float32),), {"data": 4})

    def tf(group):
        wire, x = _Wire(group), torch.empty(256, device="meta")
        for _ in range(6):
            wire.all_reduce_(x)

    got = analyze(tf, (_dry(4),))
    assert got.collective_bytes == pytest.approx(6 * 2 * (3 / 4) * 256 * 4, rel=1e-12)
    assert got.collective_bytes == pytest.approx(want.collective_bytes, rel=1e-6)


def test_a_dry_group_refuses_real_tensors():
    with pytest.raises(ValueError, match="meta tensors only"):
        _Wire(_dry(4)).all_reduce_(torch.zeros(8))


# ---------------------------------------------------------------------------
# a tiny_lm train step against the reference's
# ---------------------------------------------------------------------------


def test_tiny_lm_train_step_flops_match_the_reference():
    n, pb, s = 2, 2, 64
    jcfg, tcfg = jtiny_lm(), ttiny_lm()
    assert jcfg.d_model >= 256
    ocfg = jopt.OptimizerConfig(algorithm="decentlam", momentum=0.9)
    spec, stage = jspec.update_spec(ocfg), jfused.make_stage("pallas_interpret")
    gossip = jgossip.StackedChannel(jtopo.build_topology("exp", n))
    mean = jgossip.make_stacked_mean(n)
    rt = jT.RuntimeConfig(dtype="float32", remat=False)
    vg = jax.vmap(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, jcfg, jlayers.TPContext(), rt)[0]))

    def jstep(x, m, chan, batch):
        b = {k: v.reshape(n, pb, s) for k, v in batch.items()}
        loss, g = vg(x, b)
        x, st, chan = jspec.run_update(spec, ocfg, x=x, g=g, state={"m": m}, lr=0.01,
                                       step_idx=jnp.int32(0), gossip=gossip, mean=mean,
                                       comp_state=chan, stage=stage)
        return x, st["m"], chan, jnp.mean(loss)

    one = jT.init_params(jax.random.key(0), jcfg)
    x = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), one)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab_size, (n * pb, s)).astype(np.int32)
             for k in ("tokens", "targets")}
    jargs = (x, jax.tree.map(jnp.zeros_like, x), gossip.init(x),
             jax.tree.map(jnp.asarray, batch))
    want = analyze_lowered(jstep, jargs, {})
    want_launches = count_primitive(jax.make_jaxpr(jstep)(*jargs), "pallas_call")

    train = TrainConfig(algorithm="decentlam", topology="exp", momentum=0.9,
                        schedule=ScheduleConfig(kind="constant", peak_lr=0.01),
                        fused_update=True)
    step, channel = build_train_step(tcfg, train, n)
    tx = from_numpy(jax.device_get(x))
    state = {"step": 0, "params": tx, "opt": topt.make_optimizer(train.opt_config()).init(tx),
             "channel": channel.init(tx)}
    got = analyze(step, (state, {k: torch.from_numpy(v.astype(np.int64))
                                 for k, v in batch.items()}))
    assert abs(got.flops - want.flops) / want.flops < TRAIN_RTOL, (got.flops, want.flops)
    assert got.product_flops / got.flops > 0.9  # products dominate at d_model 256
    assert got.kernel_launches == {"fused_update": want_launches}


# ---------------------------------------------------------------------------
# launch counts: one unit per hand-written kernel launch
# ---------------------------------------------------------------------------

_SHAPES = {"w1": ((13, 7), np.float32), "w2": ((2000,), "bfloat16"),
           "emb": ((40, 33), "bfloat16"), "ln": ((9,), np.float32), "b": ((), np.float32)}


def _np_tmpl():
    import ml_dtypes

    rng = np.random.default_rng(11)
    return {k: rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16 if dt == "bfloat16" else np.float32)
        for k, (shape, dt) in _SHAPES.items()}


@pytest.mark.parametrize("algo", jopt.ALGORITHMS)
def test_launch_counts_match_the_references_pallas_calls(algo):
    """``tests/test_planes.py::test_plane_launch_count_is_O_stages``'s
    programs: per leaf and on planes, the reference's pallas_calls against
    the port's units (the plain version on the CPU counts as the kernel)."""
    tmpl = _np_tmpl()
    jtmpl = jax.tree.map(jnp.asarray, tmpl)
    jlay = jplanes.PlaneLayout.build(jtmpl)
    jcfg = jopt.OptimizerConfig(algorithm=algo, momentum=0.9, weight_decay=0.01)
    jsp = jspec.update_spec(jcfg)
    jg = jax.tree.map(lambda a: jnp.ones(a.shape, jnp.float32), jtmpl)
    jst = jopt.make_optimizer(jcfg).init(jtmpl)
    jkw = dict(lr=0.01, step_idx=jnp.int32(0), gossip=lambda t, s, c: (t, c),
               mean=lambda t: t, comp_state=())

    def jleaf(x, g, state):
        return jspec.run_update(jsp, jcfg, x=x, g=g, state=state,
                                stage=jfused.make_stage("pallas_interpret"), **jkw)

    def jplane(x, g, state):
        return jspec.run_update(
            jsp, jcfg, x=jlay.pack(x), g=jlay.pack(g, dtype=jnp.float32),
            state={k: jlay.pack(v, dtype=jnp.float32) for k, v in state.items()},
            stage=jfused.make_plane_stage("pallas_interpret"),
            scalars=jplanes.plane_scalars(jcfg, jlay, x, g), **jkw)

    want_leaf = count_primitive(jax.make_jaxpr(jleaf)(jtmpl, jg, jst), "pallas_call")
    want_plane = count_primitive(jax.make_jaxpr(jplane)(jtmpl, jg, jst), "pallas_call")

    x = from_numpy(tmpl)
    lay = PlaneLayout.build(x)
    cfg = topt.OptimizerConfig(algorithm=algo, momentum=0.9, weight_decay=0.01)
    sp = tspec.update_spec(cfg)
    g = {k: torch.ones(v.shape, dtype=torch.float32) for k, v in x.items()}
    st = topt.make_optimizer(cfg).init(x)
    kw = dict(lr=0.01, step_idx=0, gossip=lambda t, s, c: (t, c), mean=lambda t: t,
              comp_state={})

    def leaf(x, g, state):
        return tspec.run_update(sp, cfg, x=x, g=g, state=state,
                                stage=tfused.make_stage("triton"), **kw)

    def plane(x, g, state):
        return tspec.run_update(
            sp, cfg, x=lay.pack(x), g=lay.pack(g, dtype=torch.float32),
            state={k: lay.pack(v, dtype=torch.float32) for k, v in state.items()},
            stage=tfused.make_plane_stage("triton"),
            scalars=plane_scalars(cfg, lay, x, g), **kw)

    assert count_launches(leaf, (x, g, st), "fused_update") == want_leaf
    assert count_launches(plane, (x, g, st), "fused_update") == want_plane
    # the plain stage (impl="torch") launches nothing
    assert count_launches(lambda: tspec.run_update(
        sp, cfg, x=x, g=g, state=st, stage=tfused.make_stage("torch"), **kw), (),
        "fused_update") == 0


@pytest.mark.parametrize("planes", [False, True], ids=["per-leaf", "planes"])
def test_qwen3_layout_step_counts_28_per_leaf_and_2_on_planes(planes):
    """qwen3-0.6b's smoke config has its 14 leaves (one plane bucket): a
    decentlam step is 28 stage launches per leaf, 2 on planes — the card's
    counts (chip_smoke.py phases 3 and 15), here from the plain version."""
    from repro_torch.train.train_state import init_train_state

    cfg = get_config("qwen3-0.6b", smoke=True)
    train = TrainConfig(fused_update=True, flat_planes=planes)
    step, channel = build_train_step(cfg, train, 2)
    state = init_train_state(cfg, topt.make_optimizer(train.opt_config()), 2,
                             device=torch.device("cpu"), channel=channel,
                             plane_layout=model_plane_layout(cfg) if planes else None)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16)) for k in ("tokens", "targets")}
    assert count_launches(step, (state, batch), "fused_update") == (2 if planes else 28)


# ---------------------------------------------------------------------------
# the ring rules on a 4-rank gloo step
# ---------------------------------------------------------------------------


def test_dist_step_collective_bytes_follow_the_ring_rules():
    import torch_dist_workers as W

    from repro_torch.core.gossip import gossip_bytes_per_step
    from repro_torch.core.topology import build_topology

    world = 4
    out = run_ranks(W.cost_ranks, world, device="cpu", timeout_s=120)
    ring = lambda nbytes: troof.collective_egress("all-reduce", nbytes, world)  # noqa: E731
    for rank in out:
        for algo, rec in rank.items():
            # the step's metric reductions: the per-node sums and skip count,
            # and the gap's max
            metrics = ring(4 * rec["n_sums"]) + ring(4)
            if algo == "decentlam":
                gossip = gossip_bytes_per_step(build_topology("exp", world),
                                               rec["payload_bytes"])["egress_bytes"]
                assert rec["counts"]["all-reduce"] == 2
            else:  # pmsgd: the psum mean, one all-reduce of each f32 leaf
                gossip = sum(ring(nb) for nb in rec["leaf_bytes"])
                assert rec["counts"]["all-reduce"] == 2 + len(rec["leaf_bytes"])
                assert "collective-permute" not in rec["counts"]
            assert rec["bytes"] == pytest.approx(gossip + metrics, rel=1e-12), algo


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------


def test_hw_defaults_are_the_h100s():
    hw = troof.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert troof.F32_FLOP_PER_S == 67e12 and troof.TF32_FLOP_PER_S == 494.7e12
    assert troof.BF16_FLOP_PER_S == hw.peak_flops


@pytest.mark.parametrize("flops,nbytes,egress", [(1e12, 2e9, 3e8), (5e9, 8e10, 0.0),
                                                 (7.5e14, 1.0, 4.4e11), (0.0, 0.0, 0.0)])
def test_roofline_arithmetic_equals_the_references(flops, nbytes, egress):
    for peak in (989e12, 67e12):
        t = troof.roofline_terms(flops_per_device=flops, bytes_per_device=nbytes,
                                 collective_egress=egress,
                                 hw=troof.HW(peak_flops=peak, hbm_bw=3.35e12, link_bw=450e9))
        j = jroof.roofline_terms(flops_per_device=flops, bytes_per_device=nbytes,
                                 collective_egress=egress,
                                 hw=jroof.HW(peak_flops=peak, hbm_bw=3.35e12, link_bw=450e9))
        assert t == j
    for training in (True, False):
        assert troof.model_flops(663_548_416, 4096, training=training) == \
            jroof.model_flops(663_548_416, 4096, training=training)


@pytest.mark.parametrize("op,hlo", [
    ("all-reduce", "all-reduce(f32[1024]{0} %p), replica_groups={{0,1,2,3,4,5,6,7}}"),
    ("all-gather", "all-gather(f32[128]{0} %p), replica_groups={{0,1,2,3}}, dimensions={0}"),
    ("reduce-scatter", "reduce-scatter(f32[1024]{0} %p), replica_groups={{0,1}}"),
    ("collective-permute", "collective-permute(f32[1024]{0} %p), "
                           "source_target_pairs={{0,1},{1,0}}"),
])
def test_collective_egress_equals_the_references_parser(op, hlo):
    """The ring rules against ``parse_collective_bytes`` on one HLO op (the
    result type's bytes; the permute's pairs carry no group size, which the
    parser then takes as 2)."""
    out = "f32[512]{0}" if op == "all-gather" else "f32[1024]{0}"
    stats = jroof.parse_collective_bytes(f"  %x = {out} {hlo}\n")
    group = {"all-reduce": 8, "all-gather": 4, "reduce-scatter": 2,
             "collective-permute": 2}[op]
    nbytes = 512 * 4 if op == "all-gather" else 1024 * 4
    assert troof.collective_egress(op, nbytes, group) == stats.egress_bytes
    assert stats.counts == {op: 1}


def test_kernel_bound_takes_the_larger_term():
    ms, by = troof.kernel_bound(3.35e9, 1.0)
    assert (ms, by) == (1.0, "bytes")
    ms, by = troof.kernel_bound(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    # 3xTF32: an f32 product on the tensor cores at a third of the TF32 rate
    ms, _ = troof.kernel_bound(1.0, 494.7e9, torch.float32, tensor_cores=True)
    assert ms == pytest.approx(3.0)
    ms, _ = troof.kernel_bound(1.0, 989e9, torch.bfloat16, tensor_cores=True)
    assert ms == pytest.approx(1.0)
