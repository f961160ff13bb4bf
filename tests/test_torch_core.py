"""The port's core (topology, schedules, data, update tails, the fused
stage engine) against the JAX package on the same numpy inputs.

On the CPU the fused engine runs the stage kernel's plain version; the JAX
side runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
does.  The Triton kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import schedules as jsched
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import SyntheticLMConfig as JSyntheticLMConfig
from repro.kernels import fused_update as jfused
from repro_torch.core import gossip as tgossip
from repro_torch.core import optimizers as topt
from repro_torch.core import schedules as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core import update_spec as tspec
from repro_torch.data.synthetic import SyntheticLM as TSyntheticLM
from repro_torch.data.synthetic import SyntheticLMConfig as TSyntheticLMConfig
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.kernels import fused_update as tfused

N_NODES = 4


# ---------------------------------------------------------------------------
# topology / schedules / data: copies, so exact equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(jtopo.TOPOLOGIES))
def test_topology_identical(family):
    a, b = jtopo.build_topology(family, 8), ttopo.build_topology(family, 8)
    assert a.period == b.period
    for t in range(a.period):
        np.testing.assert_array_equal(a.W(t), b.W(t))
        ca, cb = a.edge_classes(t), b.edge_classes(t)
        assert [c.perm for c in ca] == [c.perm for c in cb]
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x.recv_weight, y.recv_weight)
    assert a.rho() == b.rho()


SCHEDULES = [
    dict(kind="constant", peak_lr=0.1, total_steps=40),
    dict(kind="warmup_cosine", peak_lr=3e-3, warmup_steps=7, total_steps=40),
    dict(kind="warmup_cosine", peak_lr=0.5, warmup_steps=0, total_steps=40, final_frac=0.1),
    dict(kind="warmup_step", peak_lr=0.2, warmup_steps=5, total_steps=40),
]


@pytest.mark.parametrize("sc", SCHEDULES, ids=lambda d: d["kind"])
def test_schedules_equal_every_step(sc):
    fj = jsched.build_schedule(jsched.ScheduleConfig(**sc))
    ft = tsched.build_schedule(tsched.ScheduleConfig(**sc))
    want = np.array([float(fj(jnp.int32(s))) for s in range(sc["total_steps"] + 3)])
    got = np.array([ft(s) for s in range(sc["total_steps"] + 3)])
    # JAX evaluates in float32, the port in float64 rounded once to float32;
    # they differ by about one float32 ulp of the peak lr (near the end of a
    # cosine, 1 + cos(pi t) cancels in the reference's float32)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-7 * sc["peak_lr"])


@pytest.mark.parametrize("het", [0.0, 0.3])
def test_synthetic_batches_bit_identical(het):
    kw = dict(vocab_size=97, seq_len=12, per_node_batch=3, n_nodes=N_NODES,
              seed=5, heterogeneity=het)
    a, b = JSyntheticLM(JSyntheticLMConfig(**kw)), TSyntheticLM(TSyntheticLMConfig(**kw))
    for step in (0, 1, 17):
        ba, bb = a.batch(step), b.batch(step)
        for k in ba:
            assert ba[k].dtype == bb[k].dtype
            np.testing.assert_array_equal(ba[k], bb[k])


# ---------------------------------------------------------------------------
# one stage: every op x ctx flags, port (plain kernel + reference) vs JAX
# ---------------------------------------------------------------------------

CTXS = {
    "plain": dict(beta=0.9),
    "nesterov": dict(beta=0.9, nesterov=True),
    "clip-lars-coupled-wd": dict(beta=0.9, wd=0.01, coupled_wd=True, clip=True, lars=True),
    "decoupled-wd": dict(beta=0.9, wd=0.01, decoupled_wd=True),
}
OPS = [("pre", op) for op in jspec._PRE_IO] + [("post", op) for op in jspec._POST_IO]


def _stage_inputs(kind, op, ctx, seed):
    rng = np.random.default_rng(seed)
    ins, _ = jspec.pre_io(op, ctx) if kind == "pre" else jspec.post_io(op)
    shapes = {"w": (N_NODES, 5, 7), "b": (N_NODES, 3)}
    operands = {
        n: {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        for n in ins
    }
    if "mix" in operands and "x" in operands:  # a gossip output is near x
        operands["mix"] = {
            k: operands["x"][k] + 0.01 * v for k, v in operands["mix"].items()
        }
    like = operands.get("x", {k: np.zeros(s, np.float32) for k, s in shapes.items()})
    scalars = {"lr": 0.05, "gs": 0.7, "r": 1.3, "sg": 0.6}
    return operands, scalars, like


# the momentum recovery (x - mix) / lr amplifies roundoff by 1/lr = 20
STAGE_RTOL, STAGE_ATOL = 1e-6, 2e-6


@pytest.mark.parametrize("ctx_name", sorted(CTXS))
@pytest.mark.parametrize("kind,op", OPS, ids=[op for _, op in OPS])
def test_stage_math_matches_jax(kind, op, ctx_name):
    jctx, tctx = jspec.MathCtx(**CTXS[ctx_name]), tspec.MathCtx(**CTXS[ctx_name])
    operands, scalars, like = _stage_inputs(kind, op, jctx, seed=len(op))
    want = jspec.reference_stage(
        kind, op, jctx, jax.tree.map(jnp.asarray, operands),
        {k: jnp.float32(v) for k, v in scalars.items()}, jax.tree.map(jnp.asarray, like),
    )
    t_scalars = {k: torch.tensor(v, dtype=torch.float32) for k, v in scalars.items()}
    for stage in (tspec.reference_stage, tfused.make_stage("triton")):
        got = stage(kind, op, tctx, from_numpy(operands), t_scalars, from_numpy(like))
        assert set(got) == set(want)
        for name in want:
            for k in want[name]:
                np.testing.assert_allclose(
                    to_numpy(got[name])[k], np.asarray(want[name][k]),
                    rtol=STAGE_RTOL, atol=STAGE_ATOL, err_msg=f"{op}/{name}/{k}",
                )


def test_stage_inplace_writes_operands_and_keeps_dtype():
    """inplace=True writes x (in its own dtype) and m over the operands;
    the payload never aliases x."""
    ctx = tspec.MathCtx(beta=0.9)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((N_NODES, 33)), dtype=torch.bfloat16)
    mix = torch.tensor(rng.standard_normal((N_NODES, 33)), dtype=torch.float32)
    m = torch.tensor(rng.standard_normal((N_NODES, 33)), dtype=torch.float32)
    s = {"lr": torch.tensor(0.1)}
    want = tfused.make_stage("torch")("post", "decentlam_post", ctx,
                                      {"x": {"w": x.clone()}, "mix": {"w": mix},
                                       "m": {"w": m.clone()}}, s, {"w": x})
    got = tfused.make_stage("torch", inplace=True)(
        "post", "decentlam_post", ctx, {"x": {"w": x}, "mix": {"w": mix}, "m": {"w": m}},
        s, {"w": x},
    )
    assert got["x"]["w"] is x and got["m"]["w"] is m and x.dtype == torch.bfloat16
    torch.testing.assert_close(x, want["x"]["w"], rtol=0, atol=0)
    torch.testing.assert_close(m, want["m"]["w"], rtol=0, atol=0)
    pay = tfused.make_stage("torch", inplace=True)(
        "pre", "grad_step", ctx, {"x": {"w": mix}, "g": {"w": m}}, s, {"w": mix}
    )["payload"]["w"]
    assert pay.data_ptr() not in (mix.data_ptr(), m.data_ptr())


def test_fused_engine_rejects_unknown_impl_and_cuda_without_kernel_path():
    with pytest.raises(ValueError):
        tfused.make_stage("pallas")
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch

    with pytest.raises(ValueError, match="CUDA"):
        fused_stage_launch("pre", "grad_step", tspec.MathCtx(),
                           torch.zeros(4), {"x": torch.zeros(8), "g": torch.zeros(8)},
                           {"payload": torch.zeros(8)})


# ---------------------------------------------------------------------------
# whole update tails: 11 algorithms x {plain, nesterov, lars+clip+wd}, 2 steps
# ---------------------------------------------------------------------------

FEATURES = {
    "plain": dict(),
    "nesterov": dict(nesterov=True),
    "lars-clip-wd": dict(lars=True, grad_clip=1.0, weight_decay=1e-2, lars_trust=0.02),
}
# the JAX package's own fused-vs-reference tolerance (tests/test_kernels.py)
TAIL_RTOL, TAIL_ATOL = 2e-3, 2e-5


ONE_LEAF = {"w": (N_NODES, 5, 7)}
TWO_LEAVES = {"w": (N_NODES, 5, 7), "b": (N_NODES, 3)}


def _tail_case(seed, shapes):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    return params, grads


def _jax_tails(cfg, params, grads, lr):
    """2 steps of JAX opt.step and of run_update with the Pallas stage kernel
    (interpret mode): one jitted step, compiled once and run twice."""
    topo = jtopo.build_topology("exp", N_NODES)
    gossip, mean = jgossip.StackedChannel(topo), jgossip.make_stacked_mean(N_NODES)
    opt = jopt.make_optimizer(cfg)
    spec, stage = jspec.update_spec(cfg), jfused.make_stage("pallas_interpret")

    @jax.jit
    def step(p_ref, s_ref, p_fus, s_fus, g, k):
        p_ref, s_ref, _ = opt.step(p_ref, g, s_ref, lr=lr, step_idx=k,
                                   gossip=gossip, mean=mean)
        p_fus, s_fus, _ = jspec.run_update(
            spec, cfg, x=p_fus, g=g, state=s_fus, lr=lr, step_idx=k,
            gossip=gossip, mean=mean, comp_state=(), stage=stage,
        )
        return p_ref, s_ref, p_fus, s_fus

    p_ref = p_fus = jax.tree.map(jnp.asarray, params)
    s_ref, s_fus = opt.init(p_ref), opt.init(p_fus)
    for k, g in enumerate(grads):
        p_ref, s_ref, p_fus, s_fus = step(p_ref, s_ref, p_fus, s_fus,
                                          jax.tree.map(jnp.asarray, g), jnp.int32(k))
    return jax.device_get(((p_ref, s_ref), (p_fus, s_fus)))


def _torch_tails(cfg, params, grads, lr):
    """2 steps of the port's opt.step and of run_update with the fused engine
    (plain kernel on the CPU, in place as the train step runs it)."""
    topo = ttopo.build_topology("exp", N_NODES)
    gossip, mean = tgossip.StackedChannel(topo), tgossip.make_stacked_mean(N_NODES)
    opt = topt.make_optimizer(cfg)
    spec, stage = tspec.update_spec(cfg), tfused.make_stage("triton", inplace=True)
    p_ref, p_fus = from_numpy(params), from_numpy(params)
    s_ref, s_fus = opt.init(p_ref), opt.init(p_fus)
    for k, g in enumerate(grads):
        p_ref, s_ref, _ = opt.step(p_ref, from_numpy(g), s_ref, lr=lr, step_idx=k,
                                   gossip=gossip, mean=mean)
        p_fus, s_fus, _ = tspec.run_update(
            spec, cfg, x=p_fus, g=from_numpy(g), state=s_fus, lr=lr, step_idx=k,
            gossip=gossip, mean=mean, comp_state={}, stage=stage,
        )
    return to_numpy(p_ref), to_numpy(s_ref), to_numpy(p_fus), to_numpy(s_fus)


def _close(a, b, what):
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
                                   rtol=TAIL_RTOL, atol=TAIL_ATOL, err_msg=f"{what}[{k}]")


def _check_tails(kw, shapes, seed):
    params, grads = _tail_case(seed, shapes)
    lr = 0.05
    (jp_ref, js_ref), (jp_fus, js_fus) = _jax_tails(jopt.OptimizerConfig(**kw), params, grads, lr)
    tp_ref, ts_ref, tp_fus, ts_fus = _torch_tails(topt.OptimizerConfig(**kw), params, grads, lr)
    algo = kw["algorithm"]
    for got_p, got_s, tag in ((tp_ref, ts_ref, "ref"), (tp_fus, ts_fus, "fused")):
        for want_p, want_s, jtag in ((jp_ref, js_ref, "opt.step"), (jp_fus, js_fus, "pallas")):
            _close(got_p, want_p, f"{algo} port {tag} vs jax {jtag} params")
            assert set(got_s) == set(want_s)
            for sk in want_s:
                _close(got_s[sk], want_s[sk], f"{algo} port {tag} vs jax {jtag} {sk}")


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("algo", jopt.ALGORITHMS)
def test_update_tail_matches_jax(algo, feat):
    kw = dict(algorithm=algo, momentum=0.9, slowmo_period=2, **FEATURES[feat])
    _check_tails(kw, ONE_LEAF, seed=len(algo) + len(feat))


@pytest.mark.parametrize("algo", ["pmsgd-lars", "decentlam"])
def test_update_tail_two_leaves_lars_clip_wd(algo):
    """Per-leaf LARS ratios and the clip norm over several leaves."""
    kw = dict(algorithm=algo, momentum=0.9, **FEATURES["lars-clip-wd"])
    _check_tails(kw, TWO_LEAVES, seed=1)


def test_decentlam_update_matches_jax_pallas():
    rng = np.random.default_rng(11)
    tree = lambda: {"w": rng.standard_normal((N_NODES, 300)).astype(np.float32),
                    "b": rng.standard_normal((N_NODES, 2, 3)).astype(np.float32)}
    x, m = tree(), tree()
    mix = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32) for k, v in x.items()}
    jx, jm = jfused.decentlam_update(
        jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, mix),
        jax.tree.map(jnp.asarray, m), 0.1, beta=0.9, impl="pallas_interpret",
    )
    tx, tm = tfused.decentlam_update(from_numpy(x), from_numpy(mix), from_numpy(m), 0.1,
                                     beta=0.9)
    for want, got in ((jx, tx), (jm, tm)):
        for k in want:
            np.testing.assert_allclose(to_numpy(got)[k], np.asarray(want[k]),
                                       rtol=STAGE_RTOL, atol=STAGE_ATOL)


def test_interop_round_trip_keeps_paths_shapes_and_dtypes():
    """JAX trees (bf16, f32, int32, 0-d) -> port tensors -> numpy, bit for bit."""
    rng = np.random.default_rng(5)
    tree = jax.device_get({
        "embed": {"table": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)},
        "m": {"w": jnp.asarray(rng.standard_normal((2, 5)), jnp.float32)},
        "t": {"rounds": jnp.int32(7), "bytes": jnp.float32(1.5)},
    })
    got = from_numpy(tree)
    assert got["embed"]["table"].dtype == torch.bfloat16
    assert got["t"]["rounds"].dtype == torch.int32 and got["t"]["rounds"].ndim == 0
    back = to_numpy(got)
    for want, have in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert want.dtype == have.dtype and want.shape == have.shape
        np.testing.assert_array_equal(np.asarray(have), np.asarray(want))
