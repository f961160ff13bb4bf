"""whisper-tiny's encoder-decoder in the port against the JAX package, on
the CPU at the smoke config: the parameter tree with its encoder subtree,
the training loss and its gradients, prefill with the cross-attention
cache, decode against prefill, the plain non-causal attention at Sq != Sk
against the reference's flash kernel in interpret mode, the train step with
``enc_frames`` (per leaf, on planes, microbatched) against a JAX oracle, a
checkpoint round trip, and the entry points that refuse the
encoder-decoder."""

import dataclasses
import functools

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
from repro.core.planes import PlaneLayout as JPlaneLayout
from repro.kernels import fused_update as jfused
from repro.kernels.flash_attention import ops as jfa
from repro.models import transformer as jT
from repro.models.layers import TPContext
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import reference_fields
from repro_torch.core import schedules as tsched
from repro_torch.core.optimizers import make_optimizer
from repro_torch.interop import from_numpy, planes_to_numpy, to_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tA
from repro_torch.models import transformer as tT
from repro_torch.serve import ServeEngine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_state as tts
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.utils import tree_leaves, tree_map, tree_paths

ARCH = "whisper-tiny"
TP1 = TPContext(size=1)
JRT = jT.RuntimeConfig(dtype="float32", remat=False)
TRT = tT.RuntimeConfig(dtype="float32")
LOSS_RTOL = 1e-5  # as tests/test_torch_model.py
GRAD_RTOL = 1e-4  # of each gradient leaf's max |value|
SELF_RTOL = 5e-4  # decode vs prefill, as tests/test_serve_consistency.py
LOGIT_RTOL = 1e-5  # port vs reference logits and caches, of their max |value|
FA_TOL = 2e-5  # flash attention in f32 (tests/test_kernels.py)
B, S, TL = 2, 12, 20  # batch, prompt length, cache target
# the train step: nodes, rows per node, decoder length, steps
N, PER_NODE, SEQ, STEPS = 4, 2, 8, 3
SCHEDULE = dict(kind="warmup_cosine", peak_lr=0.05, warmup_steps=1, total_steps=STEPS)
# parameters and momentum after 3 steps: (x - mix) / lr amplifies roundoff
# by 1/lr per step (tests/test_torch_train.py's tolerance)
STATE_RTOL, STATE_ATOL = 2e-3, 2e-5

JCFG, TCFG = jget_config(ARCH, smoke=True), tget_config(ARCH, smoke=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.device_get(jT.init_params(jax.random.key(3), JCFG))


def _batch(seed, rows=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab_size, (rows, s + 1)).astype(np.int32)
    frames = rng.standard_normal((rows, JCFG.enc_seq, JCFG.d_model)).astype(np.float32)
    return {"tokens": toks[:, :s], "targets": toks[:, 1:], "enc_frames": frames}, toks


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _paths(tree):
    return [("/".join(str(k.key) for k in p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_param_tree_groups_and_count_match_jax():
    """The encoder's ``enc`` groups and ``enc_norm`` beside the decoder's
    groups with their ``cross`` and ``cross_norm``: the same paths and shapes
    as the reference's at the smoke config, the same groups of both stacks,
    and the reference's count at the published one (56,364,288: the
    untied lm_head holds 19,916,160 of it)."""
    assert dataclasses.asdict(JCFG) == reference_fields(TCFG)
    want = jax.tree.map(lambda s: tuple(s.shape),
                        jax.eval_shape(lambda k: jT.init_params(k, JCFG), jax.random.key(0)))
    got = tree_map(lambda t: tuple(t.shape), tT.init_params(TCFG, torch.Generator(),
                                                          device="meta"))
    assert got == want
    assert {"enc", "enc_norm"} <= set(got) and "cross" in got["groups"]["g0"]
    full_j, full_t = jget_config(ARCH), tget_config(ARCH)
    meta = tT.init_params(full_t, torch.Generator(), device="meta")
    assert tT.count_params(meta) == jT.count_params(full_j)
    assert tT.count_params(meta) == 56_364_288
    for stack in ("enc", "dec"):
        assert [(g.kind, g.window, g.layers) for g in tT.block_groups(full_t, stack=stack)] == [
            (g.kind, g.window, g.layers) for g in jT.block_groups(full_j, stack=stack)]
    assert tT.block_groups(full_t, stack="enc")[0].kind == "enc"
    assert tT.block_groups(full_t)[0].kind == "dec"
    back = to_numpy(from_numpy(_params()))
    assert jax.tree.structure(back) == jax.tree.structure(_params())


def test_forward_loss_and_grads_match_jax():
    """The training loss (the encoder non-causal over the frames, the
    decoder's cross-attention over its output) and the gradient of every
    leaf, the encoder's included."""
    params = _params()
    batch, _ = _batch(0)
    (want, _), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, JCFG, TP1, JRT), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tparams = from_numpy(params)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    got, metrics = tT.forward_loss(tparams, _t(batch), TCFG, TRT)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    assert float(metrics["xent"]) == float(got.detach())
    grads = torch.autograd.grad(got, leaves)
    for (path, w), g in zip(_paths(wg), grads):
        assert _rel(g.numpy(), w) < GRAD_RTOL, path
    assert any(p.startswith("enc/") for p, _ in _paths(wg))


def test_encoder_needs_its_frames():
    batch, _ = _batch(0)
    del batch["enc_frames"]
    with pytest.raises(ValueError, match="enc_frames"):
        tT.forward_loss(from_numpy(_params()), _t(batch), TCFG, TRT)


@functools.lru_cache(maxsize=None)
def _jax_serve():
    params = _params()
    batch, toks = _batch(1)
    pre = {k: v for k, v in batch.items() if k != "targets"}
    lg_pre, cache = jax.jit(lambda p, b: jT.prefill(p, b, JCFG, TP1, JRT, target_len=TL))(
        params, jax.tree.map(jnp.asarray, pre))
    lg_dec, cache = jax.jit(lambda p, t, c: jT.decode_step(p, t, c, jnp.int32(S), JCFG, TP1,
                                                           JRT, target_len=TL))(
        params, jnp.asarray(toks[:, S:S + 1]), cache)
    return np.asarray(lg_pre), np.asarray(lg_dec), jax.device_get(cache)


def _port_serve(rt=TRT):
    batch, toks = _batch(1)
    tparams = from_numpy(_params())
    pre = {k: torch.from_numpy(v) for k, v in batch.items() if k != "targets"}
    with torch.inference_mode():
        lg_pre, cache = tT.prefill(tparams, pre, TCFG, rt, target_len=TL)
        lg_dec, cache = tT.decode_step(tparams, torch.from_numpy(toks[:, S:S + 1]), cache, S,
                                       TCFG, rt, target_len=TL)
        full = {**pre, "tokens": torch.from_numpy(toks[:, :S + 1])}
        lg_full, _ = tT.prefill(tparams, full, TCFG, rt, target_len=TL)
    return lg_pre, lg_dec, lg_full, cache


def test_prefill_cross_kv_and_decode_match_jax():
    """The prefill's logits, the whole cache (self kv with positions, and
    the cross k/v over the encoder's output, (count, B, enc_seq, KV, hd))
    and one decode step's logits (sinusoid at the slot's position, then
    the cached cross-attention) against the reference's."""
    want_pre, want_dec, want_cache = _jax_serve()
    lg_pre, lg_dec, _, cache = _port_serve()
    assert _rel(lg_pre, want_pre) < LOGIT_RTOL
    assert _rel(lg_dec, want_dec) < LOGIT_RTOL
    got = to_numpy(cache)
    assert tree_paths(got) == [p for p, _ in _paths(want_cache)]
    for (path, w), g in zip(_paths(want_cache), tree_leaves(got)):
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert _rel(g, w) < LOGIT_RTOL, path
    ck = cache["g0"]["cross_kv"]["k"]
    assert tuple(ck.shape) == (JCFG.n_layers, B, JCFG.enc_seq, JCFG.n_kv_heads, JCFG.hd)
    # the empty cache has the prefilled one's structure
    empty = tT.init_cache(TCFG, B, TL, TRT)
    assert tree_map(lambda t: tuple(t.shape), empty) == tree_map(lambda t: tuple(t.shape),
                                                                 cache)


def test_decode_chain_matches_prefill():
    """Decoding token by token after a prefill equals the longer prefill's
    last logits at every step (tests/test_serve_consistency.py)."""
    _, lg_dec, lg_full, _ = _port_serve()
    assert _rel(lg_dec, lg_full) < SELF_RTOL
    batch, toks = _batch(2, s=S + 4)
    tparams = from_numpy(_params())
    frames = torch.from_numpy(batch["enc_frames"])
    with torch.inference_mode():
        _, cache = tT.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]),
                                        "enc_frames": frames}, TCFG, TRT, target_len=TL)
        for t in range(S, S + 4):
            got, cache = tT.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                                        TCFG, TRT, target_len=TL)
            full, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :t + 1]),
                                           "enc_frames": frames}, TCFG, TRT)
            assert _rel(got, full) < SELF_RTOL, t


@pytest.mark.parametrize("sq,sk", [(12, 16), (7, 23), (1, 30), (23, 23)])
def test_plain_noncausal_attention_matches_pallas_interpret(sq, sk):
    """Non-causal attention at the encoder's (Sq == Sk) and the
    cross-attention's (Sq != Sk, ragged against the kernel's blocks) shapes:
    the port's plain branch and the flash wrapper's plain version (what a
    CPU tensor takes) against the reference's Pallas kernel in interpret
    mode, at whisper's head layout (H == Hkv), in f32."""
    rng = np.random.default_rng(sq * 100 + sk)
    h, hd = JCFG.n_heads, JCFG.hd
    q = rng.standard_normal((B, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((B, sk, h, hd)).astype(np.float32)
    v = rng.standard_normal((B, sk, h, hd)).astype(np.float32)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=False, window=0, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = tA.attention_core(tq, tk, tv, causal=False, impl="torch")
    wrapped = flash_attention(tq, tk, tv, causal=False, window=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=FA_TOL, rtol=0)
    np.testing.assert_allclose(wrapped.numpy(), want, atol=FA_TOL, rtol=0)


def test_prefill_plain_matches_jax_pallas_interpret():
    """The port's plain prefill against the reference's prefill with its
    flash kernel in interpret mode (encoder, decoder self- and
    cross-attention all through the kernel)."""
    jrt = dataclasses.replace(JRT, attn_impl="pallas_interpret")
    batch, _ = _batch(1)
    pre = {k: v for k, v in batch.items() if k != "targets"}
    want, _ = jT.prefill(_params(), jax.tree.map(jnp.asarray, pre), JCFG, TP1, jrt,
                         target_len=TL)
    lg_pre, _, _, _ = _port_serve()
    assert _rel(lg_pre, want) < LOGIT_RTOL


def test_cuda_runtime_takes_the_kernel_wrapper_on_cpu_tensors():
    """``attn_impl="cuda"`` on CPU tensors routes every attention through
    the flash wrapper, whose plain version a CPU tensor takes: the same
    logits as the plain path."""
    lg_pre, lg_dec, _, _ = _port_serve()
    k_pre, k_dec, _, _ = _port_serve(dataclasses.replace(TRT, attn_impl="cuda"))
    assert _rel(k_pre, lg_pre) < LOGIT_RTOL and _rel(k_dec, lg_dec) < LOGIT_RTOL


# ---------------------------------------------------------------------------
# The train step with enc_frames, against a JAX oracle
# ---------------------------------------------------------------------------


def _train_batches():
    out = []
    for k in range(STEPS):
        batch, _ = _batch(10 + k, rows=N * PER_NODE, s=SEQ)
        out.append(batch)
    return out


def _jax_oracle(params, batches, accum):
    """vmapped value_and_grad of the reference's forward_loss (microbatches
    summed ``g += g_j / accum`` in f32 from zeros, as its scan does) and
    run_update with the stacked channel, the stacked mean and the Pallas
    stage kernel (interpret mode)."""
    ocfg = jopt.OptimizerConfig(algorithm="decentlam", momentum=0.9)
    spec, stage = jspec.update_spec(ocfg), jfused.make_stage("pallas_interpret")
    gossip = jgossip.StackedChannel(jtopo.build_topology("exp", N), telemetry=True)
    mean = jgossip.make_stacked_mean(N)
    lr_fn = jsched.build_schedule(jsched.ScheduleConfig(**SCHEDULE))
    vg = jax.vmap(jax.value_and_grad(lambda p, b: jT.forward_loss(p, b, JCFG, TP1, JRT)[0]))
    mb = PER_NODE // accum

    @jax.jit
    def step(x, m, chan, batch, k):
        b = {n: v.reshape((N, PER_NODE) + v.shape[1:]) for n, v in batch.items()}
        g = jax.tree.map(jnp.zeros_like, x)
        loss = jnp.zeros((N,), jnp.float32)
        for j in range(accum):
            bj = {n: v[:, j * mb:(j + 1) * mb] for n, v in b.items()}
            lj, gj = vg(x, bj)
            g = jax.tree.map(lambda a, c: a + c / accum, g, gj) if accum > 1 else gj
            loss = loss + lj / accum if accum > 1 else lj
        x, st, chan = jspec.run_update(
            spec, ocfg, x=x, g=g, state={"m": m}, lr=lr_fn(k), step_idx=k,
            gossip=gossip, mean=mean, comp_state=chan, stage=stage,
        )
        return x, st["m"], chan, jnp.mean(loss)

    x = jax.tree.map(jnp.asarray, params)
    m = jax.tree.map(jnp.zeros_like, x)
    chan = gossip.init(x)
    losses = []
    for k, batch in enumerate(batches):
        x, m, chan, loss = step(x, m, chan, jax.tree.map(jnp.asarray, batch), jnp.int32(k))
        losses.append(float(loss))
    return losses, jax.device_get(x), jax.device_get(m)


def _stacked(params):
    return jax.tree.map(lambda a: np.broadcast_to(a[None], (N,) + a.shape).copy(), params)


def _port_run(params, batches, *, flat, accum, state=None, start=0):
    train = TrainConfig(algorithm="decentlam", topology="exp", momentum=0.9,
                        schedule=tsched.ScheduleConfig(**SCHEDULE), fused_update=True,
                        flat_planes=flat, grad_accum=accum)
    step_fn, channel = build_train_step(TCFG, train, N)
    layout = tts.model_plane_layout(TCFG) if flat else None
    if state is None:
        x = from_numpy(params)
        if flat:
            planes = layout.pack(x, leading=1)
            state = {"step": 0, "params": layout.view_unpack(planes, leading=1),
                     "planes": planes,
                     "opt": make_optimizer(train.opt_config()).init(planes),
                     "channel": channel.init(planes)}
        else:
            state = {"step": 0, "params": x,
                     "opt": make_optimizer(train.opt_config()).init(x),
                     "channel": channel.init(x)}
    losses = []
    for batch in batches[start:]:
        state, metrics = step_fn(state, from_numpy(batch))
        losses.append(float(metrics["loss"]))
    return losses, state, layout, channel


@pytest.mark.parametrize("flat,accum", [(False, 1), (True, 1), (False, 2)],
                         ids=["per-leaf", "planes", "grad-accum"])
def test_train_step_with_enc_frames_matches_jax_oracle(flat, accum):
    """4 nodes, decentlam on exp, 3 steps of the fused tail (the plain
    kernel on the CPU) with ``enc_frames`` (n * b, enc_seq, d) sliced per
    node like the tokens: per leaf, on flat planes (the encoder's leaves are
    plane rows like any other) and in 2 microbatches, against the JAX
    oracle: losses, final parameters and momentum."""
    params = _stacked(_params())
    batches = _train_batches()
    want_losses, want_x, want_m = _jax_oracle(params, batches, accum)
    losses, state, layout, _ = _port_run(params, batches, flat=flat, accum=accum)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    m = state["opt"]["m"]
    if flat:
        m = layout.view_unpack(m, leading=1)
        jlay = JPlaneLayout.build(_params())
        packed = jax.device_get(jlay.pack(jax.tree.map(jnp.asarray, want_x), leading=1))
        got = planes_to_numpy(state["planes"], layout)
        for key in packed:
            np.testing.assert_allclose(got[key], packed[key], rtol=STATE_RTOL,
                                       atol=STATE_ATOL)
    for name, got, want in (("x", state["params"], want_x), ("m", m, want_m)):
        for (path, w), g in zip(_paths(want), tree_leaves(to_numpy(got))):
            np.testing.assert_allclose(g, w, rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"{name}/{path}")


@pytest.mark.parametrize("flat", [False, True], ids=["per-leaf", "planes"])
def test_checkpoint_round_trip_with_the_encoder(tmp_path, flat):
    """2 steps, a checkpoint, a resume through the CLI's resume path, 1 more
    step == 3 unbroken steps bit for bit; the checkpoint holds the encoder's
    leaves under the reference's paths, and the reference restores it."""
    params = _stacked(_params())
    batches = _train_batches()
    whole, wstate, layout, _ = _port_run(params, batches, flat=flat, accum=1)
    first, state, _, _ = _port_run(params, batches[:2], flat=flat, accum=1)
    tckpt.save_checkpoint(str(tmp_path), state, plane_layout=layout)
    ref, _ = jckpt.restore_checkpoint(str(tmp_path))
    ref_paths = [p for p, _ in _paths(ref["params"])]
    assert ref_paths == [p for p, _ in _paths(_stacked(_params()))]
    assert any(p.startswith("enc/g0/") for p in ref_paths) and "enc_norm/scale" in ref_paths
    _, channel = build_train_step(TCFG, TrainConfig(schedule=tsched.ScheduleConfig(**SCHEDULE),
                                                    fused_update=True, flat_planes=flat), N)
    resumed = tlaunch.resume_state(str(tmp_path), TCFG, channel, layout, flat, N,
                                   torch.device("cpu"))
    assert resumed["step"] == 2
    rest, rstate, _, _ = _port_run(params, batches, flat=flat, accum=1, state=resumed,
                                   start=2)
    assert first + rest == whole
    for a, b in zip(tree_leaves(rstate["params"]), tree_leaves(wstate["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(rstate["opt"]), tree_leaves(wstate["opt"])):
        assert torch.equal(a, b)


def test_cli_and_engine_refuse_the_encoder_decoder():
    """The engine's requests carry no frames (as in the reference): it
    raises before any work, saying so.  The CLI's data carries seeded stub
    frames for an encoder-decoder, so the CLI trains it, stacked and on
    ranks, with finite losses."""
    for flags in (["--nodes", "2"], ["--simulate-nodes", "2"]):
        res = tlaunch.main(flags + ["--arch", ARCH, "--smoke", "--steps", "2", "--seq-len",
                                    "16", "--per-node-batch", "2", "--device", "cpu"])
        assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    with pytest.raises(NotImplementedError, match="enc_frames"):
        ServeEngine(TCFG, slots=2, max_prompt=8, max_new=4, params=from_numpy(_params()),
                    device="cpu")
