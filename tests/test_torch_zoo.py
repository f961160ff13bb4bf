"""The rest of the decoder zoo in the port against the JAX package, on the
CPU at the smoke configs: olmo-1b (non-parametric LayerNorm, empty norm
subtrees), qwen3-8b, granite-moe-1b-a400m and -3b-a800m (MoE), hymba-1.5b
(parallel attention + SSM heads, sliding window) and internvl2-2b (the
patch-embedding stub).  Parameter trees, the training loss with its router
terms and its gradient, prefill and decode, hymba's rolling window and its
engine's recurrent-state fault, olmo's checkpoint round trip, and the MoE
trainer through the CLI against a JAX oracle."""

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
from repro.kernels import fused_update as jfused
from repro.models import transformer as jT
from repro.models.layers import TPContext
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import reference_fields
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tT
from repro_torch.serve import Request, ServeEngine
from repro_torch.utils import tree_leaves, tree_map, tree_paths

ARCHS = ("olmo-1b", "qwen3-8b", "granite-moe-1b-a400m", "granite-moe-3b-a800m", "hymba-1.5b",
         "internvl2-2b")
TP1 = TPContext(size=1)
JRT = jT.RuntimeConfig(dtype="float32", remat=False)
TRT = tT.RuntimeConfig(dtype="float32")
LOSS_RTOL = 1e-5  # as tests/test_torch_model.py
GRAD_RTOL = 1e-4  # of each gradient leaf's max |value|
SELF_RTOL = 5e-4  # decode vs prefill, as tests/test_serve_consistency.py
LOGIT_RTOL = 1e-5  # port vs reference logits, of their max |value|
B, S, TL = 2, 16, 24  # batch, prompt length, cache target


def _cfgs(arch, dropless=False):
    """(reference, port) smoke configs; ``dropless`` gives MoE a capacity
    factor at which no assignment drops (single-token decode never drops),
    as tests/test_serve_consistency.py does."""
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if dropless and jcfg.moe:
        cf = float(jcfg.n_experts) / jcfg.top_k
        jcfg, tcfg = (dataclasses.replace(c, capacity_factor=cf) for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.device_get(jT.init_params(jax.random.key(1), jcfg))


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :s], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out, toks


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_count_match_jax(arch):
    """Same paths and shapes as the reference's tree — olmo's empty norm
    subtrees ``{}`` included — at the smoke config, and the same parameter
    count at the published one (from meta tensors)."""
    jcfg, tcfg = _cfgs(arch)
    assert dataclasses.asdict(jcfg) == reference_fields(tcfg)
    want = jax.tree.map(lambda s: tuple(s.shape),
                        jax.eval_shape(lambda k: jT.init_params(k, jcfg), jax.random.key(0)))
    got = tree_map(lambda t: tuple(t.shape),
                   tT.init_params(tcfg, torch.Generator(), device="meta"))
    assert got == want
    if arch == "olmo-1b":
        assert got["final_norm"] == {} and got["groups"]["g0"]["attn_norm"] == {}
    full_j, full_t = jget_config(arch), tget_config(arch)
    meta = tT.init_params(full_t, torch.Generator(), device="meta")
    assert tT.count_params(meta) == jT.count_params(full_j)
    assert [(g.kind, g.window, g.layers) for g in tT.block_groups(full_t)] == [
        (g.kind, g.window, g.layers) for g in jT.block_groups(full_j)]
    # the tree crosses the packages whole, empty subtrees included
    back = to_numpy(from_numpy(_params(arch)))
    assert jax.tree.structure(back) == jax.tree.structure(_params(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_metrics_and_grads_match_jax(arch):
    """The total (cross entropy + router terms), its metrics and the gradient
    of every leaf."""
    jcfg, tcfg = _cfgs(arch)
    params = _params(arch)
    batch, _ = _batch(jcfg, 0)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, jcfg, TP1, JRT), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tparams = from_numpy(params)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = tT.forward_loss(tparams, _t(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(k for k in wm if not k.startswith("_"))
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]), rtol=LOSS_RTOL,
                                   atol=0.0 if jcfg.moe or k == "xent" else 1e-12, err_msg=k)
    if jcfg.moe:
        assert float(metrics["moe_load_balance"]) > 0 and float(metrics["moe_router_z"]) > 0
        assert float(loss) != float(metrics["xent"])
    else:
        assert float(loss) == float(metrics["xent"])
    for path, g, w in zip(tree_paths(tparams), grads, tree_leaves(jax.device_get(wg))):
        assert _rel(g, w) < GRAD_RTOL, (path, _rel(g, w))


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """The reference's prefill of S tokens and one decode step at S, at the
    dropless config: their logits and the cache after the step."""
    jcfg, _ = _cfgs(arch, dropless=True)
    params = _params(arch)
    batch, toks = _batch(jcfg, 1)
    pre = {k: v for k, v in batch.items() if k != "targets"}
    jpre = jax.jit(lambda p, b: jT.prefill(p, b, jcfg, TP1, JRT, target_len=TL))
    lg_pre, cache = jpre(params, jax.tree.map(jnp.asarray, pre))
    lg_dec, cache = jax.jit(lambda p, t, c: jT.decode_step(p, t, c, jnp.int32(S), jcfg, TP1,
                                                           JRT, target_len=TL))(
        params, jnp.asarray(toks[:, S:S + 1]), cache)
    return np.asarray(lg_pre), np.asarray(lg_dec), jax.device_get(cache)


def _port_serve(arch):
    """The port's prefill of S tokens, one decode step at S, and the prefill
    of S + 1 tokens: their logits and the cache after the step."""
    _, tcfg = _cfgs(arch, dropless=True)
    batch, toks = _batch(tcfg, 1)
    tparams = from_numpy(_params(arch))
    pre = {k: torch.from_numpy(v) for k, v in batch.items() if k != "targets"}
    with torch.inference_mode():
        lg_pre, cache = tT.prefill(tparams, pre, tcfg, TRT, target_len=TL)
        lg_dec, cache = tT.decode_step(tparams, torch.from_numpy(toks[:, S:S + 1]), cache, S,
                                       tcfg, TRT, target_len=TL)
        full = {**pre, "tokens": torch.from_numpy(toks[:, :S + 1])}
        lg_full, _ = tT.prefill(tparams, full, tcfg, TRT, target_len=TL)
    return lg_pre, lg_dec, lg_full, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """One decode step after an S-token prefill equals the (S + 1)-token
    prefill's last logits (MoE dropless)."""
    _, lg_dec, lg_full, _ = _port_serve(arch)
    assert _rel(lg_dec, lg_full) < SELF_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_cache_match_jax(arch):
    """The port's prefill logits, decode logits and whole cache (kv with its
    positions, and hymba's SSM state) against the reference's."""
    want_pre, want_dec, want_cache = _jax_serve(arch)
    lg_pre, lg_dec, _, cache = _port_serve(arch)
    assert _rel(lg_pre, want_pre) < LOGIT_RTOL
    assert _rel(lg_dec, want_dec) < LOGIT_RTOL
    got = to_numpy(cache)
    assert tree_paths(got) == [p for p, _ in _paths(want_cache)]
    for (path, w), g in zip(_paths(want_cache), tree_leaves(got)):
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert _rel(g, w) < LOGIT_RTOL, path
    if arch == "hymba-1.5b":
        assert "ssm" in cache["g0"] and "kv" in cache["g0"]


def _paths(tree):
    return [("/".join(str(k.key) for k in p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("grouped", [False, True])
def test_hymba_rolling_window_matches_jax(grouped):
    """hymba's sliding-window groups keep a rolling cache of ``window`` (8)
    slots; decoding 10 tokens past a 12-token prompt wraps it, and every
    step's logits match the reference's and the port's own longer prefill.
    The heads are 10/2 (hd 8): hymba's 25/5 are a GQA group of 5, which the
    smoke config's 4/2 are not; both of ``attn_decode_step``'s paths run
    (q-head groups against the raw cache, and kv expanded to the heads)."""
    overrides = dict(n_heads=10, n_kv_heads=2, d_model=80, d_ssm=80)
    jcfg = dataclasses.replace(jget_config("hymba-1.5b", smoke=True), **overrides)
    tcfg = dataclasses.replace(tget_config("hymba-1.5b", smoke=True), **overrides)
    jrt = dataclasses.replace(JRT, decode_grouped_gqa=grouped)
    trt = dataclasses.replace(TRT, decode_grouped_gqa=grouped)
    params = jax.device_get(jT.init_params(jax.random.key(4), jcfg))
    tparams = from_numpy(params)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 22)).astype(np.int32)
    n0, tl = 12, 24
    jpre = jax.jit(lambda p, b: jT.prefill(p, b, jcfg, TP1, jrt, target_len=tl))
    jdec = jax.jit(lambda p, t, c, pos: jT.decode_step(p, t, c, pos, jcfg, TP1, jrt,
                                                       target_len=tl))
    _, jcache = jpre(params, {"tokens": jnp.asarray(toks[:, :n0])})
    with torch.inference_mode():
        _, cache = tT.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :n0])}, tcfg, trt,
                              target_len=tl)
        caps = {g: c["kv"]["k"].shape[2] for g, c in cache.items()}
        assert caps == {"g0": tl, "g1": jcfg.sliding_window, "g2": tl}
        for t in range(n0, 22):
            want, jcache = jdec(params, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
            got, cache = tT.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                                        tcfg, trt, target_len=tl)
            assert _rel(got, want) < LOGIT_RTOL, t
            full, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :t + 1])}, tcfg,
                                 trt)
            assert _rel(got, full) < SELF_RTOL, t


def _exact_path(tparams, tcfg, prompt, steps):
    """Prefill ``prompt[:-1]``, feed the last prompt token once at its
    position, decode greedily: the exact continuation of a recurrence."""
    with torch.inference_mode():
        _, cache = tT.prefill(tparams, {"tokens": torch.from_numpy(prompt[None, :-1])}, tcfg,
                              TRT, target_len=16 + steps)
        tok, out = torch.from_numpy(prompt[None, -1:]), []
        for t in range(prompt.size - 1, prompt.size - 1 + steps):
            logits, cache = tT.decode_step(tparams, tok, cache, t, tcfg, TRT,
                                           target_len=16 + steps)
            tok = logits[:, :tcfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
            out.append(int(tok))
    return out


def test_hymba_engine_mirrors_the_jax_engines_recurrent_state_fault():
    """Three prompts of 16, 9 and 5 tokens in one admission wave (max_prompt
    16): the padded wave and the re-fed last token reach the SSM state and
    its conv tail, as in xLSTM's engine, so the engine's tokens leave the
    exact path — in the JAX engine and in the port's alike."""
    arch = "hymba-1.5b"
    jcfg, tcfg = _cfgs(arch)
    params = _params(arch)
    tparams = from_numpy(params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (16, 9, 5)]
    max_new = 4
    jeng = JServeEngine(jcfg, jax.make_mesh((1, 1), ("data", "model")), slots=3,
                        max_prompt=16, max_new=max_new, runtime=JRT, params=params)
    eng = ServeEngine(tcfg, slots=3, max_prompt=16, max_new=max_new, params=tparams,
                      device="cpu", runtime=TRT)
    for e, req in ((jeng, JRequest), (eng, Request)):
        for i, prompt in enumerate(prompts):
            e.submit(req(rid=i, tokens=prompt, max_new_tokens=max_new))
    want = {c.rid: c.tokens.tolist() for c in jeng.run_until_drained()}
    got = {c.rid: c.tokens.tolist() for c in eng.run_until_drained()}
    assert got == want and eng.stats()["prefills"] == 1
    exact = [_exact_path(tparams, tcfg, p, max_new) for p in prompts]
    # the record of the fault (ROADMAP.md, queue 3): every prompt leaves the
    # exact path, the unpadded one too (its last token reaches the SSM twice)
    assert [got[i] for i in range(3)] == [[67, 19, 112, 67], [137, 226, 178, 42],
                                          [36, 156, 193, 172]], got
    assert exact == [[159, 147, 103, 198], [226, 226, 117, 226], [252, 44, 196, 44]], exact


@pytest.mark.parametrize("flat", [False, True], ids=["per-leaf", "planes"])
def test_olmo_checkpoint_round_trip_keeps_the_empty_norms(tmp_path, flat):
    """olmo's parameter-free norms are empty subtrees, which a flat npz
    stores no key for: a resumed run rebuilds them from the template, per
    leaf and on planes, and equals an unbroken run bit for bit."""
    argv = ["--nodes", "4", "--arch", "olmo-1b", "--smoke", "--seq-len", "16",
            "--per-node-batch", "2", "--fused-update", "--device", "cpu", "--log-every", "1",
            "--gossip-delay", "1", "--compression", "int8-row-ef"] + (
        ["--flat-planes"] if flat else [])
    finals = {}

    def keep(tag):
        def hook(step, state, metrics):
            finals[tag] = (step, to_numpy(state["params"]), to_numpy(state["opt"]))
        return hook

    whole = tlaunch.main(argv + ["--steps", "4"], on_step=keep("whole"))
    tlaunch.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    resumed = tlaunch.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--resume"],
                           on_step=keep("resumed"))
    assert resumed["start_step"] == 2 and resumed["losses"] == whole["losses"][2:]
    (_, wp, wo), (_, rp, ro) = finals["whole"], finals["resumed"]
    for want, got in ((wp, rp), (wo, ro)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w)
    assert rp["final_norm"] == {} and rp["groups"]["g0"]["mlp_norm"] == {}


def _moe_oracle(cfg, params, batches, n, per_node, seq, schedule):
    """vmapped value_and_grad of the reference's forward_loss (the total)
    and run_update with the stacked channel, the stacked mean and the Pallas
    stage kernel (interpret mode); returns per-step losses and metrics (the
    mean over nodes) and the final x and m."""
    ocfg = jopt.OptimizerConfig(algorithm="decentlam", momentum=0.9)
    spec, stage = jspec.update_spec(ocfg), jfused.make_stage("pallas_interpret")
    gossip = jgossip.StackedChannel(jtopo.build_topology("exp", n), telemetry=True)
    mean = jgossip.make_stacked_mean(n)
    lr_fn = jsched.build_schedule(jsched.ScheduleConfig(**schedule))
    vg = jax.vmap(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, cfg, TP1, JRT), has_aux=True))

    @jax.jit
    def step(x, m, chan, batch, k):
        b = {name: v.reshape(n, per_node, seq) for name, v in batch.items()}
        (loss, metrics), g = vg(x, b)
        x, st, chan = jspec.run_update(
            spec, ocfg, x=x, g=g, state={"m": m}, lr=lr_fn(k), step_idx=k,
            gossip=gossip, mean=mean, comp_state=chan, stage=stage,
        )
        return x, st["m"], chan, jnp.mean(loss), jax.tree.map(jnp.mean, metrics)

    x = jax.tree.map(jnp.asarray, params)
    m = jax.tree.map(jnp.zeros_like, x)
    chan = gossip.init(x)
    losses, metrics = [], []
    for k, batch in enumerate(batches):
        x, m, chan, loss, mt = step(x, m, chan, jax.tree.map(jnp.asarray, batch), jnp.int32(k))
        losses.append(float(loss))
        metrics.append({name: float(v) for name, v in mt.items() if not name.startswith("_")})
    return losses, metrics, jax.device_get(x), jax.device_get(m)


def test_moe_cli_matches_jax_oracle():
    """``launch.train --arch granite-moe-1b-a400m --smoke --device cpu``, 4
    nodes, exp, decentlam, 3 steps with the fused tail (the kernel's plain
    version on the CPU) against the reference's stacked oracle from the
    CLI's own initial parameters: per-step losses, xent and router terms,
    and the final parameters and momentum."""
    n, per_node, seq, steps = 4, 2, 16, 3
    schedule = dict(kind="warmup_cosine", peak_lr=0.05, warmup_steps=1, total_steps=steps)
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    init = to_numpy(tT.init_params(tcfg, torch.Generator().manual_seed(0)))
    params = jax.tree.map(lambda a: np.broadcast_to(a[None], (n,) + a.shape).copy(), init)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=tcfg.vocab_size, seq_len=seq,
                                         per_node_batch=per_node, n_nodes=n,
                                         heterogeneity=0.2))
    batches = [data.batch(k) for k in range(steps)]
    w_losses, w_metrics, wx, wm = _moe_oracle(jcfg, params, batches, n, per_node, seq,
                                              schedule)
    final = {}
    res = tlaunch.main(["--nodes", str(n), "--arch", "granite-moe-1b-a400m", "--smoke",
                        "--steps", str(steps), "--seq-len", str(seq), "--per-node-batch",
                        str(per_node), "--lr", "0.05", "--warmup", "1", "--heterogeneity",
                        "0.2", "--fused-update", "--device", "cpu", "--log-every", "1"],
                       on_step=lambda step, state, m: final.update(state=state))
    np.testing.assert_allclose(res["losses"], w_losses, rtol=LOSS_RTOL)
    for k in ("xent", "moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(res[k], [m[k] for m in w_metrics], rtol=LOSS_RTOL,
                                   err_msg=k)
    # parameters and momentum after 3 steps: (x - mix) / lr amplifies
    # roundoff by 1/lr per step (tests/test_torch_train.py's tolerance)
    state = final["state"]
    for name, got, want in (("x", state["params"], wx), ("m", state["opt"]["m"], wm)):
        for (path, w), g in zip(_paths(want), tree_leaves(to_numpy(got))):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-5, err_msg=f"{name}/{path}")
