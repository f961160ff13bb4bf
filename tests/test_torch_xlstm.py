"""The port's xLSTM stack (xlstm-350m) against the JAX package, in float32
on the CPU, at the SMOKE size (4 layers: mLSTM, sLSTM, mLSTM, sLSTM; d 64,
2 heads):

* the mLSTM and sLSTM blocks with and without a carried state;
* ``forward_loss`` and its parameter gradient (the mLSTM cell's plain
  version, as the reference trains);
* ``prefill`` (``mlstm_impl`` "cuda", which takes the kernel's plain version
  on a CPU tensor, and "torch"), ``init_cache`` and ``decode_step`` with a
  per-slot ``t`` (the absolute sinusoidal positions of ``rope_theta == 0``);
* ``ServeEngine`` token-identical to the JAX engine on variable-length
  prompts.  The reference engine right-pads an admission wave with token 0
  and re-feeds the last prompt token at its first decode; both are exact
  for an attention cache but not for a recurrence (the state absorbs the
  pads and the repeated token).  The port mirrors those mechanics, so the
  two engines agree token for token; the exact path (prefill of
  ``prompt[:-1]``, then the last prompt token fed once) is held against
  JAX's separately;
* the full-width config: its block groups and its parameter count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jT
from repro.models import xlstm as jX
from repro.models.layers import TPContext
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import greedy_decode_loop as jgreedy
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.models import transformer as tT
from repro_torch.models import xlstm as tX
from repro_torch.models.layers import Initializer
from repro_torch.serve import Request, ServeEngine, greedy_decode_loop
from repro_torch.train import serve as tserve
from repro_torch.utils import tree_leaves, tree_paths

TP1 = TPContext(size=1)
JCFG, TCFG = jget_config("xlstm-350m", smoke=True), tget_config("xlstm-350m", smoke=True)
JRT = jT.RuntimeConfig(dtype="float32", remat=False)
# the JAX package's mLSTM tolerance (tests/test_kernels.py), of each
# output's max |value|; logits as tests/test_torch_serve.py
RTOL = 2e-4
LOGIT_RTOL = 1e-4
GRAD_RTOL = 1e-4  # of each gradient leaf's max |value|
SELF_RTOL = 5e-4  # decode vs prefill, as tests/test_serve_consistency.py
S, TL = 32, 40  # prompt length (a multiple of the 16-row test chunk), cache target


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


_jinit = jax.jit(lambda key: jT.init_params(key, JCFG))  # compiled once for all seeds


def _params(seed=0):
    return jax.device_get(_jinit(jax.random.key(seed)))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape).astype(np.int32)


def _layer(params, gi):
    """Layer 0 of block group ``gi`` (unstacked), as numpy."""
    return jax.tree.map(lambda a: a[0], params["groups"][f"g{gi}"])


def _assert_tree_close(got, want, rtol=RTOL):
    assert tree_paths(got) == tree_paths(from_numpy(want))
    for path, a, b in zip(tree_paths(got), tree_leaves(to_numpy(got)), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert _rel(a, b) < rtol, (path, _rel(a, b))


def _state(seed, shapes):
    r = np.random.default_rng(seed)
    st = {n: r.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    if "n" in st:
        st["n"] = np.abs(st["n"]) + 0.5
    return st


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_block_matches_jax(with_state):
    p = _layer(_params(), 0)["mlstm"]
    x = np.random.default_rng(1).standard_normal((2, S, JCFG.d_model)).astype(np.float32)
    H, dh = JCFG.n_heads, int(JCFG.proj_factor * JCFG.d_model) // JCFG.n_heads
    st = _state(2, {"C": (2, H, dh, dh), "n": (2, H, dh), "m": (2, H)}) if with_state else None
    want, want_st = jax.jit(lambda x, p, st: jX.mlstm_forward(
        x, p, JCFG, TP1, chunk=16, state=st, return_state=True))(jnp.asarray(x), p, st)
    for impl in tX.MLSTM_IMPLS:  # "cuda" takes the plain version on a CPU tensor
        got, got_st = tX.mlstm_forward(torch.from_numpy(x), from_numpy(p), TCFG, chunk=16,
                                       impl=impl, state=from_numpy(st) if st else None,
                                       return_state=True)
        assert _rel(got, want) < RTOL
        _assert_tree_close(got_st, jax.device_get(want_st))
    with pytest.raises(ValueError, match="mlstm_impl"):
        tX.mlstm_forward(torch.from_numpy(x), from_numpy(p), TCFG, impl="pallas")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_matches_jax(with_state):
    p = _layer(_params(), 1)["slstm"]
    x = np.random.default_rng(3).standard_normal((2, S, JCFG.d_model)).astype(np.float32)
    d = JCFG.d_model
    st = _state(4, {"c": (2, d), "n": (2, d), "m": (2, d), "h": (2, d)}) if with_state else None
    want, want_st = jax.jit(lambda x, p, st: jX.slstm_forward(
        x, p, JCFG, TP1, state=st, return_state=True))(jnp.asarray(x), p, st)
    got, got_st = tX.slstm_forward(torch.from_numpy(x), from_numpy(p), TCFG,
                                   state=from_numpy(st) if st else None, return_state=True)
    assert _rel(got, want) < RTOL
    _assert_tree_close(got_st, jax.device_get(want_st))


def test_forward_loss_and_grad_match_jax():
    params = _params(seed=5)
    toks = _tokens(5, (2, S + 1))
    batch = {"tokens": toks[:, :S], "targets": toks[:, 1:]}
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, JCFG, TP1, JRT), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = from_numpy(params)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = tT.forward_loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    TCFG)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) < 1e-5 * abs(float(jloss))
    assert metrics["xent"].item() == loss.item()
    jleaves = tree_leaves(jax.device_get(jgrad))
    for path, g, jg in zip(tree_paths(tparams), grads, jleaves):
        assert _rel(g, jg) < GRAD_RTOL, (path, _rel(g, jg))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_prefill_matches_jax(impl):
    params = _params(seed=6)
    toks = _tokens(6, (2, S))
    trt = tT.RuntimeConfig("float32", mlstm_impl=impl, mlstm_chunk=16)
    jrt = dataclasses.replace(JRT, mlstm_chunk=16)
    jl, jc = jax.jit(lambda p, b: jT.prefill(p, b, JCFG, TP1, jrt, target_len=TL))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = tserve.build_prefill_step(TCFG, tserve.ServeConfig(trt, TL))(
        from_numpy(params), {"tokens": torch.from_numpy(toks)})
    assert _rel(tl, jl) < LOGIT_RTOL
    _assert_tree_close(tc, jax.device_get(jc))
    H, dh, d = JCFG.n_heads, 2 * JCFG.d_model // JCFG.n_heads, JCFG.d_model
    assert tc["g0"]["mlstm"]["C"].shape == (1, 2, H, dh, dh)
    assert tc["g1"]["slstm"]["h"].shape == (1, 2, d)


def test_init_cache_matches_jax():
    want = jax.device_get(jT.init_cache(JCFG, 3, 1024, 1, JRT))
    got = tT.init_cache(TCFG, 3, 1024, tT.RuntimeConfig("float32"))
    _assert_tree_close(got, want)
    assert not any(t.any() for t in tree_leaves(got))


def test_decode_step_matches_jax_per_slot_t():
    """One decode step from a JAX-built cache at per-slot positions S and
    S - 5 (different sinusoids per slot): logits and the recurrent state,
    which the port writes into the cache in place."""
    params = _params(seed=7)
    toks = _tokens(7, (2, S + 1))
    _, jc = jax.jit(lambda p, b: jT.prefill(p, b, JCFG, TP1, JRT, target_len=TL))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    jc = jax.device_get(jc)
    tv = np.array([S, S - 5], np.int32)
    jl, jc2 = jax.jit(lambda p, tk, c, t: jT.decode_step(p, tk, c, t, JCFG, TP1, JRT,
                                                         target_len=TL))(
        params, jnp.asarray(toks[:, S:]), jc, jnp.asarray(tv))
    step = tserve.build_decode_step(TCFG, tserve.ServeConfig(tT.RuntimeConfig("float32"), TL),
                                    target_len=TL, per_slot_t=True)
    cache = from_numpy(jc)
    before = [t.data_ptr() for t in tree_leaves(cache)]
    tl, tc2 = step(from_numpy(params), torch.from_numpy(toks[:, S:]), cache,
                   torch.from_numpy(tv))
    assert _rel(tl, jl) < LOGIT_RTOL
    _assert_tree_close(tc2, jax.device_get(jc2))
    assert [t.data_ptr() for t in tree_leaves(tc2)] == before  # updated in place


def test_decode_matches_own_prefill():
    """Prefill S tokens, decode token S: the logits equal a prefill of S + 1
    tokens (the recurrence carried one step)."""
    params = from_numpy(_params(seed=8))
    toks = torch.from_numpy(_tokens(8, (2, S + 1)))
    rt = tT.RuntimeConfig("float32", mlstm_impl="cuda")
    full, _ = tT.prefill(params, {"tokens": toks}, TCFG, rt, target_len=TL)
    _, cache = tT.prefill(params, {"tokens": toks[:, :S]}, TCFG, rt, target_len=TL)
    dec, _ = tT.decode_step(params, toks[:, S:], cache, S, TCFG, rt, target_len=TL)
    assert _rel(dec, full) < SELF_RTOL


# ---------------------------------------------------------------------------
# Serving: the engine against the JAX engine, and the exact greedy path
# ---------------------------------------------------------------------------

MAX_PROMPT, MAX_NEW = 16, 4


def _prompts(seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (16, 9, 5, 12, 3)]


def _drive(eng, req_cls, prompts):
    """3 requests up front, one tick, the rest mid-flight; drain."""
    for i in range(3):
        eng.submit(req_cls(rid=i, tokens=prompts[i], max_new_tokens=MAX_NEW))
    eng.tick()
    for i in range(3, len(prompts)):
        eng.submit(req_cls(rid=i, tokens=prompts[i], max_new_tokens=MAX_NEW))
    return {c.rid: c.tokens for c in eng.run_until_drained()}


def test_engine_token_identical_to_jax_engine():
    params = _params(seed=9)
    prompts = _prompts(9)
    jeng = JServeEngine(JCFG, jax.make_mesh((1, 1), ("data", "model")), slots=3,
                        max_prompt=MAX_PROMPT, max_new=MAX_NEW, runtime=JRT, params=params)
    want = _drive(jeng, JRequest, prompts)
    seen = {}  # the on_logits hook: each generated token's row of logits

    def on_logits(logits, rows):
        seen.update({key: int(logits[i].argmax()) for i, key in rows.items()})

    eng = ServeEngine(TCFG, slots=3, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                      params=from_numpy(params), device="cpu", on_logits=on_logits,
                      runtime=tT.RuntimeConfig("float32", mlstm_impl="cuda"))
    got = _drive(eng, Request, prompts)
    assert sorted(got) == list(range(len(prompts)))
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid], str(rid))
    assert eng.stats()["prefills"] >= 2 and eng.idle
    assert seen == {(rid, j): int(t) for rid, toks in got.items() for j, t in enumerate(toks)}


def _exact_path(decode, prefill, params, prompt, steps, loop, to_dev):
    """Prefill ``prompt[:-1]``, feed the last prompt token once at its
    position, decode greedily: the exact continuation of a recurrence."""
    n = prompt.size
    _, cache = prefill(params, {"tokens": to_dev(prompt[None, :-1])})
    toks, _ = loop(decode, params, cache, to_dev(prompt[None, -1:]), n - 1, steps)
    return np.asarray(toks)[0].tolist()


def test_engine_mirrors_the_jax_engines_recurrent_state_fault():
    """Three prompts of 16, 9 and 5 tokens in one admission wave
    (max_prompt 16): the padded wave and the re-fed last token move the
    recurrent state, so the engine's tokens leave the exact path on the
    padded prompts, in the JAX engine and in the port's alike."""
    params = _params(seed=0)
    tparams = from_numpy(params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (16, 9, 5)]
    rt = tT.RuntimeConfig("float32", mlstm_impl="cuda")
    jeng = JServeEngine(JCFG, jax.make_mesh((1, 1), ("data", "model")), slots=3,
                        max_prompt=MAX_PROMPT, max_new=MAX_NEW, runtime=JRT, params=params)
    eng = ServeEngine(TCFG, slots=3, max_prompt=MAX_PROMPT, max_new=MAX_NEW, params=tparams,
                      device="cpu", runtime=rt)
    for e, req in ((jeng, JRequest), (eng, Request)):
        for i, prompt in enumerate(prompts):
            e.submit(req(rid=i, tokens=prompt, max_new_tokens=MAX_NEW))
    want = {c.rid: c.tokens.tolist() for c in jeng.run_until_drained()}
    got = {c.rid: c.tokens.tolist() for c in eng.run_until_drained()}
    assert got == want and eng.stats()["prefills"] == 1
    scfg = tserve.ServeConfig(rt, TL)
    exact = [_exact_path(tserve.build_decode_step(TCFG, scfg, target_len=TL),
                         tserve.build_prefill_step(TCFG, scfg), tparams, p, MAX_NEW,
                         greedy_decode_loop, torch.from_numpy) for p in prompts]
    # the record of the fault in ROADMAP.md (queue 3)
    assert [got[i] for i in range(3)] == [[237, 94, 94, 94], [237, 205, 205, 51],
                                          [64, 60, 104, 237]], got
    assert exact == [[237, 94, 94, 94], [237, 237, 205, 70], [237, 104, 104, 104]], exact


def test_exact_greedy_path_matches_jax():
    """The exact path (prefill ``prompt[:-1]``, the last prompt token fed
    once): token-identical to the same path on the JAX package."""
    params = _params(seed=10)
    tparams = from_numpy(params)
    scfg = tserve.ServeConfig(tT.RuntimeConfig("float32", mlstm_impl="cuda"), TL)
    jprefill = jax.jit(lambda p, b: jT.prefill(p, b, JCFG, TP1, JRT, target_len=TL))
    jdecode = jax.jit(lambda p, tk, c, t: jT.decode_step(p, tk, c, t, JCFG, TP1, JRT,
                                                         target_len=TL))
    for prompt in _prompts(10)[:2]:  # lengths 16 and 9
        want = _exact_path(jdecode, jprefill, params, prompt, MAX_NEW, jgreedy, jnp.asarray)
        got = _exact_path(tserve.build_decode_step(TCFG, scfg, target_len=TL),
                          tserve.build_prefill_step(TCFG, scfg), tparams, prompt, MAX_NEW,
                          greedy_decode_loop, torch.from_numpy)
        assert got == want, prompt.size


# ---------------------------------------------------------------------------
# The full-width config
# ---------------------------------------------------------------------------


def test_full_width_groups_and_param_count_match_jax():
    """xlstm-350m: 24 layers in 8 block groups (sLSTM at 5, 11, 17, 23) and
    506,045,520 parameters, counted from one layer of each kind at full
    width (the whole tree would take 2 GB here)."""
    jcfg, tcfg = jget_config("xlstm-350m"), tget_config("xlstm-350m")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    groups = tT.block_groups(tcfg)
    assert [(g.kind, g.layers) for g in groups] == [(g.kind, g.layers)
                                                   for g in jT.block_groups(jcfg)]
    assert len(groups) == 8 and tcfg.slstm_layers() == (5, 11, 17, 23)
    init = Initializer(torch.Generator().manual_seed(0))
    layers = {g.kind: (f"groups/g{gi}/", tT._layer_init(init, tcfg, g.kind))
              for gi, g in list(enumerate(groups))[:2]}
    d, vp = tcfg.d_model, tcfg.vocab_padded(1)
    total = sum(g.count * sum(t.numel() for t in tree_leaves(layers[g.kind][1]))
                for g in groups) + 2 * vp * d + d
    assert total == jT.count_params(jcfg) == 506_045_520
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg), jax.random.key(0))
    want = {p: s.shape[1:] for p, s in zip(tree_paths(shapes), jax.tree.leaves(shapes))
            if p.startswith(("groups/g0/", "groups/g1/"))}
    got = {pre + p: tuple(t.shape) for pre, tree in layers.values()
           for p, t in zip(tree_paths(tree), tree_leaves(tree))}
    assert got == want
    # positions up to the test cache's 40; f32 angles p * freq differ by the
    # two libraries' exp of freq (an ulp), which grows with p
    pos = np.array([[0, 3, 39]])
    np.testing.assert_allclose(tT._sinusoid(torch.from_numpy(pos), d).numpy(),
                               np.asarray(jT._sinusoid(jnp.asarray(pos), d)), atol=1e-5)


def test_unported_families_raise():
    # every decoder-only family is ported; the encoder-decoder is not yet
    with pytest.raises(NotImplementedError, match="ported"):
        tT.block_groups(dataclasses.replace(TCFG, xlstm=False, arch_kind="encdec"))
