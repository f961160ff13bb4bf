"""The port's serve path against the JAX package, in float32 on the CPU:

* ``prefill`` (last-token logits and the cache's k / v / pos) against JAX
  ``prefill`` with the Pallas kernel in interpret mode (the port's
  ``attn_impl="cuda"``, which takes the kernel's plain version on a CPU
  tensor) and with the jnp path (the port's ``"torch"``), for the qwen3-0.6b
  and h2o-danube-1.8b smoke configs (the latter's 16-slot window rolls the
  cache: capacity < S) and ``tiny_lm``, with ``target_len`` > S;
* ``decode_step`` against JAX with a per-slot ``t`` vector, grouped and
  expanded GQA; the port's decode against its own prefill;
* ``ServeEngine`` token-identical to the JAX ``ServeEngine`` (staggered
  prompts, queue deeper than the slots, eos, oversized requests);
* the cache trees cross the two packages leaf for leaf (int32 ``pos``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import tiny_lm as jtiny_lm
from repro.models import transformer as jT
from repro.models.layers import TPContext
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import reference_fields
from repro_torch.configs import tiny_lm as ttiny_lm
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.models import transformer as tT
from repro_torch.serve import Request, ServeEngine, greedy_decode_loop
from repro_torch.train import serve as tserve
from repro_torch.utils import tree_leaves, tree_paths

TP1 = TPContext(size=1)
CACHE_RTOL = 1e-5  # of each cache leaf's max |value|
LOGIT_RTOL = 1e-4  # of max |logit|
SELF_RTOL = 5e-4  # decode vs prefill, as tests/test_serve_consistency.py
S, TL = 24, 40  # prompt length, cache target (> S)

CONFIGS = {
    "qwen3-0.6b": (jget_config("qwen3-0.6b", smoke=True), tget_config("qwen3-0.6b", smoke=True)),
    "h2o-danube-1.8b": (jget_config("h2o-danube-1.8b", smoke=True),
                        tget_config("h2o-danube-1.8b", smoke=True)),
    "tiny-lm": (jtiny_lm(n_layers=2, d_model=64, vocab_size=256),
                ttiny_lm(n_layers=2, d_model=64, vocab_size=256)),
}
IMPLS = {"cuda": "pallas_interpret", "torch": "jnp"}  # port impl -> JAX impl


def _rts(impl, grouped=False):
    return (jT.RuntimeConfig(dtype="float32", remat=False, attn_impl=IMPLS[impl],
                             decode_grouped_gqa=grouped),
            tT.RuntimeConfig(dtype="float32", attn_impl=impl, decode_grouped_gqa=grouped))


def _setup(name, seed=0):
    jcfg, tcfg = CONFIGS[name]
    assert dataclasses.asdict(jcfg) == reference_fields(tcfg)
    params = jax.device_get(jT.init_params(jax.random.key(seed), jcfg))
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, S + 1)).astype(np.int32)
    return jcfg, tcfg, params, toks


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


def _assert_cache_close(got, want):
    assert tree_paths(got) == tree_paths(from_numpy(want))
    for path, a, b in zip(tree_paths(got), tree_leaves(to_numpy(got)), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if b.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert _rel(a, b) < CACHE_RTOL, (path, _rel(a, b))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_matches_jax(name, impl):
    jcfg, tcfg, params, toks = _setup(name)
    jrt, trt = _rts(impl)
    jl, jc = jax.jit(lambda p, b: jT.prefill(p, b, jcfg, TP1, jrt, target_len=TL))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tserve.build_prefill_step(tcfg, tserve.ServeConfig(trt, TL))(
        from_numpy(params), {"tokens": torch.from_numpy(toks[:, :S])})
    assert _rel(tl.numpy(), jl) < LOGIT_RTOL
    _assert_cache_close(tc, jax.device_get(jc))
    if jcfg.sliding_window:  # the rolling cache holds the last `window` positions
        cap = tc["g0"]["kv"]["pos"].shape[-1]
        assert cap == jcfg.sliding_window < S
        assert sorted(tc["g0"]["kv"]["pos"][0, 0].tolist()) == list(range(S - cap, S))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_matches_jax_per_slot_t(name, grouped):
    """One decode step from a JAX-built cache (it crosses leaf for leaf,
    int32 pos included) at per-slot positions S and S - 3: logits and the
    updated cache against JAX's."""
    jcfg, tcfg, params, toks = _setup(name, seed=1)
    jrt, trt = _rts("cuda", grouped)
    _, jc = jax.jit(lambda p, b: jT.prefill(p, b, jcfg, TP1, jrt, target_len=TL))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    jc = jax.device_get(jc)
    tv = np.array([S, S - 3], np.int32)
    jl, jc2 = jax.jit(lambda p, tk, c, t: jT.decode_step(p, tk, c, t, jcfg, TP1, jrt,
                                                         target_len=TL))(
        params, jnp.asarray(toks[:, S:]), jc, jnp.asarray(tv))
    step = tserve.build_decode_step(tcfg, tserve.ServeConfig(trt, TL), target_len=TL,
                                    per_slot_t=True)
    tl, tc2 = step(from_numpy(params), torch.from_numpy(toks[:, S:]), from_numpy(jc),
                   torch.from_numpy(tv))
    assert _rel(tl.numpy(), jl) < LOGIT_RTOL
    _assert_cache_close(tc2, jax.device_get(jc2))
    with pytest.raises(ValueError, match="per_slot_t"):
        step(from_numpy(params), torch.from_numpy(toks[:, S:]), tc2, torch.tensor(S))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_matches_own_prefill(name, grouped):
    """Prefill S tokens, decode token S: the logits equal a prefill of S + 1
    tokens, as tests/test_serve_consistency.py holds the reference."""
    _, tcfg, params, toks = _setup(name, seed=2)
    _, trt = _rts("cuda", grouped)
    p = from_numpy(params)
    scfg = tserve.ServeConfig(trt, TL)
    full, _ = tserve.build_prefill_step(tcfg, scfg)(p, {"tokens": torch.from_numpy(toks)})
    _, cache = tserve.build_prefill_step(tcfg, scfg)(p, {"tokens": torch.from_numpy(toks[:, :S])})
    dec, _ = tserve.build_decode_step(tcfg, scfg, target_len=TL)(
        p, torch.from_numpy(toks[:, S:]), cache, S)
    assert _rel(dec.numpy(), full.numpy()) < SELF_RTOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_cache_matches_jax(name):
    """Empty caches agree leaf for leaf (zeros, pos -1); a sliding-window
    group's capacity is its window, not the target length."""
    jcfg, tcfg, _, _ = _setup(name)
    want = jax.device_get(jT.init_cache(jcfg, 3, 1024, 1, jT.RuntimeConfig(dtype="float32")))
    got = tT.init_cache(tcfg, 3, 1024, tT.RuntimeConfig("float32"))
    _assert_cache_close(got, want)
    assert got["g0"]["kv"]["k"].shape[2] == (jcfg.sliding_window or 1024)


def test_rolling_window_decode_matches_full_prefill():
    """h2o-danube smoke (window 16): six decode steps through the rolling
    cache equal a prefill over the whole sequence."""
    _, tcfg, params, _ = _setup("h2o-danube-1.8b", seed=3)
    _, trt = _rts("cuda")
    total = S + 6
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, total)).astype(np.int32))
    p, scfg = from_numpy(params), tserve.ServeConfig(trt, total + 4)
    _, cache = tserve.build_prefill_step(tcfg, scfg)(p, {"tokens": toks[:, :S]})
    decode = tserve.build_decode_step(tcfg, scfg, target_len=total + 4)
    for t in range(S, total):
        lg, cache = decode(p, toks[:, t:t + 1], cache, t)
    full, _ = tserve.build_prefill_step(tcfg, scfg)(p, {"tokens": toks})
    assert _rel(lg.numpy(), full.numpy()) < SELF_RTOL


def test_softcap_under_cuda_impl_raises():
    """The reference's Pallas branch silently drops logit_softcap; the
    port's kernel branch refuses it (the plain branch applies it)."""
    jcfg, _, params, toks = _setup("tiny-lm")
    cfg = dataclasses.replace(CONFIGS["tiny-lm"][1], logit_softcap=30.0)
    batch = {"tokens": torch.from_numpy(toks[:, :S])}
    with pytest.raises(NotImplementedError, match="softcap"):
        tT.prefill(from_numpy(params), batch, cfg, tT.RuntimeConfig("float32", "cuda"))
    jcfg = dataclasses.replace(jcfg, logit_softcap=30.0)
    want, _ = jT.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, TP1,
                         jT.RuntimeConfig(dtype="float32", remat=False))
    got, _ = tT.prefill(from_numpy(params), batch, cfg, tT.RuntimeConfig("float32", "torch"))
    assert _rel(got.numpy(), want) < LOGIT_RTOL


def test_runtime_config_rejects_unknowns():
    _, tcfg, params, toks = _setup("tiny-lm")
    batch = {"tokens": torch.from_numpy(toks[:, :S])}
    with pytest.raises(ValueError, match="attn_impl"):
        tT.prefill(from_numpy(params), batch, tcfg, tT.RuntimeConfig("float32", "pallas"))
    with pytest.raises(ValueError, match="dtype"):
        tT.RuntimeConfig("float33").cdtype


# ---------------------------------------------------------------------------
# The engine, against the JAX engine (the config of tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

ECFG_J = jtiny_lm(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)
ECFG_T = ttiny_lm(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)
MAX_PROMPT, MAX_NEW = 12, 6


def _prompts(n, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, ECFG_J.vocab_size, size=int(r.integers(2, MAX_PROMPT + 1)))
            .astype(np.int32) for _ in range(n)]


def _drive(eng, req_cls, prompts, max_new=MAX_NEW):
    """4 requests up front, 2 ticks, the rest mid-flight; drain."""
    for i in range(min(4, len(prompts))):
        eng.submit(req_cls(rid=i, tokens=prompts[i], max_new_tokens=max_new))
    for _ in range(2):
        eng.tick()
    for i in range(4, len(prompts)):
        eng.submit(req_cls(rid=i, tokens=prompts[i], max_new_tokens=max_new))
    return {c.rid: c for c in eng.run_until_drained()}


def _jax_engine(params, **kw):
    return JServeEngine(ECFG_J, jax.make_mesh((1, 1), ("data", "model")), slots=3,
                        max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                        runtime=jT.RuntimeConfig(dtype="float32", remat=False),
                        params=params, **kw)


def _port_engine(params, impl, **kw):
    return ServeEngine(ECFG_T, slots=3, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                       params=from_numpy(params), device="cpu",
                       runtime=tT.RuntimeConfig("float32", impl), **kw)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_engine_token_identical_to_jax_engine(impl):
    params = jax.device_get(jT.init_params(jax.random.key(0), ECFG_J))
    prompts = _prompts(7, seed=1)
    want = _drive(_jax_engine(params), JRequest, prompts)
    eng = _port_engine(params, impl)
    got = _drive(eng, Request, prompts)
    assert sorted(got) == list(range(7))
    for rid in range(7):
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens, str(rid))
        assert got[rid].submitted_s <= got[rid].admitted_s <= got[rid].finished_s
    st = eng.stats()
    assert st["completed"] == 7 and st["prefills"] >= 2
    assert eng.idle and not eng.tick()


def test_engine_eos_early_exit_matches_jax():
    params = jax.device_get(jT.init_params(jax.random.key(0), ECFG_J))
    prompts = _prompts(1, seed=4)
    ref = _drive(_jax_engine(params), JRequest, prompts)[0].tokens
    eos = int(ref[2])
    want = _drive(_jax_engine(params, eos_id=eos), JRequest, prompts)[0].tokens
    got = _drive(_port_engine(params, "cuda", eos_id=eos), Request, prompts)[0].tokens
    np.testing.assert_array_equal(got, want)
    assert len(got) <= 3 and got[-1] == eos


def test_engine_matches_sequential_oracle():
    """Each completion equals its own request prefilled alone at its exact
    length and decoded greedily (the reference's oracle, on the port)."""
    params = from_numpy(jax.device_get(jT.init_params(jax.random.key(2), ECFG_J)))
    prompts = _prompts(5, seed=5)
    rt = tT.RuntimeConfig("float32", "cuda")
    eng = ServeEngine(ECFG_T, slots=2, max_prompt=MAX_PROMPT, max_new=MAX_NEW, params=params,
                      device="cpu", runtime=rt)
    done = _drive(eng, Request, prompts)
    scfg = tserve.ServeConfig(rt, MAX_PROMPT + MAX_NEW)
    decode = tserve.build_decode_step(ECFG_T, scfg, target_len=MAX_PROMPT + MAX_NEW)
    for rid, prompt in enumerate(prompts):
        n = prompt.size
        _, cache = tserve.build_prefill_step(ECFG_T, scfg)(
            params, {"tokens": torch.from_numpy(prompt[None])})
        toks, _ = greedy_decode_loop(decode, params, cache, torch.from_numpy(prompt[None, -1:]),
                                     n - 1, MAX_NEW)
        np.testing.assert_array_equal(done[rid].tokens, toks[0].numpy(), str(rid))


def test_engine_rejects_oversized_requests():
    params = jax.device_get(jT.init_params(jax.random.key(0), ECFG_J))
    eng = ServeEngine(ECFG_T, slots=1, max_prompt=4, max_new=2, params=from_numpy(params),
                      device="cpu")
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(rid=0, tokens=np.arange(5, dtype=np.int32), max_new_tokens=1))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(rid=0, tokens=np.arange(3, dtype=np.int32), max_new_tokens=3))
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(rid=0, tokens=np.zeros(0, np.int32), max_new_tokens=1))
    assert eng.pending == 0 and eng.idle


def test_engine_without_cpu_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = from_numpy(jax.device_get(jT.init_params(jax.random.key(0), ECFG_J)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ECFG_T, slots=1, max_prompt=4, max_new=2, params=params)


def test_greedy_decode_loop_threads_tokens_and_positions():
    """Synthetic decode_fn whose argmax is ``(tok + t) % V``: the loop feeds
    each sampled token back and advances per-slot positions by one."""
    V = 11

    def decode_fn(params, tok, cache, t):
        return torch.nn.functional.one_hot(((tok[:, 0] + t) % V).long(), V).float(), cache

    toks, cache = greedy_decode_loop(decode_fn, None, "cache", torch.tensor([[3], [7]]),
                                     torch.tensor([2, 5]), 4)
    assert cache == "cache"
    cur, t = np.array([3, 7]), np.array([2, 5])
    for s in range(4):
        cur = (cur + t) % V
        np.testing.assert_array_equal(toks[:, s].numpy(), cur)
        t = t + 1
