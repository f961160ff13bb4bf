"""The port's selective SSM (``repro_torch.models.ssm``, hymba's parallel
heads) against the JAX package's on the CPU: the chunked forward (a length
that is a multiple of the chunk, and one that is not, which runs as one
chunk), its returned state, a chain of decode steps against a longer
prefill, the in-chunk scan against ``jax.lax.associative_scan`` and the
whole branch against a float64 sequential recurrence, and ``softplus``
past ``F.softplus``'s linear cut-over."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import from_numpy
from repro_torch.models import ssm as tssm

JCFG, TCFG = jget_config("hymba-1.5b", smoke=True), tget_config("hymba-1.5b", smoke=True)
TP1 = jlayers.TPContext()
B = 2
# f32 against the reference: the two libraries' matmuls, exp and the scan's
# products round differently (each ~1 ulp); relative to the output's max
RTOL = 2e-5
F64_RTOL = 1e-4  # f32 chunked scan against the float64 sequential recurrence


def _params(seed):
    return jax.device_get(jssm.ssm_init(jlayers.Initializer(jax.random.key(seed)), JCFG))


def _x(seed, S):
    return np.random.default_rng(seed).standard_normal((B, S, JCFG.d_model)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("S, chunk", [(32, 8), (30, 8), (12, 128)],
                         ids=["chunked", "one-chunk", "chunk-longer-than-S"])
def test_ssm_forward_and_state_match_jax(S, chunk):
    """S = 32 runs 4 chunks of 8; S = 30 is no multiple of 8 and runs as one
    chunk of 30, as in the reference; the output and the final (h, conv)
    state agree."""
    params, x = _params(0), _x(0, S)
    want, wst = jax.jit(lambda p, x: jssm.ssm_forward(x, p, JCFG, TP1, chunk=chunk,
                                                      return_state=True))(params, x)
    got, st = tssm.ssm_forward(torch.from_numpy(x), from_numpy(params), TCFG, chunk=chunk,
                               return_state=True)
    assert _rel(got, want) < RTOL
    assert _rel(st["h"], wst["h"]) < RTOL
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(wst["conv"]))


def test_decode_chain_equals_a_longer_prefill():
    """Prefill 16 tokens, then 8 decode steps carrying (h, conv): each step's
    output equals the 24-token prefill's row (port and reference alike), and
    the final state equals the longer prefill's."""
    params, x = _params(1), _x(1, 24)
    tp = from_numpy(params)
    full, fst = tssm.ssm_forward(torch.from_numpy(x), tp, TCFG, chunk=8, return_state=True)
    _, st = tssm.ssm_forward(torch.from_numpy(x[:, :16]), tp, TCFG, chunk=8, return_state=True)
    jstep = jax.jit(lambda p, x, s: jssm.ssm_decode_step(x, p, s, JCFG, TP1))
    _, jst = jax.jit(lambda p, x: jssm.ssm_forward(x, p, JCFG, TP1, chunk=8,
                                                   return_state=True))(params, x[:, :16])
    for t in range(16, 24):
        y, st = tssm.ssm_decode_step(torch.from_numpy(x[:, t:t + 1]), tp, st, TCFG)
        jy, jst = jstep(params, x[:, t:t + 1], jst)
        assert _rel(y[:, 0], full[:, t].numpy()) < RTOL, t
        assert _rel(y, jy) < RTOL, t
    # the conv tail holds the input projection, which a one-row matmul rounds
    # otherwise than the 24-row one
    assert _rel(st["h"], fst["h"]) < RTOL and _rel(st["conv"], fst["conv"].numpy()) < RTOL


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_associative_scan_matches_jax_order(n):
    """The in-chunk scan against ``jax.lax.associative_scan`` with the
    reference's combine, lengths odd and even (the recursion's two
    branches)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (B, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((B, n, 3, 4)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = tssm._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(ga, wa) < 1e-6 and _rel(gb, wb) < 1e-6


def _f64_reference(params, x):
    """The branch in float64 with a token-by-token recurrence (no chunks,
    no scan)."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    x = x.astype(np.float64)
    N, r = JCFG.ssm_state, max(1, math.ceil(JCFG.d_model / 16))
    xs, z = x @ p["in_proj"][:, 0], x @ p["in_proj"][:, 1]
    k = p["conv_w"].shape[0]
    xp = np.concatenate([np.zeros((B, k - 1, xs.shape[-1])), xs], axis=1)
    xs = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(k)) + p["conv_b"]
    silu = lambda v: v / (1.0 + np.exp(-v))
    xs = silu(xs)
    dbl = xs @ p["x_proj"]
    dt_lr, Bc, Cc = dbl[..., :r], dbl[..., r:r + N], dbl[..., r + N:]
    delta = np.logaddexp(dt_lr @ p["dt_proj"] + p["dt_bias"], 0.0)
    A = -np.exp(p["A_log"])
    h = np.zeros((B, xs.shape[-1], N))
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * xs[:, t])[..., None] * Bc[:, t,
                                                                                           None]
        ys.append(np.einsum("ben,bn->be", h, Cc[:, t]))
    y = np.stack(ys, axis=1) + p["D"] * xs
    return (y * silu(z)) @ p["out_proj"], h


def test_chunked_scan_matches_a_float64_recurrence():
    params, x = _params(2), _x(2, 32)
    want, wh = _f64_reference(params, x)
    got, st = tssm.ssm_forward(torch.from_numpy(x), from_numpy(params), TCFG, chunk=8,
                               return_state=True)
    assert _rel(got, want) < F64_RTOL
    assert _rel(st["h"], wh) < F64_RTOL


def test_softplus_is_logaddexp_past_the_cut_over():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere; ``F.softplus``
    returns x itself above 20 (and its gradient 1).  The port's equals the
    reference's on both sides of 20, values and gradients."""
    xs = np.array([-30.0, -5.0, -0.5, 0.0, 0.7, 5.0, 15.0, 19.9, 20.0, 20.1, 25.0, 40.0, 90.0],
                  np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    wgrad = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(xs)))
    tx = torch.from_numpy(xs).requires_grad_()
    got = tssm.softplus(tx)
    (grad,) = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), wgrad, rtol=1e-6, atol=1e-12)
    big = xs >= 20.0
    np.testing.assert_array_equal(got.detach().numpy()[big], want[big])
    # in float64 the difference from the linear cut-over shows: logaddexp
    # keeps log1p(exp(-x)), which F.softplus drops
    x64 = torch.tensor([25.0, 30.0], dtype=torch.float64)
    assert (tssm.softplus(x64) - x64 > 0).all()
    assert torch.equal(torch.nn.functional.softplus(x64), x64)


def test_memory_stays_one_chunk_at_a_time():
    """The decay and input terms are made per chunk: the forward's largest
    (B, C, ds, N) intermediate is one chunk's, whatever S is (checked by the
    autograd graph's saved tensors: none spans the sequence)."""
    params = from_numpy(_params(3))
    S, chunk = 64, 8
    x = torch.from_numpy(_x(3, S))
    seen = []

    def pack(t):
        seen.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tssm.ssm_forward(x.requires_grad_(), {k: v.requires_grad_() for k, v in params.items()},
                         TCFG, chunk=chunk)
    four_d = [s for s in seen if len(s) == 4]
    assert four_d and max(s[1] for s in four_d) <= chunk
