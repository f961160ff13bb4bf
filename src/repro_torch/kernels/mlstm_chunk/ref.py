"""Plain version of the chunked mLSTM kernel (the port of
``repro/kernels/mlstm_chunk/ref.py``): the xLSTM matrix-memory cell with an
exponential input gate, a log-sigmoid forget gate and the max-stabilizer
``m``.

* :func:`mlstm_sequential` — the cell step by step (the xLSTM paper's eqs.
  19-27); the ground truth, for tests.
* :func:`mlstm_chunked` — the chunk-parallel form the CUDA kernel computes:
  within a chunk a decay-masked (C x C) attention, across chunks the carried
  state ``(C, n, m)``.  What :func:`..ops.mlstm` computes for tensors that
  lie on the CPU, and what the kernel is held against on the card.
* :func:`mlstm_decode_step` — one token (a chunk of length 1).

All return ``(h, {"C", "n", "m"})``; the stabilizer algebra is f32, masked
decays are ``NEG_INF`` (never ``-inf``) and ``m`` starts at 0, as in the
reference.  Float64 inputs are computed in float64 throughout: the witness
the kernel and the f32 plain version are both held against where the
normalizer cancels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

__all__ = ["NEG_INF", "init_state", "mlstm_sequential", "mlstm_chunked", "mlstm_decode_step"]


def init_state(batch: int, heads: int, dk: int, dv: int, device=None,
               dtype=torch.float32) -> dict:
    return {
        "C": torch.zeros((batch, heads, dk, dv), dtype=dtype, device=device),
        "n": torch.zeros((batch, heads, dk), dtype=dtype, device=device),
        "m": torch.zeros((batch, heads), dtype=dtype, device=device),
    }


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(q.dtype, torch.float32)


def _zero_state(q: torch.Tensor, v: torch.Tensor) -> dict:
    B, H, _, dk = q.shape
    return init_state(B, H, dk, v.shape[-1], q.device, _compute_dtype(q))


def mlstm_sequential(q, k, v, i_raw, f_raw, state=None):
    """q/k: (B, H, S, dk); v: (B, H, S, dv); gates: (B, H, S)."""
    dk = q.shape[-1]
    ct = _compute_dtype(q)
    if state is None:
        state = _zero_state(q, v)
    scale = 1.0 / math.sqrt(dk)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[2]):
        qt = q[:, :, t].to(ct) * scale
        kt = k[:, :, t].to(ct)
        vt = v[:, :, t].to(ct)
        it = i_raw[:, :, t].to(ct)
        logf = F.logsigmoid(f_raw[:, :, t].to(ct))
        m_new = torch.maximum(logf + m, it)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(it - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=2).to(v.dtype)
    return h, {"C": C, "n": n, "m": m}


def _chunk_body(q, k, v, i_raw, f_raw, C_prev, n_prev, m_prev, cumsum=torch.cumsum):
    """One chunk, vectorized.  q/k: (..., L, dk); v: (..., L, dv); gates
    (..., L); state (..., dk, dv) / (..., dk) / (...).  ``cumsum(x, dim)``
    forms the prefix sums b of log f (the order of its f32 additions moves
    h where the normalizer cancels; a caller may pass another order)."""
    dk = q.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    ct = _compute_dtype(q)
    qf = q.to(ct) * scale
    kf = k.to(ct)
    vf = v.to(ct)
    it = i_raw.to(ct)
    logf = F.logsigmoid(f_raw.to(ct))
    b = cumsum(logf, dim=-1)  # (..., L) inclusive

    L = q.shape[-2]
    tril = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    # decay(t, s) = b_t - b_s + i_s for s <= t
    decay = b[..., :, None] - b[..., None, :] + it[..., None, :]
    decay = torch.where(tril, decay, torch.full((), NEG_INF, device=q.device))

    m_intra = torch.amax(decay, dim=-1)  # (..., L)
    m_t = torch.maximum(m_intra, b + m_prev[..., None])
    D = torch.exp(decay - m_t[..., None])  # masked entries underflow to 0

    att = torch.einsum("...tk,...sk->...ts", qf, kf)
    w = att * D
    inter = torch.exp(b + m_prev[..., None] - m_t)  # (..., L)
    num = torch.einsum("...ts,...sv->...tv", w, vf)
    num = num + inter[..., None] * torch.einsum("...tk,...kv->...tv", qf, C_prev)
    den = torch.sum(w, dim=-1) + inter * torch.einsum("...tk,...k->...t", qf, n_prev)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # ---- carry ----
    bC = b[..., -1:]
    M = torch.maximum((bC + m_prev[..., None])[..., 0], torch.amax(bC - b + it, dim=-1))
    k_scale = torch.exp(bC - b + it - M[..., None])  # (..., L)
    old = torch.exp(bC[..., 0] + m_prev - M)
    ks = kf * k_scale[..., None]
    C_new = old[..., None, None] * C_prev + torch.einsum("...sk,...sv->...kv", ks, vf)
    n_new = old[..., None] * n_prev + torch.sum(ks, dim=-2)
    return h, C_new, n_new, M


def mlstm_chunked(q, k, v, i_raw, f_raw, state=None, *, chunk: int = 64,
                  cumsum=torch.cumsum):
    """Chunk-parallel mLSTM; the same output as :func:`mlstm_sequential`.
    ``S`` must be a multiple of ``chunk``; ``cumsum`` as in
    :func:`_chunk_body`."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    if state is None:
        state = _zero_state(q, v)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, C, n, m = _chunk_body(q[:, :, sl], k[:, :, sl], v[:, :, sl], i_raw[:, :, sl],
                                 f_raw[:, :, sl], C, n, m, cumsum)
        hs.append(h)
    h = torch.cat(hs, dim=2).reshape(B, H, S, dv).to(v.dtype)
    return h, {"C": C, "n": n, "m": m}


def mlstm_decode_step(q, k, v, i_raw, f_raw, state):
    """One token: q/k (B, H, dk), v (B, H, dv), gates (B, H); constant memory."""
    h, C, n, m = _chunk_body(q[..., None, :], k[..., None, :], v[..., None, :],
                             i_raw[..., None], f_raw[..., None],
                             state["C"], state["n"], state["m"])
    return h[..., 0, :], {"C": C, "n": n, "m": m}
