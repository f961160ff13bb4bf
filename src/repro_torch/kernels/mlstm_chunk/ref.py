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
* :func:`mlstm_chunk_gates` and :func:`mlstm_chunk_states` — the chunked
  form's gate scan and chunk-state recurrence on their own, as the CUDA
  kernel's first two passes compute them (to tell which pass is at fault).

The first three return ``(h, {"C", "n", "m"})``; the stabilizer algebra is f32, masked
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

__all__ = ["NEG_INF", "init_state", "mlstm_chunk_gates", "mlstm_chunk_states", "mlstm_chunked",
           "mlstm_decode_step", "mlstm_sequential"]


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


def _gate_terms(i_raw, f_raw, m_prev, ct, cumsum=torch.cumsum):
    """The stabilizer terms of one chunk, functions of the gates alone:
    gates (..., L), ``m_prev`` (...), computed in ``ct``.  Returns b (the
    prefix sums of log f), the masked decay (..., L, L), its row max m_t,
    inter, the carry's M, the key scales and old."""
    it = i_raw.to(ct)
    logf = F.logsigmoid(f_raw.to(ct))
    b = cumsum(logf, dim=-1)  # (..., L) inclusive

    L = it.shape[-1]
    tril = torch.ones((L, L), dtype=torch.bool, device=it.device).tril()
    # decay(t, s) = b_t - b_s + i_s for s <= t
    decay = b[..., :, None] - b[..., None, :] + it[..., None, :]
    decay = torch.where(tril, decay, torch.full((), NEG_INF, device=it.device))

    m_intra = torch.amax(decay, dim=-1)  # (..., L)
    m_t = torch.maximum(m_intra, b + m_prev[..., None])
    inter = torch.exp(b + m_prev[..., None] - m_t)  # (..., L)
    bC = b[..., -1:]
    M = torch.maximum((bC + m_prev[..., None])[..., 0], torch.amax(bC - b + it, dim=-1))
    k_scale = torch.exp(bC - b + it - M[..., None])  # (..., L)
    old = torch.exp(bC[..., 0] + m_prev - M)
    return {"b": b, "decay": decay, "m_t": m_t, "inter": inter, "M": M, "k_scale": k_scale,
            "old": old}


def _carry(kf, vf, g, C_prev, n_prev):
    """The state after the chunk: C = old * C_prev + (k * k_scale)^T v and
    n = old * n_prev + sum_s k * k_scale, from :func:`_gate_terms`' ``g``."""
    ks = kf * g["k_scale"][..., None]
    C_new = g["old"][..., None, None] * C_prev + torch.einsum("...sk,...sv->...kv", ks, vf)
    n_new = g["old"][..., None] * n_prev + torch.sum(ks, dim=-2)
    return C_new, n_new


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
    g = _gate_terms(i_raw, f_raw, m_prev, ct, cumsum)
    m_t, inter = g["m_t"], g["inter"]
    D = torch.exp(g["decay"] - m_t[..., None])  # masked entries underflow to 0

    att = torch.einsum("...tk,...sk->...ts", qf, kf)
    w = att * D
    num = torch.einsum("...ts,...sv->...tv", w, vf)
    num = num + inter[..., None] * torch.einsum("...tk,...kv->...tv", qf, C_prev)
    den = torch.sum(w, dim=-1) + inter * torch.einsum("...tk,...k->...t", qf, n_prev)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    C_new, n_new = _carry(kf, vf, g, C_prev, n_prev)
    return h, C_new, n_new, g["M"]


def mlstm_chunk_gates(i_raw, f_raw, *, chunk: int, cumsum=torch.cumsum):
    """The gate scan of the chunked form from a zero state (the CUDA
    kernel's first pass): gates (B, H, S) in float32.  Returns float32 "b",
    "m_t", "inter", "k_scale" (B, H, S) (b restarts at each chunk) and "old",
    "M" (B, H, S // chunk), M being m after each chunk."""
    B, H, S = i_raw.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    ct = _compute_dtype(i_raw)
    m = torch.zeros((B, H), dtype=ct, device=i_raw.device)
    out = {key: [] for key in ("b", "m_t", "inter", "k_scale", "old", "M")}
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        g = _gate_terms(i_raw[:, :, sl], f_raw[:, :, sl], m, ct, cumsum)
        for key in out:
            out[key].append(g[key])
        m = g["M"]
    return {key: torch.cat(vals, dim=2) if vals[0].ndim == 3 else torch.stack(vals, dim=2)
            for key, vals in out.items()}


def mlstm_chunk_states(k, v, i_raw, f_raw, *, chunk: int, cumsum=torch.cumsum):
    """The chunk-state recurrence from a zero state (the CUDA kernel's
    second pass): k (B, H, S, dk), v (B, H, S, dv), gates (B, H, S).
    Returns "C" (B, H, S // chunk, dk, dv) and "n" (B, H, S // chunk, dk),
    the state after each chunk (the last is :func:`mlstm_chunked`'s final
    state), in the compute dtype."""
    B, H, S, dk = k.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    ct = _compute_dtype(k)
    st = init_state(B, H, dk, v.shape[-1], k.device, ct)
    C, n, m = st["C"], st["n"], st["m"]
    Cs, ns = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        g = _gate_terms(i_raw[:, :, sl], f_raw[:, :, sl], m, ct, cumsum)
        C, n = _carry(k[:, :, sl].to(ct), v[:, :, sl].to(ct), g, C, n)
        m = g["M"]
        Cs.append(C)
        ns.append(n)
    return {"C": torch.stack(Cs, dim=2), "n": torch.stack(ns, dim=2)}


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
