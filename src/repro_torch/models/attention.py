"""Attention (the port of ``repro.models.attention`` at tensor-parallel
degree 1): the train/prefill forward, the serve KV cache and the one-token
decode step.

``attention_core`` takes the unexpanded kv ``(B, Sk, Hkv, hd)``.  Its
``impl="torch"`` branch is the reference's ``jnp`` path
(``_masked_attention_traced_window``) as plain torch matmul and softmax over
kv expanded to the query heads; the JAX trainer computes it outside any
Pallas kernel too.  The reference splits queries into 512-row blocks to
bound its live score matrix; each row's math is independent of that split,
so the port computes all rows at once.  ``impl="cuda"`` is the reference's
``pallas`` branch: the flash-attention kernel, which does GQA itself (its
plain version on a CPU tensor).

Cross-attention (the encoder-decoder's, ``kv_source``) projects k and v
from the encoder's output and attends non-causally over all of it; RoPE
never touches cross k.  With ``impl="cuda"`` it goes through the same
flash kernel at Sq != Sk.

Decode is the reference's split-K softmax at tp = 1 in plain torch: the new
token's k/v go into slot ``t % capacity`` of the cache (a rolling buffer
when the capacity is a sliding window), and the scores run over the whole
cache, masked by each slot's stored position.  A decoder token's
cross-attention over the cached encoder k/v (:func:`attn_cross_decode`) is
a plain f32 softmax, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .layers import Initializer, apply_rope, linear_init, rms_norm

Tree = Any

__all__ = [
    "ATTN_IMPLS",
    "attn_init",
    "attn_forward",
    "attention_core",
    "attn_cross_decode",
    "attn_decode_step",
    "group_index",
    "init_kv_cache",
]

NEG_INF = -1e30
ATTN_IMPLS = ("torch", "cuda")


def attn_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": linear_init(init, d, cfg.n_heads * hd),
        "wk": linear_init(init, d, cfg.n_kv_heads * hd),
        "wv": linear_init(init, d, cfg.n_kv_heads * hd),
        "wo": linear_init(init, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.zeros((hd,))
        p["k_norm"] = init.zeros((hd,))
    return p


def group_index(n_heads: int, n_kv: int, device=None) -> torch.Tensor:
    """(n_heads,) GQA map: q head ``h`` reads kv head ``h // (H / KV)``."""
    q_per_kv = max(n_heads // n_kv, 1)
    return torch.clamp(torch.arange(n_heads, device=device) // q_per_kv, 0, n_kv - 1)


def _group_full(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd): kv expanded to the query heads."""
    return k[:, :, group_index(n_heads, k.shape[2], k.device)]


def attention_core(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                   impl: str = "torch"):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd), unexpanded.  Scores and
    softmax in f32.  Returns (B, Sq, H, hd)."""
    if impl == "cuda":
        if softcap > 0.0:
            # the reference's Pallas branch drops softcap silently; refuse it
            raise NotImplementedError(
                "attn_impl='cuda' does not apply logit_softcap; use attn_impl='torch'"
            )
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl != "torch":
        raise ValueError(f"unknown attn_impl {impl!r}; one of {ATTN_IMPLS}")
    H = q.shape[2]
    k, v = _group_full(k, H), _group_full(v, H)
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _project(x, params, cfg: ModelConfig, positions, kv_source=None):
    """q (B, S, H, hd) and k, v (B, Sk, KV, hd), normed and rotated; k and v
    from ``kv_source`` (B, Sk, d) where given (cross-attention: k is not
    rotated), else from ``x``."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    src = x if kv_source is None else kv_source.to(dt)
    Sk = src.shape[1]
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (src @ params["wk"].to(dt)).reshape(B, Sk, KV, hd)
    v = (src @ params["wv"].to(dt)).reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_source is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(
    x: torch.Tensor,
    params: Tree,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    attn_impl: str = "torch",
    return_kv: bool = False,
    kv_source: torch.Tensor | None = None,
):
    """x: (B, S, d) -> (B, S, d); with ``return_kv`` also this layer's
    ``(k, v)``, each (B, Sk, KV, hd), for the serve cache.  ``kv_source``
    (B, Sk, d) makes it cross-attention: k and v are projected from it."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _project(x, params, cfg, positions, kv_source)
    out = attention_core(q, k, v, causal=causal, window=window,
                         softcap=cfg.logit_softcap, impl=attn_impl)
    y = out.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"].to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Decode: the KV cache and the one-token step
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, capacity: int,
                  dtype=torch.bfloat16, device=None) -> Tree:
    """Layer-stacked cache: k/v ``(n_layers, batch, capacity, KV, hd)`` and
    ``pos`` ``(n_layers, batch, capacity)``, each slot's absolute position
    (-1 = empty), so rolling windows and masking are explicit."""
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_layers, batch, capacity), -1, dtype=torch.int32, device=device),
    }


def attn_decode_step(
    x: torch.Tensor,
    params: Tree,
    cache_layer: Tree,
    cfg: ModelConfig,
    *,
    t: torch.Tensor,
    window: int = 0,
    grouped: bool = False,
):
    """One-token decode.  x: (B, 1, d); ``t``: the new token's absolute
    position, (B,) int (one per slot).  ``cache_layer``: this layer's
    ``{"k", "v"}`` (B, capacity, KV, hd) and ``"pos"`` (B, capacity), updated
    **in place** (slot ``t % capacity`` takes the new k/v and position ``t``).
    ``grouped`` scores q-head groups against the raw cache instead of a
    kv copy expanded to H heads.  Returns ``(y, cache_layer)``."""
    B = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per slot, got x {tuple(x.shape)}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    t = t.to(device=x.device, dtype=torch.long)
    q, k, v = _project(x, params, cfg, t[:, None])

    ck, cv, cpos = cache_layer["k"], cache_layer["v"], cache_layer["pos"]
    slot = t % ck.shape[1]
    rows = torch.arange(B, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = t.to(cpos.dtype)

    valid = (cpos >= 0) & (cpos <= t[:, None])
    if window > 0:
        valid &= t[:, None] - cpos < window
    scale = 1.0 / math.sqrt(hd)
    softcap = cfg.logit_softcap
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
    if grouped and H % KV == 0:
        # contract q-head groups against the raw cache: no (H/KV)-times copy
        gp = H // KV
        qg = q.reshape(B, 1, KV, gp, hd)
        s = torch.einsum("bqegd,bked->begqk", qg, ck.to(dt)).to(torch.float32) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, None, :], s, neg).reshape(B, H, 1, -1)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, _group_full(ck.to(dt), H)).to(torch.float32)
        s = s * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, :], s, neg)
    m = torch.amax(s, dim=-1)  # (B, H, 1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # (B, H, 1)
    if grouped and H % KV == 0:
        pg = p.reshape(B, KV, gp, 1, -1)
        o = torch.einsum("begqk,bked->bqegd", pg.to(dt), cv.to(dt))
        o = o.reshape(B, 1, H, hd).to(torch.float32)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), _group_full(cv.to(dt), H))
        o = o.to(torch.float32)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    y = out.reshape(B, 1, H * hd).to(dt) @ params["wo"].to(dt)
    return y, cache_layer


def attn_cross_decode(x: torch.Tensor, params: Tree, cross_kv: Tree, cfg: ModelConfig):
    """Decode-time cross-attention of x (B, 1, d) over the cached encoder
    ``cross_kv`` ``{"k", "v"}`` (B, T_enc, KV, hd): no rope, no mask, a plain
    f32 softmax (the reference's, not the kernel).  Returns (B, 1, d)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, 1, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
    kf = _group_full(cross_kv["k"].to(dt), H)
    vf = _group_full(cross_kv["v"].to(dt), H)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf).to(torch.float32) * (1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vf.dtype), vf)
    return out.reshape(B, 1, H * hd) @ params["wo"].to(dt)
