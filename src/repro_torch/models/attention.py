"""Attention, train path (the port of ``repro.models.attention`` at tensor-
parallel degree 1).

``attention_core`` is the reference's ``jnp`` path
(``_masked_attention_traced_window``) as plain torch matmul and softmax; the
JAX trainer computes it outside any Pallas kernel too.  The reference
splits queries into 512-row blocks to bound its live score matrix; each
row's math is independent of that split, so the port computes all rows at
once.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from .layers import Initializer, apply_rope, linear_init, rms_norm

Tree = Any

__all__ = ["attn_init", "attn_forward", "attention_core", "group_index"]

NEG_INF = -1e30


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


def attention_core(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, H, hd) — kv already expanded to H
    heads.  Scores and softmax in f32.  Returns (B, Sq, H, hd)."""
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


def attn_forward(
    x: torch.Tensor,
    params: Tree,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    g = group_index(H, KV, x.device)
    out = attention_core(
        q, k[:, :, g], v[:, :, g], causal=causal, window=window,
        softcap=cfg.logit_softcap,
    )
    return out.reshape(B, S, H * hd) @ params["wo"].to(dt)
