"""Plain version of the flash-attention kernel (the port of
``repro/kernels/flash_attention/ref.py``).

Materializes the full ``(Sq, Sk)`` score matrix in f32: the ground truth
the CUDA kernel is held against, and what :func:`..ops.flash_attention`
computes for tensors that lie on the CPU.  A row whose keys are all masked
gets the uniform softmax (every score is ``NEG_INF``), as in the reference.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

__all__ = ["reference_attention"]


def reference_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    H, hd = q.shape[2], q.shape[3]
    Hkv, Sq, Sk = k.shape[2], q.shape[1], k.shape[1]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    g = H // Hkv
    kf = torch.repeat_interleave(k, g, dim=2).to(torch.float32)
    vf = torch.repeat_interleave(v, g, dim=2).to(torch.float32)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
