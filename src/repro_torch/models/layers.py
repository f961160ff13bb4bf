"""Shared layers of the decoder LMs (the port of ``repro.models.layers`` at
tensor-parallel degree 1).

Parameters are plain nested dicts of tensors with the JAX package's paths
and layouts: a linear weight is ``(d_in, d_out)`` and is applied as
``x @ w``.  Norm scales are stored as offsets from 1 (``x * (1 + scale)``),
as in the reference.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Tree = Any

__all__ = [
    "Initializer",
    "rms_norm",
    "layer_norm",
    "norm_init",
    "norm_apply",
    "rope_freqs",
    "apply_rope",
    "linear_init",
    "mlp_init",
    "mlp_apply",
    "embedding_init",
    "embed_lookup",
    "lm_head_logits",
    "softmax_xent_sharded",
]


class Initializer:
    """Deterministic param init: truncated-normal (+-2 sigma) fan-in scaling,
    drawn from one explicit ``torch.Generator``.  Same shapes and scales as
    the JAX initializer; the numbers differ (the two RNGs never agree)."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device

    def normal(self, shape, scale: float, dtype=torch.float32) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return t.mul_(scale).to(dtype)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.to(torch.float32))
    return x.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * (1.0 + scale.to(torch.float32))
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def norm_init(init: Initializer, norm_type: str, d: int) -> Tree:
    if norm_type == "rmsnorm":
        return {"scale": init.zeros((d,))}
    if norm_type == "layernorm":
        return {"scale": init.zeros((d,)), "bias": init.zeros((d,))}
    if norm_type == "nonparametric_ln":  # OLMo: no affine params, an empty subtree
        return {}
    raise ValueError(norm_type)


def norm_apply(x: torch.Tensor, params: Tree, norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    if norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if norm_type == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# RoPE (half-split: the first and second halves of hd rotate as pairs)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear / MLP
# ---------------------------------------------------------------------------


def linear_init(init: Initializer, d_in: int, d_out: int, *, scale: float | None = None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), s)


_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(init: Initializer, d: int, f: int, gated: bool) -> Tree:
    p = {
        "w_in": linear_init(init, d, f),
        "w_out": linear_init(init, f, d),
    }
    if gated:
        p["w_gate"] = linear_init(init, d, f)
    return p


def mlp_apply(x: torch.Tensor, params: Tree, act: str) -> torch.Tensor:
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    if "w_gate" in params:
        g = x @ params["w_gate"].to(dt)
        h = _ACTS[act](g) * h
    else:
        h = _ACTS[act](h)
    return h @ params["w_out"].to(dt)


# ---------------------------------------------------------------------------
# Embedding + LM head / loss
# ---------------------------------------------------------------------------


def embedding_init(init: Initializer, vocab_padded: int, d: int) -> Tree:
    return {"table": init.normal((vocab_padded, d), 0.02)}


def embed_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), table)


def lm_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d); w: (d, V) -> logits (..., V)."""
    return x @ w.to(x.dtype)


def softmax_xent_sharded(logits: torch.Tensor, targets: torch.Tensor, *,
                         vocab_size: int) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (T, Vp) against ``targets`` (T,).

    Padded vocab columns (``>= vocab_size``) are masked to -1e30 and the max
    shift carries no gradient, as in the reference (there summed over the
    vocab-sharded model axis; here tp = 1)."""
    lg = logits.to(torch.float32)
    valid = torch.arange(lg.shape[-1], device=lg.device) < vocab_size
    lg = torch.where(valid, lg, torch.full((), -1e30, dtype=lg.dtype, device=lg.device))
    mx = torch.amax(lg, dim=-1, keepdim=True).detach()
    lg = lg - mx
    sumexp = torch.sum(torch.exp(lg), dim=-1)
    label_logit = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = torch.log(sumexp) - label_logit
    return torch.sum(nll) / float(nll.numel())
