"""Selective SSM (Mamba-style) branch — hymba's parallel heads (the port of
``repro.models.ssm``).

The recurrence ``h_t = a_t * h_{t-1} + b_t x_t`` is diagonal per channel and
state.  It runs chunked, as in the reference: a loop over chunks carries
``h`` while a scan parallelizes within the chunk.  The reference's in-chunk
scan is ``jax.lax.associative_scan``, whose odd/even recursion combines the
elements in a tree order; :func:`_associative_scan` is that recursion in
torch, level for level, so the f32 result rounds as the reference's does
(up to the two libraries' kernels), and no step loops per token in prefill
or training.  Each chunk's ``(B, C, ds, N)`` decay and input terms are made
when the loop reaches it, so only one chunk's scan intermediates are alive
at a time (at hymba's prefill wave a whole-sequence f32 term would take
1.68 GB).  A length that is not a multiple of the chunk runs as one chunk,
as in the reference.

Tensor parallelism (a :class:`~repro_torch.models.layers.TPContext` of
size > 1), the reference's scheme: the inner channels ``d_ssm_inner`` are
column-sharded over the model group (``in_proj`` with its x and z halves
aligned, ``conv_w``/``conv_b``, ``dt_proj``/``dt_bias``, ``A_log``, ``D``),
since the recurrence is diagonal per channel; ``x_proj`` and ``out_proj``
are row-sharded, each followed by one all-reduce.  The state ``h`` and the
conv tail hold the rank's channels.  The joined ``(B, C, dt)`` features
feed the rank's channels through ``copy_in``, so their gradient, and
``x_proj``'s, sum over the group.

``softplus`` is ``jax.nn.softplus``, ``logaddexp(x, 0)``: ``F.softplus``
returns ``x`` itself above its threshold of 20.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..trace import span
from .layers import Initializer, TPContext, linear_init, tp_enabled

Tree = Any

__all__ = ["ssm_init", "ssm_shard_axes", "ssm_forward", "init_ssm_state", "ssm_decode_step",
           "softplus"]

DT_RANK_DIV = 16


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / DT_RANK_DIV))


def ssm_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d, ds, N = cfg.d_model, cfg.d_ssm_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    steps = torch.arange(1, N + 1, dtype=torch.float32, device=init.device)
    return {
        "in_proj": init.normal((d, 2, ds), 1.0 / math.sqrt(d)),
        "conv_w": init.normal((cfg.ssm_conv, ds), 1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": init.zeros((ds,)),
        "x_proj": linear_init(init, ds, r + 2 * N),
        "dt_proj": linear_init(init, r, ds),
        "dt_bias": init.normal((ds,), 0.1),
        "A_log": torch.log(steps).expand(ds, N).contiguous(),
        "D": init.ones((ds,)),
        "out_proj": linear_init(init, ds, d),
    }


def ssm_shard_axes() -> Tree:
    """The axis of each SSM leaf split over the model group, the
    reference's ``ssm_specs``."""
    return {"in_proj": 2, "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
            "A_log": 0, "D": 0, "out_proj": 0}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None):
    """x: (B, S, ds); w: (k, ds) depthwise; tail: (B, k-1, ds) carried state."""
    kk = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], kk - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, kk):
        out = out + xp[:, i:i + S] * w[i][None, None, :]
    new_tail = xp[:, -(kk - 1):] if kk > 1 else tail
    return out + b[None, None, :], new_tail


def _combine(al, bl, ar, br):
    """``(a, b)`` of two steps in sequence: ``(al * ar, ar * bl + br)``."""
    return al * ar, ar * bl + br


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Prefix combine of ``(a, b)`` along axis 1 in ``jax.lax.associative_scan``'s
    order: combine adjacent pairs, scan the half-length sequence (the odd
    outputs), combine each with the next even input, interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _selective_scan_chunk(a, bx, h0):
    """h_t = a_t * h_{t-1} + bx_t within a chunk.  a, bx: (B, C, ds, N);
    h0: (B, ds, N).  Returns (h_all, h_last)."""
    pa, pb = _associative_scan(a, bx)
    h_all = pa * h0[:, None] + pb
    return h_all, h_all[:, -1]


def ssm_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig, *, chunk: int = 128,
                state: Tree | None = None, return_state: bool = False,
                tp: TPContext | None = None):
    """x: (B, S, d) -> (B, S, d); with ``return_state`` also the final
    ``{"h": (B, ds, N), "conv": (B, k-1, ds)}`` (f32), from ``state`` (or zeros).
    With ``tp`` the channel leaves and the state are the rank's ``ds / tp``
    channels (module docstring)."""
    on = tp_enabled(tp)
    with span("ssm_forward"):
        if on:
            x = tp.copy_in(x)
        B, S, _ = x.shape
        dt = x.dtype
        N = cfg.ssm_state
        r = _dt_rank(cfg)
        ds = params["conv_b"].shape[0]

        w = params["in_proj"].to(dt)
        xs = x @ w[:, 0]
        z = x @ w[:, 1]
        xs, new_tail = _causal_conv(xs, params["conv_w"].to(dt), params["conv_b"].to(dt),
                                    state["conv"] if state is not None else None)
        xs = F.silu(xs)

        dbl = xs @ params["x_proj"].to(dt)
        if on:  # the rank's channels' partial (B, C, dt) features, joined
            dbl = tp.copy_in(tp.reduce_out(dbl))
        dbl = dbl.to(torch.float32)
        dt_lr, Bc, Cc = torch.split(dbl, [r, N, N], dim=-1)
        delta = softplus(dt_lr @ params["dt_proj"].to(torch.float32)
                         + params["dt_bias"].to(torch.float32))  # (B, S, ds)
        A = -torch.exp(params["A_log"].to(torch.float32))  # (ds, N)
        dx = delta * xs.to(torch.float32)

        h = (state["h"].to(torch.float32) if state is not None
             else torch.zeros((B, ds, N), dtype=torch.float32, device=x.device))
        ck = min(chunk, S)
        if S % ck != 0:
            ck = S
        ys = []
        for c0 in range(0, S, ck):
            sl = slice(c0, c0 + ck)
            a = torch.exp(delta[:, sl, :, None] * A[None, None])  # (B, ck, ds, N)
            bx = dx[:, sl, :, None] * Bc[:, sl, None, :]
            h_all, h = _selective_scan_chunk(a, bx, h)
            del a, bx
            ys.append(torch.matmul(h_all, Cc[:, sl, :, None])[..., 0])  # (B, ck, ds)
            del h_all
        y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
        y = y + params["D"].to(torch.float32)[None, None] * xs.to(torch.float32)
        y = y.to(dt) * F.silu(z)
        out = y @ params["out_proj"].to(dt)
        if on:
            out = tp.reduce_out(out)
    if return_state:
        return out, {"h": h, "conv": new_tail.to(torch.float32)}
    return out


def init_ssm_state(cfg: ModelConfig, n_layers: int, batch: int, device=None,
                   tp: int = 1) -> Tree:
    """Zero states; at tp > 1 the rank's channels (all of them where ``tp``
    does not divide ``d_ssm_inner``, as in the reference)."""
    ds = cfg.d_ssm_inner
    ds = ds // tp if ds % tp == 0 else ds
    return {
        "h": torch.zeros((n_layers, batch, ds, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, ds), dtype=torch.float32,
                            device=device),
    }


def ssm_decode_step(x: torch.Tensor, params: Tree, state_layer: Tree, cfg: ModelConfig,
                    tp: TPContext | None = None):
    """x: (B, 1, d); state_layer: {'h': (B, ds, N), 'conv': (B, k-1, ds)}.
    Returns ``(y, new_state)``."""
    return ssm_forward(x, params, cfg, chunk=1, state=state_layer, return_state=True, tp=tp)
