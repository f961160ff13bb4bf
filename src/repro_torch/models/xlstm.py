"""xLSTM blocks (the port of ``repro.models.xlstm``): mLSTM (matrix
memory) and sLSTM (scalar memory).

mLSTM (pre-up-projection variant, xLSTM paper Fig. 9 left): the residual
stream is up-projected by ``proj_factor``; q/k/v and the exponential gates
are computed in the inner space; the chunk-parallel cell runs per head
(``impl="cuda"``: the ``mlstm_chunk`` kernel, :func:`..kernels.mlstm_chunk.mlstm`;
``"torch"``: its plain version); a gated (SiLU) skip branch modulates the
output before the down-projection.  With a carried state (decode) the cell
is always the plain chunk math, as in the reference.

sLSTM: a strictly recurrent scalar-memory cell in plain torch, one step per
token; the input projection ``wx`` is computed for all tokens before the
time loop, as the reference computes it.  The reference scans it in
rematerialized chunks of 256 steps; the port's forward loops over the steps
(the chunking only bounds the reference's backward memory).  On meta
tensors (the dry run) the loop is traced as one step that the cost model
counts once per token (:class:`_MetaRecurrence`), as the reference's cost
walk multiplies its scan body by the trip count.

Tensor parallelism (a :class:`~repro_torch.models.layers.TPContext` of
size > 1), the reference's scheme: mLSTM shards its value dimension over
the model group (``wv`` and the skip ``gate`` on their last axis, ``down``
on its ``dh`` rows), so the matrix memory ``C`` holds a rank's ``dv / tp``
columns; ``up``, q, k and the gates stay replicated (the key dimension
enters every state contraction), and one all-reduce follows ``down``.  q,
k and the gates enter the rank's cell through ``copy_in`` (the cell reads
them for the rank's columns only, so their gradients sum over the group),
and so do the inputs of ``wv`` and ``gate``.  sLSTM blocks stay
replicated: every rank runs the same recurrence, with no collective.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mlstm_chunk import mlstm as mlstm_op
from ..launch.costmodel import trips
from ..kernels.mlstm_chunk.ref import mlstm_chunked
from ..trace import span
from .layers import Initializer, TPContext, linear_init, tp_enabled

Tree = Any

__all__ = [
    "MLSTM_IMPLS",
    "mlstm_init",
    "mlstm_shard_axes",
    "mlstm_forward",
    "init_mlstm_state",
    "mlstm_decode_step",
    "slstm_init",
    "slstm_forward",
    "init_slstm_state",
    "slstm_decode_step",
]

MLSTM_IMPLS = ("torch", "cuda")


def _inner(cfg: ModelConfig) -> int:
    return int(cfg.proj_factor * cfg.d_model)


def _head_dims(cfg: ModelConfig) -> tuple[int, int]:
    di = _inner(cfg)
    if di % cfg.n_heads:
        raise ValueError(f"inner width {di} does not split over {cfg.n_heads} heads")
    return cfg.n_heads, di // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    di = _inner(cfg)
    H, dh = _head_dims(cfg)
    return {
        "up": linear_init(init, d, di),
        "gate": init.normal((d, H, dh), 1.0 / math.sqrt(d)),
        "wq": init.normal((di, H, dh), 1.0 / math.sqrt(di)),
        "wk": init.normal((di, H, dh), 1.0 / math.sqrt(di)),
        "wv": init.normal((di, H, dh), 1.0 / math.sqrt(di)),
        "w_i": linear_init(init, di, cfg.n_heads),
        "w_f": linear_init(init, di, cfg.n_heads),
        "f_bias": init.ones((cfg.n_heads,)) * 3.0,  # open forget gates at init
        "down": init.normal((H, dh, d), 1.0 / math.sqrt(di)),
    }


def mlstm_shard_axes() -> Tree:
    """The axis of each mLSTM leaf split over the model group (None:
    replicated), the reference's ``mlstm_specs``."""
    return {"up": None, "gate": 2, "wq": None, "wk": None, "wv": 2, "w_i": None,
            "w_f": None, "f_bias": None, "down": 1}


def _heads(xi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, di) x (di, H, dh) -> (B, H, S, dh): one matmul, viewed per head
    (dh stays contiguous, as the kernel reads it)."""
    B, S, _ = xi.shape
    H, dh = w.shape[1], w.shape[2]
    return (xi @ w.reshape(w.shape[0], H * dh)).reshape(B, S, H, dh).transpose(1, 2)


def mlstm_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig, *, chunk: int = 128,
                  impl: str = "torch", state: Tree | None = None, return_state: bool = False,
                  tp: TPContext | None = None):
    """x: (B, S, d) -> (B, S, d); with ``return_state`` also the cell's final
    ``{"C", "n", "m"}``.  With ``tp`` the value leaves are the rank's shards
    and ``C`` its ``dv / tp`` columns (module docstring)."""
    if impl not in MLSTM_IMPLS:
        raise ValueError(f"unknown mlstm_impl {impl!r}; one of {MLSTM_IMPLS}")
    on = tp_enabled(tp)
    cp = tp.copy_in if on else (lambda t: t)
    dt = x.dtype
    S = x.shape[1]
    xi = x @ params["up"].to(dt)  # (B, S, di)
    q = cp(_heads(xi, params["wq"].to(dt)))
    k = cp(_heads(xi, params["wk"].to(dt)))
    v = _heads(cp(xi), params["wv"].to(dt))  # (B, H, S, dv / tp)
    i_raw = cp((xi @ params["w_i"].to(dt)).to(torch.float32).transpose(1, 2))  # (B, H, S)
    f_raw = cp(((xi @ params["w_f"].to(dt)).to(torch.float32)
                + params["f_bias"].to(torch.float32)).transpose(1, 2))

    if state is None and impl == "cuda":
        h, new_state = mlstm_op(q, k, v, i_raw, f_raw, chunk=chunk)
    else:
        h, new_state = mlstm_chunked(q, k, v, i_raw, f_raw, state=state, chunk=min(chunk, S))
    hh = h.to(dt).transpose(1, 2)  # (B, S, H, dv / tp)

    # gated skip: the gate (d, H, dh) is aligned with h's heads (and columns)
    g = torch.einsum("bsd,dhe->bshe", cp(x), params["gate"].to(dt))
    hh = hh * F.silu(g)
    out = torch.einsum("bshe,hed->bsd", hh, params["down"].to(dt))
    if on:
        out = tp.reduce_out(out)
    if return_state:
        return out, new_state
    return out


def init_mlstm_state(cfg: ModelConfig, n_layers: int, batch: int, device=None,
                     tp: int = 1) -> Tree:
    """Zero states; at tp > 1 ``C`` holds a rank's ``dv / tp`` columns (all
    of them where ``tp`` does not divide ``dh``, as in the reference)."""
    H, dh = _head_dims(cfg)
    dv = dh // tp if dh % tp == 0 else dh
    return {
        "C": torch.zeros((n_layers, batch, H, dh, dv), dtype=torch.float32, device=device),
        "n": torch.zeros((n_layers, batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.zeros((n_layers, batch, H), dtype=torch.float32, device=device),
    }


def mlstm_decode_step(x: torch.Tensor, params: Tree, state_layer: Tree, cfg: ModelConfig,
                      tp: TPContext | None = None):
    """One token per row: x (B, 1, d) and this layer's state -> (y, new state)."""
    return mlstm_forward(x, params, cfg, chunk=1, state=state_layer, return_state=True, tp=tp)


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, strictly recurrent)
# ---------------------------------------------------------------------------


def slstm_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "w_zifo": init.normal((d, 4 * d), 1.0 / math.sqrt(d)),
        "r_zifo": init.normal((H, dh, 4 * dh), 1.0 / math.sqrt(dh)),
        "b_zifo": init.zeros((4 * d,)),
        "out": linear_init(init, d, d),
    }


def _slstm_cell(carry, wx, r_zifo, H: int, dh: int):
    """carry: (c, n, m, h_prev), each (B, d); wx: (B, 4d) f32."""
    c, n, m, h_prev = carry
    B = c.shape[0]
    rec = torch.einsum("bhe,hef->bhf", h_prev.reshape(B, H, dh), r_zifo)  # (B, H, 4 dh)
    # realign per-head [z|i|f|o] blocks with wx's global [z(d)|i(d)|f(d)|o(d)]
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * H * dh)
    z, i_raw, f_raw, o_raw = torch.chunk((wx + rec).to(torch.float32), 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    ip = torch.exp(i_raw - m_new)
    fp = torch.exp(logf + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h)


class _MetaRecurrence(torch.autograd.Function):
    """The sLSTM time loop on meta tensors: one step stands for all ``S``
    (under :func:`~repro_torch.launch.costmodel.trips`, forward and
    backward, which recomputes the step as the reference's rematerialized
    chunks do), the hidden states ``(B, S, d)`` stacked from it."""

    @staticmethod
    def forward(ctx, wx, r, c, n, m, h, H, dh):
        ctx.save_for_backward(wx[:, 0], r, c, n, m, h)
        ctx.heads, ctx.steps = (H, dh), wx.shape[1]
        with trips(ctx.steps):
            carry = _slstm_cell((c, n, m, h), wx[:, 0], r, H, dh)
        return (torch.stack([carry[3]] * ctx.steps, dim=1), *carry)

    @staticmethod
    def backward(ctx, g_hs, *g_carry):
        wx0, *ins = ctx.saved_tensors
        ins = [t.detach().requires_grad_() for t in (wx0, *ins)]
        with torch.enable_grad(), trips(ctx.steps):
            carry = _slstm_cell(tuple(ins[2:]), ins[0], ins[1], *ctx.heads)
            grads = torch.autograd.grad(carry, ins, [*g_carry[:3], g_hs[:, 0] + g_carry[3]],
                                        allow_unused=True)
        g_wx = grads[0].unsqueeze(1).expand(-1, ctx.steps, -1)
        return (g_wx, *grads[1:], None, None)


def slstm_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig, *,
                  state: Tree | None = None, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d); with ``return_state`` also the final
    ``{"c", "n", "m", "h"}``."""
    B, S, d = x.shape
    dt = x.dtype
    H = cfg.n_heads
    dh = d // H
    wx = (x @ params["w_zifo"].to(dt) + params["b_zifo"].to(dt)).to(torch.float32)
    r = params["r_zifo"].to(torch.float32)
    if state is None:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = (state["c"], state["n"], state["m"], state["h"])
    if x.device.type == "meta":
        h, *carry = _MetaRecurrence.apply(wx, r, *carry, H, dh)
        h = h.to(dt)
    else:
        hs = []
        # a named span for the profiler: the recurrence is many small launches
        with span("slstm_recurrence"):
            for t in range(S):
                carry = _slstm_cell(carry, wx[:, t], r, H, dh)
                hs.append(carry[3])
        h = torch.stack(hs, dim=1).to(dt)
    out = h @ params["out"].to(dt)
    if return_state:
        c, n, m, hlast = carry
        return out, {"c": c, "n": n, "m": m, "h": hlast}
    return out


def init_slstm_state(cfg: ModelConfig, n_layers: int, batch: int, device=None) -> Tree:
    shape = (n_layers, batch, cfg.d_model)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device) for k in "cnmh"}


def slstm_decode_step(x: torch.Tensor, params: Tree, state_layer: Tree, cfg: ModelConfig):
    """One token per row: x (B, 1, d) and this layer's state -> (y, new state)."""
    return slstm_forward(x, params, cfg, state=state_layer, return_state=True)
