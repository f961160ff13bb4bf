"""Mixture-of-Experts layer (granite-moe family): top-k router + capacity
dispatch (the port of ``repro.models.moe`` at tensor-parallel degree 1,
where the reference replicates the experts).

Dispatch is the reference's "running position + gather/scatter" scheme:
every assignment's slot within its expert is the running count of that
expert's assignments in token order (the port reads it off a stable sort
of the assignments by expert, where the reference takes a cumsum over a
``(T*k, E)`` one-hot, which on CUDA is a scan down 8,192 rows at granite's
training shape); assignments past ``capacity`` are dropped (``capacity_factor`` 1.25 by default, as in GShard/Switch).
Expert compute is one batched product over ``(E, C, d)`` buffers.

Three points keep the port on the reference's numbers:

* **Top-k ties.**  ``jax.lax.top_k`` returns the lower index first among
  equal values; ``torch.topk`` makes no such promise, so the router takes
  the first ``k`` of a stable descending sort.
* **Capacity** rounds up to a multiple of 8 with a floor of 8, exactly as
  the reference: it decides which assignments are dropped.
* **A deterministic combine.**  The reference scatter-adds the expert
  outputs into ``(T + 1, d)`` f32; on the CPU that runs in the order of the
  updates, so each token's kept contributions are summed in ascending
  expert order.  The port gathers each token's ``k`` slots, sorted by
  expert, and sums them in that order (a dropped assignment reads a zero
  row), with no atomics: on CUDA, ``index_add_`` would sum in an order that
  changes from run to run.  The dispatch gather's backward is the same
  combine and the combine's backward the same gather
  (:class:`_Dispatch`, :class:`_Combine`), so the gradient is deterministic
  too.

The layer's profiler spans (``moe_router``, ``moe_dispatch``,
``moe_experts``, ``moe_combine``) let a trace attribute device time to its
parts.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.profiler import record_function

from ..configs.base import ModelConfig
from .layers import _ACTS, Initializer

Tree = Any

__all__ = ["moe_init", "moe_forward", "moe_capacity", "route", "dispatch_tables"]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(cfg.top_k * tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)  # a multiple of 8, as the reference pads


def moe_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": init.normal((d, E), 1.0 / math.sqrt(d)),
        "w_in": init.normal((E, d, f), 1.0 / math.sqrt(d)),
        "w_out": init.normal((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.gated_mlp:
        p["w_gate"] = init.normal((E, d, f), 1.0 / math.sqrt(d))
    return p


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, d) with a zero row appended (the out-of-range index R)."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def _sum_slots(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[t] = rows[slots[t, 0]] + rows[slots[t, 1]] + ...`` in that order;
    ``rows`` (R, d) is zero-padded to R + 1 rows, so an index R adds 0."""
    src = _pad_row(rows)
    out = src[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        out = out + src[slots[:, j]]
    return out


class _Dispatch(torch.autograd.Function):
    """``x`` (T, d) -> the expert buffers ``(E * C, d)``: slot ``s`` holds row
    ``table[s]`` of ``x`` (``T``: a zero row).  Its backward sums each
    token's slots in ``slots``' order (:func:`_sum_slots`)."""

    @staticmethod
    def forward(ctx, x, table, slots):
        ctx.save_for_backward(table, slots)
        return _pad_row(x)[table]

    @staticmethod
    def backward(ctx, g):
        table, slots = ctx.saved_tensors
        return _sum_slots(g, slots), None, None


class _Combine(torch.autograd.Function):
    """The expert outputs ``(E * C, d)`` -> each token's sum of its slots
    (``slots`` (T, k), ascending expert order, ``E * C``: dropped).  Its
    backward gathers each slot's token row (``table``)."""

    @staticmethod
    def forward(ctx, y, table, slots):
        ctx.save_for_backward(table, slots)
        return _sum_slots(y, slots)

    @staticmethod
    def backward(ctx, g):
        table, slots = ctx.saved_tensors
        return _pad_row(g)[table], None, None


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The f32 router over tokens ``xt`` (T, d): ``(logits, probs,
    expert_idx, gate_vals)``, the top-k experts of each token (the lower
    index first among ties, as ``jax.lax.top_k``) and their gates
    renormalized over the k."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    gate_vals = torch.gather(probs, 1, expert_idx)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return logits, probs, expert_idx, gate_vals


def dispatch_tables(expert_idx: torch.Tensor, gate_vals: torch.Tensor, cfg: ModelConfig):
    """The capacity dispatch of ``T`` tokens' top-k assignments.  Returns a
    dict: ``capacity`` C; per assignment (token-major, (T*k,)) its slot
    position ``pos`` among the same expert's assignments in token order and
    ``keep`` (pos < C); per buffer slot (E*C,) its token ``table`` (T:
    empty, reads a zero row) and gate ``gtable`` (0 where empty); per token
    its k slots ``slots`` (T, k) in ascending expert order (E*C: dropped);
    and ``hits`` (E,), 1 where a kept assignment reached the expert."""
    T, k = expert_idx.shape
    E = cfg.n_experts
    dev = expert_idx.device
    C = moe_capacity(cfg, T)
    flat_e = expert_idx.reshape(-1)  # (T*k,) the expert of each assignment
    # position among the same expert's assignments, in token order (the
    # reference's cumsum of a (T*k, E) one-hot): a stable sort groups the
    # assignments by expert in token order, and each one's rank in its group
    # is its index there less the group's first index (no host sync: the
    # shapes do not depend on the data)
    sorted_e, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype))
    rank = torch.arange(T * k, device=dev) - start[sorted_e]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < C
    # each assignment's slot in the (E * C) buffers; E * C = dropped
    slot = torch.where(keep, flat_e * C + pos, E * C)
    tok_of = torch.arange(T * k, device=dev) // k
    # every dropped assignment writes the same value into the spare entry E * C
    table = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    table = table.index_put((slot,), torch.where(keep, tok_of, T))[:E * C]
    gtable = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    gtable = gtable.index_put((slot,), torch.where(keep, gate_vals.reshape(-1), 0.0))[:E * C]
    hits = torch.zeros((E + 1,), dtype=torch.float32, device=dev)
    hits = hits.index_fill(0, torch.where(keep, flat_e, E), 1.0)[:E]
    # each token's slots in ascending expert order (the reference's scatter
    # order on the CPU)
    order = torch.argsort(expert_idx, dim=1)
    slots = torch.gather(slot.reshape(T, k), 1, order)
    return {"capacity": C, "pos": pos, "keep": keep, "table": table, "gtable": gtable,
            "slots": slots, "hits": hits}


def moe_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig):
    """x: (B, S, d) -> ((B, S, d), aux): aux holds the Switch load-balance
    loss ``moe_load_balance``, the router z-loss ``moe_router_z`` and the
    ``(E,)`` mask ``moe_expert_hits`` of experts that a kept assignment
    reached."""
    B, S, d = x.shape
    dt = x.dtype
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, d)

    with record_function("moe_router"):
        logits, probs, expert_idx, gate_vals = route(xt, params["router"], cfg)
        # Switch load balance + router z-loss
        me = torch.mean(probs, dim=0)
        onehot = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        onehot.scatter_(1, expert_idx, 1.0)
        ce = torch.mean(onehot, dim=0)
        aux = {
            "moe_load_balance": E * torch.sum(me * ce),
            "moe_router_z": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        }

    with record_function("moe_dispatch"):
        tabs = dispatch_tables(expert_idx, gate_vals, cfg)
        C, table, slots = tabs["capacity"], tabs["table"], tabs["slots"]
        aux["moe_expert_hits"] = tabs["hits"]
        xin = _Dispatch.apply(xt, table, slots).reshape(E, C, d)

    with record_function("moe_experts"):
        h = torch.bmm(xin, params["w_in"].to(dt))
        if "w_gate" in params:
            g = torch.bmm(xin, params["w_gate"].to(dt))
            h = _ACTS[cfg.act](g) * h
        else:
            h = _ACTS[cfg.act](h)
        y = torch.bmm(h, params["w_out"].to(dt))
        y = y * tabs["gtable"].reshape(E, C, 1).to(dt)

    with record_function("moe_combine"):
        out = _Combine.apply(y.reshape(E * C, d).to(torch.float32), table, slots)
    return out.reshape(B, S, d).to(dt), aux
