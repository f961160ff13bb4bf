"""Mixture-of-Experts layer (granite-moe family): top-k router + capacity
dispatch (the port of ``repro.models.moe``).

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

Tensor parallelism (a :class:`~repro_torch.models.layers.TPContext` of
size > 1) shards the experts over the model group by the reference's
first exact fit (:func:`_expert_sharding`): ``E % tp == 0`` gives
**expert** parallelism (each rank holds ``E / tp`` whole experts and takes
its block of the dispatch tables), ``d_ff % tp == 0`` gives **ffn**
sharding inside every expert (``w_in``/``w_gate`` by columns, ``w_out``
by rows), anything else leaves them **replicated**.  The router runs in
f32 on the replicated input on every rank, so the top-k, the capacity
slots, the aux losses and the hits over all ``E`` experts are tp = 1's;
each rank sums its slots' outputs in ascending expert order and one
all-reduce (``reduce_out``) joins the ranks' partial sums (none when
replicated).  The input and the gate table enter the sharded experts
through ``copy_in``, so the router's and the input's gradients, summed over
the group, are whole on every rank.

DeepSeek-V2's MoE layer (``modeling_deepseek.py``'s ``DeepseekV2MoE``)
is the same layer with four settings of the config:

* ``norm_topk_prob`` False: the gates are the raw router probabilities of
  the k chosen experts (granite renormalizes them over the k);
* ``router_loss`` ``"seq_aux"``: the balance term is taken per sequence,
  ``sum_e f_e P_e`` with ``f_e = count_e E / (k S)`` (the sequence's top-k
  choices of expert ``e``, dropped or not) and ``P_e`` its mean
  probability, averaged over the sequences; no z-loss (granite: the Switch
  term over the microbatch plus the z-loss);
* ``n_shared_experts``: one SwiGLU of width ``n * moe_d_ff`` that every
  token takes, added to the routed experts' sum (span ``moe_shared``);
* ``experts_held``: the chip holds one block of that many experts (block
  ``block`` of ``moe_forward``, 0 by default), routes over all
  ``n_experts`` with their capacity, and computes only its block's part of
  the routed sum, with no exchange: what one rank of an expert-parallel
  group computes, the tp > 1 expert mode's slicing of the dispatch tables
  (:func:`_block_tables`) without its all-reduce.

Where every expert is held (granite) the layer does no extra work.

The layer's profiler spans (``moe_router``, ``moe_dispatch``,
``moe_experts``, ``moe_combine``, and ``moe_shared``;
:func:`repro_torch.trace.span`, entered only while a profiler records) let a
trace attribute device time to its parts.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..trace import span
from .layers import _ACTS, Initializer, TPContext, mlp_apply, mlp_init, tp_enabled

Tree = Any

__all__ = ["moe_init", "moe_shard_axes", "moe_forward", "moe_capacity", "route",
           "router_terms", "dispatch_tables"]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(cfg.top_k * tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)  # a multiple of 8, as the reference pads


def _expert_sharding(cfg: ModelConfig, tp: int) -> str:
    """The reference's first exact fit: ``"expert"``, ``"ffn"`` or
    ``"replicated"``."""
    if tp == 1:
        return "replicated"
    if cfg.n_experts % tp == 0:
        return "expert"
    if cfg.d_ff % tp == 0:
        return "ffn"
    return "replicated"


def moe_shard_axes(cfg: ModelConfig, tp: int) -> Tree:
    """The axis of each MoE leaf split over the model group (None:
    replicated), the reference's ``moe_specs``."""
    mode = _expert_sharding(cfg, tp)
    win, wout = {"expert": (0, 0), "ffn": (2, 1)}.get(mode, (None, None))
    p = {"router": None, "w_in": win, "w_out": wout}
    if cfg.gated_mlp:
        p["w_gate"] = win
    if cfg.n_shared_experts:  # tp = 1 only (transformer.check_tp)
        p["shared"] = {k: None for k in p if k != "router"}
    return p


def moe_init(init: Initializer, cfg: ModelConfig) -> Tree:
    """The router over all ``n_experts``, the held experts' weights
    ``(experts_held, ...)`` and the shared experts' SwiGLU ``shared``."""
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts_held
    p = {
        "router": init.normal((d, cfg.n_experts), 1.0 / math.sqrt(d)),
        "w_in": init.normal((E, d, f), 1.0 / math.sqrt(d)),
        "w_out": init.normal((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.gated_mlp:
        p["w_gate"] = init.normal((E, d, f), 1.0 / math.sqrt(d))
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(init, d, cfg.n_shared_experts * f, cfg.gated_mlp)
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
    index first among ties, as ``jax.lax.top_k``) and their gates,
    renormalized over the k where ``cfg.norm_topk_prob``."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    gate_vals = torch.gather(probs, 1, expert_idx)
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return logits, probs, expert_idx, gate_vals


def router_terms(logits, probs, expert_idx, cfg: ModelConfig, batch: int) -> dict:
    """The router's loss terms: ``cfg.router_loss`` ``"switch"`` gives the
    Switch load balance ``moe_load_balance`` (E sum_e mean probs x mean
    chosen, over the microbatch) and the z-loss ``moe_router_z``;
    ``"seq_aux"`` gives ``moe_load_balance`` as DeepSeek's per-sequence
    term over the ``batch`` sequences (module docstring) and no z-loss."""
    T, E = probs.shape
    onehot = torch.zeros((T, E), dtype=torch.float32, device=probs.device)
    onehot.scatter_(1, expert_idx, 1.0)
    if cfg.router_loss == "seq_aux":
        S = T // batch
        f = onehot.reshape(batch, S, E).sum(1) / (S * cfg.top_k / E)
        return {"moe_load_balance": torch.mean(torch.sum(f * probs.reshape(batch, S, E)
                                                         .mean(1), dim=-1))}
    if cfg.router_loss != "switch":
        raise ValueError(f"unknown router_loss {cfg.router_loss!r}; switch or seq_aux")
    me = torch.mean(probs, dim=0)
    ce = torch.mean(onehot, dim=0)
    return {
        "moe_load_balance": E * torch.sum(me * ce),
        "moe_router_z": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
    }


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


def _block_tables(table, gtable, slots, lo: int, n: int):
    """The dispatch tables of the block of ``n`` buffer slots from ``lo``:
    its slots' tokens and gates, and each token's slots in the block (the
    other blocks' slots read a zero row, ``n``)."""
    slots = torch.where((slots >= lo) & (slots < lo + n), slots - lo, n)
    return table[lo:lo + n], gtable[lo:lo + n], slots


def moe_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig,
                tp: TPContext | None = None, *, block: int = 0):
    """x: (B, S, d) -> ((B, S, d), aux): aux holds the router's loss terms
    (:func:`router_terms`) and the mask ``moe_expert_hits`` of the held
    experts that a kept assignment reached.  With ``tp`` the expert leaves
    are the rank's shards (module docstring) and the output is the same on
    every rank of the group.  Where the chip holds ``experts_held`` of the
    experts, ``block`` is its index in their expert-parallel group: the
    output is that block's part of the routed sum, plus the shared
    experts."""
    B, S, d = x.shape
    dt = x.dtype
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, d)
    mode = _expert_sharding(cfg, tp.size) if tp_enabled(tp) else "replicated"

    with span("moe_router"):
        logits, probs, expert_idx, gate_vals = route(xt, params["router"], cfg)
        aux = router_terms(logits, probs, expert_idx, cfg, B)

    with span("moe_dispatch"):
        tabs = dispatch_tables(expert_idx, gate_vals, cfg)
        C, table, slots, gtable = tabs["capacity"], tabs["table"], tabs["slots"], tabs["gtable"]
        aux["moe_expert_hits"] = tabs["hits"]
        if mode != "replicated":
            # a rank's experts see part of the output: the gradients of the
            # input and of the gates sum over the group
            xt, gtable = tp.copy_in(xt), tp.copy_in(gtable)
        E_local = params["w_in"].shape[0]
        if E_local != E:
            # a tp rank's block of the (E * C) buffers, or the chip's held one
            b = tp.index if mode == "expert" else block
            table, gtable, slots = _block_tables(table, gtable, slots, b * E_local * C,
                                                 E_local * C)
            if mode != "expert":
                aux["moe_expert_hits"] = tabs["hits"][b * E_local:(b + 1) * E_local]
        xin = _Dispatch.apply(xt, table, slots).reshape(E_local, C, d)

    with span("moe_experts"):
        h = torch.bmm(xin, params["w_in"].to(dt))
        if "w_gate" in params:
            g = torch.bmm(xin, params["w_gate"].to(dt))
            h = _ACTS[cfg.act](g) * h
        else:
            h = _ACTS[cfg.act](h)
        y = torch.bmm(h, params["w_out"].to(dt))
        y = y * gtable.reshape(E_local, C, 1).to(dt)

    with span("moe_combine"):
        out = _Combine.apply(y.reshape(E_local * C, d).to(torch.float32), table, slots)
        if mode != "replicated":
            out = tp.reduce_out(out)
    out = out.reshape(B, S, d).to(dt)
    if "shared" in params:
        with span("moe_shared"):
            out = out + mlp_apply(x, params["shared"], cfg.act)
    return out, aux
