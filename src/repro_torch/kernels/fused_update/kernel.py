"""Fused optimizer-stage kernel for Hopper (Triton), and its plain version.

Replaces ``repro/kernels/fused_update/kernel.py:fused_stage_kernel`` (the
Pallas TPU kernel, body ``_stage_body``).  One kernel family covers every
elementwise stage of every algorithm's update tail
(:mod:`repro_torch.core.update_spec`): the op and the ``MathCtx`` flags are
``tl.constexpr``, so each ``(kind, op, ctx)`` compiles to its own fused
pass — one read of each operand, one write of each output.

What bounds it on an H100: device-memory bytes.  A stage does at most ~10
flops per element against 12-28 bytes moved (up to 5 loads and 2 stores),
far below the card's ~20 flop/byte f32 balance point, so its bound is its
bytes over 3.35 TB/s.  The design follows from that:

* a flat 1-D grid over ``numel`` of each stacked leaf (leading axis = node
  axis), ``BLOCK`` contiguous elements per program so loads vectorize to
  16-byte accesses; the TPU's ``(rows, 1024)`` tiling was its VMEM layout
  and is not needed here;
* every operand upcast to f32 in registers, ``x`` stored back in the
  parameter dtype and every other output in f32 (``update_spec``'s policy);
* the traced scalars ``lr, gs, r, sg`` are read from a ``(4,)`` f32 device
  tensor, so a new lr recompiles nothing and the launch needs no host value;
* per-node and per-row scalars (the counterpart of the reference kernel's
  ``row_scalars`` operand, ``kernel.py:37-53,76,97,133``): ``gs`` and ``r``
  may instead come from a compact f32 column, one float per node or per
  plane row.  The grid is then 2-D, ``(blocks of one node, nodes)``, and a
  program loads its one value with one scalar load: with ``BLOCK`` equal to
  the plane's row width, a program is exactly one plane row, so no
  per-element index arithmetic reads the column.  The TPU's ``(rows, 128)``
  VMEM column was a layout artefact; the card needs one float per row.
  The modes are ``tl.constexpr``: a stage without such columns compiles to
  the 1-D kernel it always was;
* offsets are 64-bit: a stacked lm_head leaf passes 2**31 elements at 14
  nodes;
* ``(x - mix) / lr`` uses IEEE division (``div_rn``) like the plain
  version, and the launch passes ``enable_fp_fusion=False``: Triton would
  otherwise contract ``a*b + c`` into FMAs, and contract some ops (the
  ``decentlam_sa_post`` momentum, bf16-x stages with clip + coupled wd +
  LARS) differently at different positions of a block, so that the same
  element at another offset modulo ``BLOCK`` came out an ulp apart and the
  plane and per-leaf launches disagreed.  With every multiply and add
  rounded on its own, as the plain version's eager ops round them, an
  element's result depends on its operands only.  The stage does at most
  ~10 flops per element against 12-28 bytes, so the unfused arithmetic
  costs no time on a bytes-bound kernel;
* the staleness damping ``sg`` may come per node from a column too
  (``SG_COL``): the stacked step's delayed channel reports each node's
  incident version gap, so ``decentlam_sa_post`` damps each node by its
  own ``max(sa_damping ** gap, sa_floor)``.  The reference's Pallas stage
  takes only a scalar ``sg``, since inside its shard_map each node sees its
  own; the stacked port needs the ``(n,)`` column, as it needs ``gs``.

The caller may pass the same tensor as an input and as an output (``x``
and ``m`` updated in place): each program loads its block before it stores
it, and blocks do not overlap.

The Triton body lives in :mod:`._triton`, which :func:`fused_stage_launch`
imports at the first launch, so this module imports on hosts without
Triton.
"""

from __future__ import annotations

import torch

from ...core.update_spec import MathCtx, post_io, post_math, pre_io, pre_math

__all__ = [
    "OPS", "BLOCK", "STAGE_FLOPS", "stage_io", "stage_plain", "fused_stage_launch",
    "reset_launches", "stage_bytes", "stage_work",
]

BLOCK = 1024  # = planes.LANES: a per-row column's program covers one plane row
NUM_WARPS = 4
# column modes of the kernel's GS_COL / R_COL / SG_COL
_COL_MODE = {"node": 1, "row": 2}
# the svec scalars a column may override, and in which modes
_COL_NAMES = {"gs": ("node", "row"), "r": ("node", "row"), "sg": ("node",)}

# op -> kernel op code (the kernel body's constexpr ``OP``)
OPS: dict[tuple[str, str], int] = {
    ("pre", "grad_step"): 0,
    ("pre", "identity_g"): 1,
    ("pre", "momentum_payload"): 2,
    ("pre", "momentum_accum"): 3,
    ("pre", "x_minus_lr_m"): 4,
    ("pre", "momentum_keep_x"): 5,
    ("pre", "qg_payload"): 6,
    ("pre", "d2_payload"): 7,
    ("post", "assign_x"): 8,
    ("post", "assign_m"): 9,
    ("post", "mix_minus_lr_m"): 10,
    ("post", "momentum_step"): 11,
    ("post", "qg_post"): 12,
    ("post", "decentlam_post"): 13,
    ("post", "decentlam_sa_post"): 14,
}


def stage_io(kind: str, op: str, ctx: MathCtx):
    return pre_io(op, ctx) if kind == "pre" else post_io(op)


# ---------------------------------------------------------------------------
# The plain version: update_spec's math, per leaf
# ---------------------------------------------------------------------------


def stage_plain(kind, op, ctx: MathCtx, svec: torch.Tensor, ins: dict, out_dtypes: dict,
                cols: dict | None = None):
    """One stage on one leaf or plane in plain torch: ``pre_math``/``post_math``
    on f32 upcasts of ``ins``, with the scalars read from ``svec = [lr, gs,
    r, sg]`` and overridden by ``cols`` (``{"gs"|"r": tensor}``, each an
    ``(n,)`` per-node value or a ``(rows, 1)`` / ``(n, rows, 1)`` row column,
    broadcast by the stage math; ``{"sg": (n,)}`` a per-node damping).
    Returns ``{name: tensor}`` in ``out_dtypes``; like the kernel's, each
    output is its own buffer (never an input, never another output).
    Counts its calls in ``stage_plain.calls``."""
    s = {"lr": svec[0], "gs": svec[1], "r": svec[2], "sg": svec[3], **(cols or {})}
    vals = {n: t.to(torch.float32) for n, t in ins.items()}
    math = pre_math if kind == "pre" else post_math
    res = math(op, ctx, s, **vals)
    out: dict[str, torch.Tensor] = {}
    seen = [*ins.values(), *vals.values()]
    for n, dt in out_dtypes.items():
        t = res[n].to(dt)
        if any(t is u for u in seen):
            t = t.clone()
        seen.append(t)
        out[n] = t
    stage_plain.calls += 1
    return out


def stage_bytes(ins: dict, outs: dict) -> int:
    """Bytes a stage must move: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in (*ins.values(), *outs.values()))


# f32 operations per element of each op's math at the plain context (a
# multiply-add counts 2, a division 1; clip, LARS and weight decay add a few
# more): grad_step is x - lr*g; decentlam_post (x - mix) / lr, then beta*m +
# g~, then x - lr*m; decentlam_sa_post (x - mix) / lr (2), the momentum
# beta*m + (sg*drift + (1 - sg)*g) (5), x - lr*(sg*(beta*m) + drift) (4)
STAGE_FLOPS = {
    "grad_step": 2, "identity_g": 0, "momentum_payload": 4, "momentum_accum": 2,
    "x_minus_lr_m": 2, "momentum_keep_x": 2, "qg_payload": 4, "d2_payload": 7,
    "assign_x": 0, "assign_m": 0, "mix_minus_lr_m": 2, "momentum_step": 4, "qg_post": 5,
    "decentlam_post": 6, "decentlam_sa_post": 11,
}


def stage_work(op: str, ins: dict, out_dtypes: dict) -> tuple[int, int]:
    """``(flops, bytes)`` of one launch on ``ins`` writing outputs of
    ``out_dtypes`` (``{name: dtype}``) of the same shape: :data:`STAGE_FLOPS`
    per element, each input read once and each output written once (as
    :func:`stage_bytes`).  The cost model counts a launch with this work."""
    first = next(iter(ins.values()))
    numel = first.numel()
    nbytes = sum(t.numel() * t.element_size() for t in ins.values())
    nbytes += sum(numel * dt.itemsize for dt in out_dtypes.values())
    return numel * STAGE_FLOPS[op], nbytes


def fused_stage_launch(kind, op, ctx: MathCtx, svec: torch.Tensor, ins: dict, outs: dict,
                       *, nodes: int = 0, per_node: dict | None = None,
                       per_row: dict | None = None):
    """Launch the stage kernel on CUDA tensors: ``ins`` are the op's operands
    (:func:`~repro_torch.core.update_spec.pre_io`/``post_io`` names), ``outs``
    the preallocated outputs (an output may be the same tensor as the input
    of that name).

    ``nodes > 0`` runs the 2-D grid over a stacked operand whose leading
    ``nodes`` slices are the nodes; ``per_node`` (``{"gs"|"r": (nodes,)}``)
    and ``per_row`` (``{"gs"|"r": (nodes * rows,)}``, operands shaped
    ``(nodes, rows, BLOCK)`` or, at ``nodes=1``, ``(rows, BLOCK)``) override
    the svec scalar of that name with a float32 column; ``sg`` takes a
    column per node only.  Checks device, dtype, shape and contiguity and
    raises on anything the kernel does not take; counts its launches in
    ``fused_stage_launch.launches``, per op in
    ``fused_stage_launch.launches_by_op`` and, for each column it read, in
    ``fused_stage_launch.launches_by_col[(op, name)]``."""
    names_in, names_out = stage_io(kind, op, ctx)
    if tuple(ins) != tuple(names_in) or tuple(outs) != tuple(names_out):
        raise ValueError(
            f"{kind}/{op} takes {names_in} -> {names_out}, got {tuple(ins)} -> {tuple(outs)}"
        )
    first = ins[names_in[0]]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"the fused stage kernel runs on CUDA tensors, got {dev}")
    if svec.device != dev or svec.dtype != torch.float32 or tuple(svec.shape) != (4,):
        raise ValueError("svec must be a (4,) float32 tensor on the operands' device")
    for name, t in (*ins.items(), *outs.items()):
        if t.device != dev or t.shape != first.shape or not t.is_contiguous():
            raise ValueError(
                f"operand {name!r}: {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); want contiguous {tuple(first.shape)} on {dev}"
            )
        if not t.dtype.is_floating_point:
            raise ValueError(f"operand {name!r} has non-float dtype {t.dtype}")
    for name, t in outs.items():
        if name != "x" and t.dtype != torch.float32:
            raise ValueError(f"output {name!r} must be float32, got {t.dtype}")

    numel = first.numel()
    cols = {name: (t, "node") for name, t in (per_node or {}).items()}
    for name, t in (per_row or {}).items():
        if name in cols:
            raise ValueError(f"{name!r} is given both per node and per row")
        cols[name] = (t, "row")
    if cols or nodes:
        if nodes <= 0 or first.ndim < 1 or numel % nodes:
            raise ValueError(f"a column needs nodes > 0 dividing the operand's "
                             f"{numel} elements, got nodes={nodes}")
        numel //= nodes  # one node's elements: the 2-D grid's row
        if nodes > 65535:
            raise ValueError(f"{nodes} nodes exceed the grid's second dimension (65535)")
    rows = -(-numel // BLOCK)
    for name, (t, mode) in cols.items():
        if mode not in _COL_NAMES.get(name, ()):
            raise ValueError(f"{name!r} takes no column per {mode} (columns: {_COL_NAMES})")
        if mode == "row" and (numel % BLOCK or first.shape[-1] != BLOCK):
            raise ValueError(f"a per-row column needs operands of rows of {BLOCK}, "
                             f"got {tuple(first.shape)}")
        want = nodes if mode == "node" else nodes * rows
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or t.numel() != want):
            raise ValueError(f"{name} column: {tuple(t.shape)} {t.dtype} on {t.device}; want "
                             f"{want} contiguous float32 values on {dev} (one per {mode})")

    import triton

    from ._triton import fused_stage_kernel

    dummy = svec
    ptr = lambda d, n: d.get(n, dummy)
    col = lambda n: cols[n][0] if n in cols else dummy
    mode = lambda n: _COL_MODE[cols[n][1]] if n in cols else 0
    grid = (triton.cdiv(numel, BLOCK), nodes) if nodes else (triton.cdiv(numel, BLOCK),)
    with torch.cuda.device(dev):
        fused_stage_kernel[grid](
            svec, col("gs"), col("r"), col("sg"),
            ptr(ins, "x"), ptr(ins, "g"), ptr(ins, "m"), ptr(ins, "mix"),
            ptr(ins, "x_prev"), ptr(ins, "m_prev"),
            ptr(outs, "x"), ptr(outs, "payload"), ptr(outs, "m"),
            numel, float(ctx.beta), float(1.0 - ctx.beta), float(ctx.wd),
            OP=OPS[(kind, op)],
            HAS_X="x" in ins, HAS_G="g" in ins, HAS_M="m" in ins,
            HAS_MIX="mix" in ins, HAS_PREV="x_prev" in ins,
            NESTEROV=ctx.nesterov, COUPLED_WD=ctx.coupled_wd,
            DECOUPLED_WD=ctx.decoupled_wd, CLIP=ctx.clip, LARS=ctx.lars,
            NODE_GRID=bool(nodes), GS_COL=mode("gs"), R_COL=mode("r"), SG_COL=mode("sg"),
            BLOCK=BLOCK, num_warps=NUM_WARPS, enable_fp_fusion=False,
        )
    fused_stage_launch.launches += 1
    by_op = fused_stage_launch.launches_by_op
    by_op[op] = by_op.get(op, 0) + 1
    by_col = fused_stage_launch.launches_by_col
    for name in cols:
        by_col[(op, name)] = by_col.get((op, name), 0) + 1
    return outs


def reset_launches() -> None:
    """Set the launch counts, and the plain version's call count, to 0."""
    fused_stage_launch.launches = 0
    fused_stage_launch.launches_by_op = {}
    fused_stage_launch.launches_by_col = {}
    stage_plain.calls = 0


reset_launches()
