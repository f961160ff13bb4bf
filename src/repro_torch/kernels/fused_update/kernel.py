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
* offsets are 64-bit: a stacked lm_head leaf passes 2**31 elements at 14
  nodes;
* ``(x - mix) / lr`` uses IEEE division (``div_rn``) like the plain version;
  Triton contracts ``a*b + c`` into FMAs where eager torch does not, so the
  kernel and the plain version agree to about one ulp, not bitwise.

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
    "OPS", "BLOCK", "stage_io", "stage_plain", "fused_stage_launch", "reset_launches",
    "stage_bytes",
]

BLOCK = 1024
NUM_WARPS = 4

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


def stage_plain(kind, op, ctx: MathCtx, svec: torch.Tensor, ins: dict, out_dtypes: dict):
    """One stage on one leaf in plain torch: ``pre_math``/``post_math`` on f32
    upcasts of ``ins``, with the scalars read from ``svec = [lr, gs, r, sg]``.
    Returns ``{name: tensor}`` in ``out_dtypes``; like the kernel's, each
    output is its own buffer (never an input, never another output)."""
    s = {"lr": svec[0], "gs": svec[1], "r": svec[2], "sg": svec[3]}
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
    return out


def stage_bytes(ins: dict, outs: dict) -> int:
    """Bytes a stage must move: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in (*ins.values(), *outs.values()))


def fused_stage_launch(kind, op, ctx: MathCtx, svec: torch.Tensor, ins: dict, outs: dict):
    """Launch the stage kernel on CUDA tensors: ``ins`` are the op's operands
    (:func:`~repro_torch.core.update_spec.pre_io`/``post_io`` names), ``outs``
    the preallocated outputs (an output may be the same tensor as the input
    of that name).  Checks device, dtype, shape and contiguity and raises on
    anything the kernel does not take; counts its launches in
    ``fused_stage_launch.launches`` and, per op, in
    ``fused_stage_launch.launches_by_op``."""
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

    import triton

    from ._triton import fused_stage_kernel

    numel = first.numel()
    dummy = svec
    ptr = lambda d, n: d.get(n, dummy)
    grid = (triton.cdiv(numel, BLOCK),)
    with torch.cuda.device(dev):
        fused_stage_kernel[grid](
            svec,
            ptr(ins, "x"), ptr(ins, "g"), ptr(ins, "m"), ptr(ins, "mix"),
            ptr(ins, "x_prev"), ptr(ins, "m_prev"),
            ptr(outs, "x"), ptr(outs, "payload"), ptr(outs, "m"),
            numel, float(ctx.beta), float(1.0 - ctx.beta), float(ctx.wd),
            OP=OPS[(kind, op)],
            HAS_X="x" in ins, HAS_G="g" in ins, HAS_M="m" in ins,
            HAS_MIX="mix" in ins, HAS_PREV="x_prev" in ins,
            NESTEROV=ctx.nesterov, COUPLED_WD=ctx.coupled_wd,
            DECOUPLED_WD=ctx.decoupled_wd, CLIP=ctx.clip, LARS=ctx.lars,
            BLOCK=BLOCK, num_warps=NUM_WARPS,
        )
    fused_stage_launch.launches += 1
    by_op = fused_stage_launch.launches_by_op
    by_op[op] = by_op.get(op, 0) + 1
    return outs


def reset_launches() -> None:
    """Set the launch counts to 0."""
    fused_stage_launch.launches = 0
    fused_stage_launch.launches_by_op = {}


reset_launches()
