"""Tree-level fused optimizer-update engine.

``make_stage`` builds a stage executor with the signature of
``update_spec.reference_stage`` backed by the stage kernel: every leaf is
updated in one pass over device memory.  Feed it to
``update_spec.run_update`` to run any of the eleven algorithms' update
tails fused::

    from repro_torch.core.update_spec import run_update, update_spec
    from repro_torch.kernels.fused_update import make_stage

    x, state, comp = run_update(update_spec(cfg), cfg, ..., stage=make_stage())

``impl="triton"`` launches the Hopper kernel on CUDA tensors;
``impl="torch"`` runs the kernel's plain version.  A leaf that lies on the
CPU always takes the plain version (the kernel exists only on the card); a
CUDA leaf under ``impl="triton"`` launches the kernel or raises.

``inplace=True`` writes the ``x`` and ``m`` outputs over the operands of
the same name (the stage is elementwise, so this is exact).  It saves one
copy of the parameters and of the momentum at the end of every step — 21 GB
at qwen3-0.6b x 4 nodes — and mutates the caller's trees.  ``payload`` is
a fresh buffer, or the one ``out`` names (a delay ring's next slot), so it
never aliases ``x``.

Per-node scalars (stacked trees): a clip scale ``gs`` of shape ``(n,)``,
LARS ratios ``r`` that are ``(n,)`` per leaf
(:func:`~repro_torch.core.update_spec.node_grad_scalars`) and a staleness
damping ``sg`` of shape ``(n,)`` (a delayed stacked channel's incident
gaps through ``staleness_damping``) launch the kernel's 2-D grid, one value
per node.

``make_plane_stage`` is the flat path: operands are
:class:`~repro_torch.core.planes.PlaneLayout` buffers (one contiguous
``(rows, LANES)`` or stacked ``(n, rows, LANES)`` buffer per dtype bucket,
every leaf row-aligned), so each stage is **one** launch per bucket instead
of one per leaf.  Per-leaf LARS ratios ride along as the layout's row
columns (``PlaneLayout.row_scalars``), which the kernel reads one float per
row.

``decentlam_update`` keeps the single-algorithm entry point (the Alg. 2 /
eq. 17 tail) on top of the same engine.
"""

from __future__ import annotations

import functools

import torch

from ...core.planes import LANES
from ...core.update_spec import MathCtx, leaf_scalars, reference_stage
from ...launch.costmodel import kernel_unit
from ...utils import tree_leaves, tree_unflatten
from .kernel import BLOCK, fused_stage_launch, stage_io, stage_plain, stage_work

__all__ = ["make_stage", "fused_stage", "make_plane_stage", "fused_plane_stage",
           "decentlam_update", "IMPLS"]

assert LANES == BLOCK, "a plane row must be one program of the stage kernel"

IMPLS = ("triton", "torch")


def _scalar(v, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def _split_scalars(s: dict, dev) -> tuple[torch.Tensor, dict]:
    """``svec = [lr, gs, r, sg]`` and the tensors among ``gs``, ``r``, ``sg``
    that are not scalars (per-node values or, for ``gs`` and ``r``, row
    columns; their svec slot holds 1)."""
    cols = {}
    for k in ("gs", "r", "sg"):
        v = s[k]
        if isinstance(v, torch.Tensor) and v.ndim:
            cols[k] = v.to(device=dev, dtype=torch.float32)
    svec = torch.stack([_scalar(1.0 if k in cols else s[k], dev)
                        for k in ("lr", "gs", "r", "sg")])
    return svec, cols


def _run(kind, op, ctx, ins, out_dtypes, svec, *, per_node, per_row, nodes, impl, inplace,
         out=None):
    """One stage on one leaf or bucket: the plain version for CPU tensors or
    ``impl="torch"``, else the kernel (which raises on what it cannot take);
    on meta tensors (the dry run) the kernel's outputs, unwritten.  Under a
    cost recorder each call but ``impl="torch"``'s is one ``fused_update``
    unit (:func:`~repro_torch.launch.costmodel.kernel_unit`).
    ``per_node`` holds ``(n,)`` values, ``per_row`` row columns; the kernel
    runs its 2-D grid over ``nodes`` when there are any.  ``out`` names
    buffers to write outputs into."""
    names_out = tuple(out_dtypes)
    first = next(iter(ins.values()))
    reuse = {
        n: ins[n] for n in names_out
        if inplace and n in ins and ins[n].dtype == out_dtypes[n]
    }
    reuse.update(out or {})
    if impl == "torch":
        return _plain(kind, op, ctx, ins, out_dtypes, svec, {**per_node, **per_row}, reuse)
    with kernel_unit("fused_update", lambda: stage_work(op, ins, out_dtypes)):
        if first.device.type == "cpu":
            return _plain(kind, op, ctx, ins, out_dtypes, svec, {**per_node, **per_row}, reuse)
        res = {
            n: reuse[n] if n in reuse else torch.empty(first.shape, dtype=dt, device=first.device)
            for n, dt in out_dtypes.items()
        }
        if first.device.type == "meta":  # the dry run: the kernel's outputs, unwritten
            return res
        fused_stage_launch(
            kind, op, ctx, svec, ins, res, nodes=nodes if per_node or per_row else 0,
            per_node={n: c.reshape(-1) for n, c in per_node.items()},
            per_row={n: c.reshape(-1) for n, c in per_row.items()},
        )
    return res


def _plain(kind, op, ctx, ins, out_dtypes, svec, cols, reuse):
    res = stage_plain(kind, op, ctx, svec, ins, out_dtypes, cols)
    for n, buf in reuse.items():
        res[n] = buf.copy_(res[n])
    return res


def fused_stage(kind, op, ctx: MathCtx, operands, scalars, like_x, *, out=None,
                impl: str = "triton", inplace: bool = False):
    """Fused stage executor (signature of ``reference_stage``), one launch
    per leaf.  Per-node ``(n,)`` ``gs``, ``r`` or ``sg`` launch the 2-D
    grid."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fused impl {impl!r}; one of {IMPLS}")
    names = tuple(operands)
    first = operands[names[0]]
    cols = {n: tree_leaves(operands[n]) for n in names}
    likes = tree_leaves(like_x)
    n_leaves = len(cols[names[0]])
    per_leaf_s = leaf_scalars(scalars, n_leaves, ctx)
    _, names_out = stage_io(kind, op, ctx)

    out_leaves = {n: tree_leaves(t) for n, t in (out or {}).items()}
    out_cols: dict[str, list] = {n: [] for n in names_out}
    for i in range(n_leaves):
        ins = {n: cols[n][i] for n in names}
        svec, node_cols = _split_scalars(per_leaf_s[i], ins[names[0]].device)
        out_dtypes = {n: (likes[i].dtype if n == "x" else torch.float32) for n in names_out}
        res = _run(kind, op, ctx, ins, out_dtypes, svec, per_node=node_cols, per_row={},
                   nodes=ins[names[0]].shape[0] if node_cols else 0,
                   impl=impl, inplace=inplace,
                   out={n: leaves[i] for n, leaves in out_leaves.items()})
        for n in names_out:
            out_cols[n].append(res[n])
    return {n: tree_unflatten(first, col) for n, col in out_cols.items()}


def fused_plane_stage(kind, op, ctx: MathCtx, operands, scalars, like_x, *, out=None,
                      impl: str = "triton", inplace: bool = False):
    """Whole-plane stage executor (signature of ``reference_stage``).

    Operands are plane dicts — ``{bucket: (rows, LANES)}`` or stacked
    ``{bucket: (n, rows, LANES)}`` of one
    :class:`~repro_torch.core.planes.PlaneLayout` — so the "leaves" are the
    dtype buckets and each stage issues exactly one launch per bucket.  The
    LARS ratio, when per leaf, arrives as the layout's row columns
    (``{bucket: (rows, 1)}`` or ``(n, rows, 1)``) and the kernel reads one
    float per row; a per-node ``(n,)`` clip scale or staleness damping one
    float per node."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fused impl {impl!r}; one of {IMPLS}")
    names = tuple(operands)
    buckets = sorted(operands[names[0]])
    _, names_out = stage_io(kind, op, ctx)
    lr, gs, sg = scalars["lr"], scalars.get("gs", 1.0), scalars.get("sg", 1.0)
    r = scalars.get("r")
    r_cols = r if ctx.lars and isinstance(r, dict) else None
    if r_cols is not None and sorted(r_cols) != buckets:
        raise ValueError(f"row columns for {sorted(r_cols)}, operands in {buckets}")

    res_out: dict[str, dict] = {n: {} for n in names_out}
    for key in buckets:
        ins = {n: operands[n][key] for n in names}
        first = ins[names[0]]
        if first.ndim not in (2, 3) or first.shape[-1] != LANES:
            raise ValueError(f"plane stage operands are (rows, {LANES}) or (n, rows, "
                             f"{LANES}) buffers, got {tuple(first.shape)} in {key!r}")
        s = {"lr": lr, "gs": gs, "sg": sg,
             "r": r_cols[key] if r_cols is not None else (1.0 if r is None else r)}
        svec, cols = _split_scalars(s, first.device)
        per_row = {n: c for n, c in cols.items() if c.ndim == first.ndim}
        per_node = {n: c for n, c in cols.items() if n not in per_row}
        if per_node and first.ndim != 3:
            raise ValueError("per-node scalars need stacked (n, rows, LANES) planes")
        out_dtypes = {n: (like_x[key].dtype if n == "x" else torch.float32) for n in names_out}
        res = _run(kind, op, ctx, ins, out_dtypes, svec, per_node=per_node, per_row=per_row,
                   nodes=first.shape[0] if first.ndim == 3 else 1, impl=impl, inplace=inplace,
                   out={n: t[key] for n, t in (out or {}).items()})
        for n in names_out:
            res_out[n][key] = res[n]
    return res_out


def make_stage(impl: str = "triton", *, inplace: bool = False):
    """Stage executor for ``run_update``: ``triton`` (the kernel) or
    ``torch`` (its plain version)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fused impl {impl!r}; one of {IMPLS}")
    return functools.partial(fused_stage, impl=impl, inplace=inplace)


def make_plane_stage(impl: str = "triton", *, inplace: bool = False):
    """Stage executor for ``run_update`` over plane operands: ``triton`` the
    whole-plane kernel executor (one launch per bucket; the plain version on
    CPU tensors), ``torch`` the plain version —
    :func:`~repro_torch.core.update_spec.reference_stage`, whose stage math
    broadcasts the row columns like any operand (as ``repro``'s ``"ref"``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fused impl {impl!r}; one of {IMPLS}")
    if impl == "torch":
        return reference_stage
    return functools.partial(fused_plane_stage, impl=impl, inplace=inplace)


def decentlam_update(params, mixed, momentum, lr, *, beta: float, impl: str = "triton"):
    """Fused DecentLaM tail (eq. 17 + momentum + step) over a tree.

    Given pre-gossiped ``mixed = G(x - lr * g)``::

        g~    = (x - mixed) / lr
        m_new = beta * m + g~
        x_new = x - lr * m_new

    Returns ``(new_params, new_momentum)``; the fused stage reads
    ``(x, mixed, m)`` and writes ``(x_new, m_new)`` in one pass.
    """
    dev = tree_leaves(params)[0].device
    one = torch.ones((), dtype=torch.float32, device=dev)
    scalars = {
        "lr": torch.as_tensor(lr, dtype=torch.float32, device=dev).reshape(()),
        "gs": one,
        "r": one,
    }
    out = fused_stage(
        "post", "decentlam_post", MathCtx(beta=beta),
        {"x": params, "mix": mixed, "m": momentum}, scalars, params, impl=impl,
    )
    return out["x"], out["m"]
