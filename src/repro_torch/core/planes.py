"""Flat parameter planes: dtype-bucketed contiguous views of a tree (the
port of ``repro.core.planes``).

The per-leaf path pays one kernel launch per leaf per update stage.  A
:class:`PlaneLayout` packs the whole tree into one contiguous ``(rows,
LANES)`` buffer per dtype bucket, with static per-leaf segment metadata
chosen so that

* every leaf starts at a row boundary (no leaf straddles a row, so a row
  belongs to exactly one leaf), and
* every bucket's row count is a multiple of ``ROW_MULTIPLE`` (64),

exactly as the reference plans it: leaves in sorted-key order, bucket keys
named by dtype (``"float32"``, ``"bfloat16"``), zero padding.  A port plane
therefore equals the reference's ``PlaneLayout.pack`` of the same tree
element for element.  The fused update engine then runs **one** launch per
stage per bucket.  The stage math maps zeros to zeros (``safe_lr`` clamps
the divisions), so padded rows stay inert and nothing reads them.

Per-leaf quantities (the LARS trust ratio) travel as *row-indexed segment
scalars*: :meth:`PlaneLayout.row_scalars` scatters per-leaf scalars to a
``(rows, 1)`` column per bucket (``(n, rows, 1)`` when they are per node),
which broadcasts through the same ``pre_math``/``post_math`` as the
per-leaf path and which the stage kernel reads as one float per row.
:func:`plane_scalars` computes the clip and LARS scalars on the original
trees with the per-leaf code, so they equal the per-leaf path's bit for bit.

In PyTorch the parameters can live in a stacked ``(n, rows, LANES)`` plane:
:meth:`PlaneLayout.view_unpack` with ``leading=1`` gives each leaf as a view
of its segment's rows (contiguous per node), the forward pass reads the
views, and the update writes the plane in place — no per-step pack and
unpack (see :mod:`repro_torch.train.step`).

**Sharded layouts (tensor parallelism).**  ``build(template, tp=k,
shardings=axes)`` plans one model rank's *local* layout, as the reference
does: ``template`` carries global shapes, ``shardings`` (a tree of ints or
None, :func:`~repro_torch.models.transformer.param_shard_axes`) names the
axis of each leaf split over the model group, and its segment records the
local shard shape beside the global one.  Replicated leaves pack whole on
every rank.  Each rank's bucket is a valid ``(rows, LANES)`` plane,
``ROW_MULTIPLE``-aligned, so the stage kernel runs on it unchanged.  The
global form stacks the tp rank blocks along the row axis: ``pack_global``
gives ``(tp * rows, LANES)`` buckets with rank ``r`` owning rows ``[r *
rows, (r + 1) * rows)``, ``unpack_global`` inverts it, ``shard_slice``
cuts a global tree to a rank's shard, and ``global_layout()`` is the
unsharded layout of the global template (the checkpoint's and the
publisher's rank-free form).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils import shard, tree_leaves, tree_unflatten, unshard

Tree = Any

__all__ = ["LANES", "ROW_MULTIPLE", "Segment", "PlaneLayout", "plane_scalars"]

LANES = 1024  # row width (the reference kernel's lane tile; the stage kernel's block)
ROW_MULTIPLE = 64  # bucket row totals pad to the reference kernel's block height


def _bucket_key(dtype: torch.dtype) -> str:
    """The bucket name of a dtype, as the reference names it (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _dtype_of(key: str) -> torch.dtype:
    return getattr(torch, key)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One leaf's slot inside a bucket plane (static metadata)."""

    index: int  # leaf position in the template's leaf order
    shape: tuple[int, ...]  # leaf shape (leading axes excluded)
    dtype: torch.dtype  # template dtype (unpack's default cast target)
    row_start: int  # first plane row of this leaf
    rows: int  # ceil(size / LANES)
    size: int  # true element count (rows * LANES - size is zero pad)
    global_shape: tuple[int, ...] | None = None  # None: the same as ``shape``
    shard_axis: int | None = None  # the axis split over the model group

    @property
    def full_shape(self) -> tuple[int, ...]:
        """The global (unsharded) leaf shape."""
        return self.shape if self.global_shape is None else self.global_shape


class PlaneLayout:
    """Static packing plan for one tree template (see the module docstring)."""

    def __init__(self, template: Tree, segments: dict[str, tuple[Segment, ...]],
                 rows: dict[str, int], *, tp: int = 1, model_axis: str = "model"):
        self.template = template  # the structure leaves are unflattened into
        self.segments = segments
        self.rows = rows  # per-bucket LOCAL row totals (ROW_MULTIPLE aligned)
        # the shard metadata checkpoint manifests record (the reference's)
        self.tp = tp
        self.model_axis = model_axis
        self.n_leaves = sum(len(s) for s in segments.values())
        # row -> segment position within the bucket; tail-pad rows alias
        # segment 0 (their data is zero, so any scalar they pick up is inert)
        self._row_pos: dict[str, torch.Tensor] = {}
        for key, segs in segments.items():
            pos = torch.zeros(rows[key], dtype=torch.long)
            for p, seg in enumerate(segs):
                pos[seg.row_start: seg.row_start + seg.rows] = p
            self._row_pos[key] = pos

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, template: Tree, *, tp: int = 1, shardings: Tree | None = None,
              model_axis: str = "model") -> "PlaneLayout":
        """Plan the packing for ``template`` (only each leaf's ``.shape`` and
        ``.dtype`` are read; meta tensors do).  At ``tp > 1`` the template
        holds global shapes and ``shardings`` (a tree of ints or None like
        it) the axis each leaf splits over the model group: the plan is one
        rank's local layout (module docstring)."""
        leaves = tree_leaves(template)
        if tp > 1 and shardings is None:
            raise ValueError("PlaneLayout.build(tp > 1) needs `shardings` (the shard axis "
                             "of each leaf) to locate the model axis")
        axes = tree_leaves(shardings) if tp > 1 else [None] * len(leaves)
        if len(axes) != len(leaves):
            raise ValueError(f"shardings has {len(axes)} leaves, the template {len(leaves)}")
        segs: dict[str, list[Segment]] = {}
        for i, (leaf, ax) in enumerate(zip(leaves, axes)):
            bucket = segs.setdefault(_bucket_key(leaf.dtype), [])
            start = bucket[-1].row_start + bucket[-1].rows if bucket else 0
            gshape = tuple(leaf.shape)
            shape = gshape
            if ax is not None:
                if gshape[ax] % tp:
                    raise ValueError(f"leaf {i}: axis {ax} of {gshape} is sharded over "
                                     f"{model_axis!r} but not divisible by tp={tp}")
                shape = gshape[:ax] + (gshape[ax] // tp,) + gshape[ax + 1:]
            size = 1
            for d in shape:
                size *= d
            bucket.append(Segment(i, shape, leaf.dtype, start, max(1, -(-size // LANES)),
                                  size, gshape, ax))
        rows = {
            key: -(-(b[-1].row_start + b[-1].rows) // ROW_MULTIPLE) * ROW_MULTIPLE
            for key, b in segs.items()
        }
        skeleton = tree_unflatten(template, [None] * len(leaves))
        return cls(skeleton, {k: tuple(v) for k, v in segs.items()}, rows, tp=tp,
                   model_axis=model_axis)

    @property
    def buckets(self) -> tuple[str, ...]:
        """Bucket keys in the planes dict's (sorted) order."""
        return tuple(sorted(self.segments))

    def plane_shapes(self, dtype: torch.dtype | None = None) -> dict[str, tuple]:
        """``{bucket: ((rows, LANES), dtype)}`` (``dtype=None`` keeps each
        bucket's own)."""
        return {key: ((self.rows[key], LANES), dtype if dtype is not None else _dtype_of(key))
                for key in self.buckets}

    # -- sharded (tensor-parallel) views ------------------------------------

    @property
    def sharded(self) -> bool:
        return self.tp > 1

    def _template_of(self, full: bool) -> Tree:
        out: list = [None] * self.n_leaves
        for segs in self.segments.values():
            for seg in segs:
                out[seg.index] = torch.empty(seg.full_shape if full else seg.shape,
                                             dtype=seg.dtype, device="meta")
        return tree_unflatten(self.template, out)

    def local_template(self) -> Tree:
        """Meta tensors of one rank's LOCAL leaves (the global ones at tp 1)."""
        return self._template_of(False)

    def global_template(self) -> Tree:
        """Meta tensors of the GLOBAL (unsharded) leaves."""
        return self._template_of(True)

    def shard_axes(self) -> Tree:
        """The tree of each leaf's shard axis (None: replicated)."""
        out: list = [None] * self.n_leaves
        for segs in self.segments.values():
            for seg in segs:
                out[seg.index] = seg.shard_axis
        return tree_unflatten(self.template, out)

    def global_layout(self) -> "PlaneLayout":
        """The unsharded layout of the global template (``self`` at tp 1):
        the rank-free plane form of the publisher's snapshots and the common
        ground of checkpoints written at different tp."""
        if self.tp == 1:
            return self
        if getattr(self, "_global", None) is None:
            self._global = PlaneLayout.build(self.global_template())
        return self._global

    def shard_slice(self, tree: Tree, rank: int, *, leading: int = 0) -> Tree:
        """Model rank ``rank``'s local shard of a GLOBAL tree (views):
        sharded leaves cut along their axis (after ``leading`` axes),
        replicated ones whole."""
        if self.tp == 1:
            return tree
        self._leaves(tree)  # the leaf count
        return shard(tree, self.shard_axes(), self.tp, rank, leading=leading)

    def pack_global(self, tree: Tree, *, dtype: torch.dtype | None = None,
                    leading: int = 0) -> dict:
        """A GLOBAL tree -> stacked shard planes ``(..., tp * rows, LANES)``,
        rank ``r``'s local pack in row block ``r`` (:meth:`pack` at tp 1)."""
        packs = [self.pack(self.shard_slice(tree, r, leading=leading), dtype=dtype,
                           leading=leading) for r in range(self.tp)]
        if self.tp == 1:
            return packs[0]
        return {k: torch.cat([p[k] for p in packs], dim=leading) for k in packs[0]}

    def unpack_global(self, planes: dict, *, like: Tree | None = None,
                      dtype: torch.dtype | None = None, leading: int = 0) -> Tree:
        """Stacked shard planes -> the GLOBAL tree (copies): each rank
        block unpacked, sharded leaves joined along their axis, replicated
        leaves from rank 0."""
        if self.tp == 1:
            return self.unpack(planes, like=like, dtype=dtype, leading=leading)
        ranks = [self.unpack(
            {k: p.narrow(leading, r * self.rows[k], self.rows[k]) for k, p in planes.items()},
            like=None if like is None else self.shard_slice(like, r, leading=leading),
            dtype=dtype, leading=leading) for r in range(self.tp)]
        return unshard(ranks, self.shard_axes(), leading=leading)

    def _leaves(self, tree: Tree) -> list:
        leaves = tree_leaves(tree)
        if len(leaves) != self.n_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, the layout {self.n_leaves}")
        return leaves

    # -- pack / unpack ------------------------------------------------------

    def pack(self, tree: Tree, *, dtype: torch.dtype | None = None, leading: int = 0) -> dict:
        """Pack ``tree`` into fresh plane buffers on its leaves' device.

        ``dtype`` casts every buffer (f32 for gradient and momentum trees);
        ``leading`` keeps that many leading axes per leaf (the stacked ``(n,
        ...)`` layout packs with ``leading=1`` into ``(n, rows, LANES)``)."""
        leaves = self._leaves(tree)
        planes: dict[str, torch.Tensor] = {}
        for key, segs in self.segments.items():
            first = leaves[segs[0].index]
            lead = tuple(first.shape[:leading])
            buf = torch.zeros(lead + (self.rows[key], LANES),
                              dtype=dtype if dtype is not None else _dtype_of(key),
                              device=first.device)
            flat = buf.view(lead + (-1,))
            for seg in segs:
                leaf = leaves[seg.index]
                if tuple(leaf.shape) != lead + seg.shape:
                    raise ValueError(f"leaf {seg.index}: shape {tuple(leaf.shape)}, the layout "
                                     f"wants {lead + seg.shape}")
                start = seg.row_start * LANES
                flat[..., start: start + seg.size] = leaf.reshape(lead + (-1,))
            planes[key] = buf
        return planes

    def zero_pads(self, planes: dict, *, leading: int = 0) -> None:
        """Write zeros over the padding of plane buffers — the tail of each
        segment's last row and the bucket's tail rows — in place, leaving the
        segments' elements as they are: a few small fills where zeroing the
        whole plane would write all of it."""
        for key, segs in self.segments.items():
            buf = planes[key]
            flat = buf.view(tuple(buf.shape[:leading]) + (-1,))
            for seg in segs:
                start, end = seg.row_start * LANES + seg.size, (seg.row_start + seg.rows) * LANES
                if end > start:
                    flat[..., start:end] = 0
            flat[..., (segs[-1].row_start + segs[-1].rows) * LANES:] = 0

    def view_unpack(self, planes: dict, *, leading: int = 0) -> Tree:
        """Zero-copy **views** of plane buffers in template structure: each
        leaf is its segment's elements reshaped (its ``data_ptr`` lies inside
        the bucket; no bytes move).  The views alias the buffers: they see
        every later write to them, and a write through a view lands in the
        plane.  With ``leading=1`` on ``(n, rows, LANES)`` planes each leaf is
        ``(n, ...)``, contiguous per node."""
        out: list = [None] * self.n_leaves
        for key, segs in self.segments.items():
            buf = planes[key]
            lead = tuple(buf.shape[:leading])
            if tuple(buf.shape[leading:]) != (self.rows[key], LANES):
                raise ValueError(f"bucket {key!r}: plane {tuple(buf.shape)}, the layout wants "
                                 f"{lead + (self.rows[key], LANES)}")
            flat = buf.view(lead + (-1,))
            for seg in segs:
                start = seg.row_start * LANES
                out[seg.index] = flat[..., start: start + seg.size].view(lead + seg.shape)
        return tree_unflatten(self.template, out)

    def unpack(self, planes: dict, *, like: Tree | None = None,
               dtype: torch.dtype | None = None, leading: int = 0) -> Tree:
        """The tree of the planes as new tensors (copies, never views).  Each
        leaf casts to ``dtype`` when given, else to ``like``'s leaf dtype,
        else to the template dtype recorded in its segment."""
        like_leaves = self._leaves(like) if like is not None else None
        views = tree_leaves(self.view_unpack(planes, leading=leading))
        out: list = [None] * self.n_leaves
        for segs in self.segments.values():
            for seg in segs:
                dt = dtype if dtype is not None else (
                    like_leaves[seg.index].dtype if like_leaves is not None else seg.dtype)
                out[seg.index] = views[seg.index].to(dt, copy=True)
        return tree_unflatten(self.template, out)

    def host_pack(self, tree: Tree, out: dict | None = None) -> dict:
        """Pack ``tree`` into **host** (CPU) plane buffers, reusing ``out``
        where given (its padding was zeroed at allocation and is never
        written: segment writes cover exactly ``seg.size`` elements).  Leaves
        may lie on the card (one device-to-host copy per leaf); their dtypes
        must be the template's — the plane is the byte-exact concatenation
        of the leaves."""
        leaves = self._leaves(tree)
        if out is None:
            out = {key: torch.zeros((self.rows[key], LANES), dtype=_dtype_of(key))
                   for key in self.buckets}
        for key, segs in self.segments.items():
            buf = out[key]
            if tuple(buf.shape) != (self.rows[key], LANES) or not buf.is_contiguous():
                raise ValueError(f"bucket {key!r}: host buffer {tuple(buf.shape)}")
            flat = buf.view(-1)
            for seg in segs:
                leaf = leaves[seg.index]
                if leaf.dtype != seg.dtype:
                    raise ValueError(f"leaf {seg.index} is {leaf.dtype}, the layout {seg.dtype}")
                start = seg.row_start * LANES
                flat[start: start + seg.size].copy_(leaf.reshape(-1))
        return out

    # -- per-leaf scalars as row-indexed segment scalars --------------------

    def row_scalars(self, scalar_tree: Tree) -> dict:
        """A tree of per-leaf scalars -> ``{bucket: (rows, 1) f32}`` columns;
        per-leaf ``(n,)`` values (one per node) -> ``(n, rows, 1)``.  The
        static row->segment map scatters each leaf's value across its rows."""
        vals = self._leaves(scalar_tree)
        out = {}
        for key, segs in self.segments.items():
            col = torch.stack([torch.as_tensor(vals[s.index], dtype=torch.float32)
                               for s in segs])  # (segments,) or (segments, n)
            col = col[self._row_pos[key].to(col.device)]  # (rows,) or (rows, n)
            out[key] = col.T.contiguous().unsqueeze(-1) if col.ndim == 2 else col[:, None]
        return out


def plane_scalars(cfg, layout: PlaneLayout, x: Tree, g: Tree, *, stacked: bool = False,
                  tp=None) -> dict:
    """Gradient-preprocessing scalars for the plane path.

    Runs the per-leaf :func:`~repro_torch.core.update_spec.grad_scalars` on
    the original trees — per node with ``stacked=True``
    (:func:`~repro_torch.core.update_spec.node_grad_scalars`, ``(n, ...)``
    trees) — so ``gs`` and the LARS ratios equal the per-leaf path's bit for
    bit, then turns the per-leaf LARS tree into row columns that broadcast
    over the plane buffers.  Feed the result to ``run_update(...,
    scalars=...)`` with plane operands."""
    from .update_spec import grad_scalars, node_grad_scalars

    sharded = [a is not None for a in tree_leaves(layout.shard_axes())]
    s = dict((node_grad_scalars if stacked else grad_scalars)(cfg, x, g, tp=tp,
                                                               sharded=sharded))
    # "r" is a per-leaf tree exactly when the LARS family is active
    if isinstance(s.get("r"), dict):
        s["r"] = layout.row_scalars(s["r"])
    return s
