"""RowTracker: from model-level touch events to plane-row dirty masks
(``repro.sparse.tracker``).

The sparse channels consume row masks over the gossip payload; on the
flat-plane path that payload is the ``{bucket: (rows, LANES)}`` planes of a
:class:`~repro_torch.core.planes.PlaneLayout`, whose invariant (every leaf
starts at a row boundary, a row belongs to one leaf) makes rows
addressable.  The tracker is the static bridge:

* **dense leaves** (attention, norms, router weights, tied embeddings)
  contribute a static base mask: all their rows, every step.  Pad rows stay
  clean (zero on every node).
* **sparse leaves** are *unit sources*: an untied embedding table is
  ``vocab`` units of ``d_model`` elements (the touched units are the step's
  token ids); a layer-stacked MoE expert slab ``(Lg, E, d, f)`` is ``Lg *
  E`` units (the touched units are the router's ``(Lg, E)`` hits).
  :meth:`step_masks` maps each source's touched units to plane rows through
  the static unit->row interval overlap (a cumsum and a gather) and ORs
  them into the base.

Tied embeddings are tracked dense: the lm-head's softmax gradient touches
every table row each step.

On a sharded layout (tensor parallelism) a segment's shape is the rank's
local one, and so are its rows and unit sizes.  Touch inputs stay global
(token ids over the whole vocabulary, router hits over all experts): where
the shard axis lies inside the unit grid (the vocab-sharded embedding, an
expert-sharded MoE slab), :meth:`RowTracker.step_masks` takes the rank's
``shard_rank`` and slices its block of the global hot mask; an
element-dim shard (the ffn-sharded experts) shrinks the unit size and the
global mask applies to every rank whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.planes import LANES, PlaneLayout
from ..utils import tree_paths

Tree = Any

__all__ = ["RowSource", "RowTracker"]


@dataclasses.dataclass(frozen=True)
class RowSource:
    """One sparse-tracked leaf: ``units`` logical units of ``unit_size``
    contiguous elements at rows ``[row_start, row_start + rows)`` of bucket
    ``bucket``; ``starts``/``ends1`` are the static unit interval
    ``[starts[r], ends1[r])`` each plane row overlaps."""

    name: str  # key into step_masks' units dict ("embed", "moe/g0", ...)
    kind: str  # "embed" | "moe" (informational)
    bucket: str
    row_start: int
    rows: int
    units: int
    unit_size: int
    starts: np.ndarray  # (rows,) int32
    ends1: np.ndarray  # (rows,) int32, exclusive
    unit_grid: tuple[int, ...] = ()  # the global unit grid (() -> (units,))
    shard_dim: int | None = None  # the unit-grid axis split over the model group
    shard_parts: int = 1


def _unit_intervals(rows: int, units: int, unit_size: int):
    """Static unit-interval bounds per plane row: row ``r`` covers elements
    ``[r*LANES, (r+1)*LANES)``, unit ``u`` covers ``[u*s, (u+1)*s)``."""
    r = np.arange(rows, dtype=np.int64)
    starts = np.minimum((r * LANES) // unit_size, units - 1)
    ends1 = np.minimum(((r + 1) * LANES - 1) // unit_size + 1, units)
    return starts.astype(np.int32), ends1.astype(np.int32)


class RowTracker:
    """Static plan mapping touch events to ``{bucket: (rows,) bool}`` masks
    over a :class:`PlaneLayout` (see the module docstring)."""

    def __init__(self, layout: PlaneLayout, sources: tuple[RowSource, ...]):
        self.layout = layout
        self.sources = sources
        sparse_rows: dict[str, set[int]] = {k: set() for k in layout.segments}
        for src in sources:
            sparse_rows[src.bucket].update(range(src.row_start, src.row_start + src.rows))
        # base mask: every row of every dense-tracked leaf; pad rows clean
        self._base: dict[str, np.ndarray] = {}
        for key, segs in layout.segments.items():
            base = np.zeros(layout.rows[key], bool)
            for seg in segs:
                sl = slice(seg.row_start, seg.row_start + seg.rows)
                if not sparse_rows[key].issuperset(range(sl.start, sl.stop)):
                    base[sl] = True
            self._base[key] = base
        self._dev: dict = {}  # per device: the base masks and the intervals

    @classmethod
    def for_model(cls, layout: PlaneLayout, template: Tree | None = None, *,
                  tied_embeddings: bool) -> "RowTracker":
        """Scan the parameter tree the layout was built from (its skeleton
        by default) for sparse-trackable leaves:

        * ``embed/table`` (untied only) -> source ``"embed"``, one unit per
          vocab row; feed token ids (any int shape) or a (vocab,) hot mask.
        * ``groups/<g>/moe/{w_in,w_out,w_gate}`` expert slabs ``(Lg, E,
          ...)`` -> source ``"moe/<g>"``, one unit per (layer, expert); feed
          the router's ``(Lg, E)`` hit mask.  Router weights stay dense.
        """
        paths = tree_paths(layout.template if template is None else template)
        by_index: dict[int, tuple[str, str, int]] = {}
        for i, path in enumerate(paths):
            keys = path.split("/")
            seg = next(s for segs in layout.segments.values() for s in segs if s.index == i)
            if keys[-2:] == ["embed", "table"] and not tied_embeddings:
                by_index[i] = ("embed", "embed", 1)
            elif (len(keys) >= 4 and keys[0] == "groups" and keys[2] == "moe"
                  and keys[3] in ("w_in", "w_out", "w_gate") and len(seg.shape) >= 3):
                by_index[i] = ("moe", f"moe/{keys[1]}", 2)
        sources = []
        for key, segs in layout.segments.items():
            for seg in segs:
                if seg.index not in by_index:
                    continue
                kind, name, nu = by_index[seg.index]
                # the rank-local shape sets the rows and the unit size; a
                # shard axis inside the unit grid keeps the global grid
                # (step_masks slices the rank's block), an element-dim one
                # does not touch it
                lshape = tuple(seg.shape)
                units = int(np.prod(lshape[:nu])) if lshape[:nu] else 1
                unit_size = max(1, int(np.prod(lshape[nu:])))
                if seg.shard_axis is not None and seg.shard_axis < nu:
                    grid, shard_dim, parts = tuple(seg.full_shape[:nu]), seg.shard_axis, layout.tp
                else:
                    grid, shard_dim, parts = lshape[:nu], None, 1
                starts, ends1 = _unit_intervals(seg.rows, units, unit_size)
                sources.append(RowSource(
                    name=name, kind=kind, bucket=key, row_start=seg.row_start, rows=seg.rows,
                    units=units, unit_size=unit_size, starts=starts, ends1=ends1,
                    unit_grid=grid, shard_dim=shard_dim, shard_parts=parts))
        return cls(layout, tuple(sources))

    @property
    def source_names(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(s.name for s in self.sources))

    def all_dirty(self, device=None) -> dict:
        """Every non-pad row dirty (the dense-equivalence input)."""
        out = {}
        for key, segs in self.layout.segments.items():
            m = torch.zeros(self.layout.rows[key], dtype=torch.bool, device=device)
            for seg in segs:
                m[seg.row_start: seg.row_start + seg.rows] = True
            out[key] = m
        return out

    def _on(self, device) -> dict:
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {
                "base": {k: torch.from_numpy(v).to(device) for k, v in self._base.items()},
                "iv": [(torch.from_numpy(s.starts.astype(np.int64)).to(device),
                        torch.from_numpy(s.ends1.astype(np.int64)).to(device))
                       for s in self.sources],
            }
        return self._dev[device]

    def _hot(self, src: RowSource, val, device, shard_rank=None) -> torch.Tensor:
        """Touched-unit input -> ``(local units,)`` bool: an integer tensor
        holds indices over the global unit grid (scattered; out-of-range ones
        dropped), anything else is a global hit mask; a source whose unit
        grid is sharded keeps ``shard_rank``'s block."""
        total = int(np.prod(src.unit_grid)) if src.unit_grid else src.units
        val = torch.as_tensor(val).to(device)
        if not val.is_floating_point() and val.dtype != torch.bool:
            idx = val.reshape(-1).to(torch.int64)
            idx = torch.where((idx >= 0) & (idx < total), idx, total)
            hot = torch.zeros(total + 1, dtype=torch.bool, device=device)
            hot = hot.index_fill_(0, idx, True)[:total]
        else:
            hot = val.reshape(-1) if val.dtype == torch.bool else val.reshape(-1) != 0
        if hot.shape[0] != total:
            raise ValueError(f"source {src.name!r}: expected {total} units, got shape "
                             f"{tuple(val.shape)}")
        if src.shard_dim is None:
            return hot
        n = src.unit_grid[src.shard_dim] // src.shard_parts
        return hot.reshape(src.unit_grid).narrow(src.shard_dim, int(shard_rank) * n,
                                                 n).reshape(-1)

    def step_masks(self, units: dict[str, Any], *, shard_rank=None, device=None) -> dict:
        """Touch events -> ``{bucket: (rows,) bool}`` payload row masks (on
        ``device``; default: the first input's, else the CPU).  ``units``
        maps source names to touched-unit inputs; a registered source
        missing from ``units`` is marked fully dirty (conservative).  On a
        sharded layout the inputs stay global and ``shard_rank`` (the
        caller's model index) picks the rank's block.  Feed the result to
        ``channel.mark``."""
        if shard_rank is None and any(s.shard_dim is not None for s in self.sources):
            raise ValueError("step_masks on a sharded layout needs shard_rank= (the caller's "
                             "model index) to slice global touch inputs down to local rows")
        if device is None:
            first = next((v for v in units.values() if isinstance(v, torch.Tensor)), None)
            device = first.device if first is not None else torch.device("cpu")
        on = self._on(device)
        masks = {k: v.clone() for k, v in on["base"].items()}
        for src, (starts, ends1) in zip(self.sources, on["iv"]):
            if src.name in units:
                hot = self._hot(src, units[src.name], device, shard_rank)
                c = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                               torch.cumsum(hot.to(torch.int64), 0)])
                rows = (c[ends1] - c[starts]) > 0
            else:
                rows = torch.ones(src.rows, dtype=torch.bool, device=device)
            sl = masks[src.bucket][src.row_start: src.row_start + src.rows]
            sl |= rows
        return masks

    def summary(self) -> dict:
        """Static accounting: per-bucket total rows, dense base rows, and the
        sources' row spans."""
        return {
            "buckets": {key: {"rows": int(self.layout.rows[key]),
                              "base_dirty_rows": int(self._base[key].sum())}
                        for key in self.layout.segments},
            "sources": [{"name": s.name, "kind": s.kind, "bucket": s.bucket,
                         "rows": int(s.rows), "units": int(s.units),
                         "unit_size": int(s.unit_size)} for s in self.sources],
        }
