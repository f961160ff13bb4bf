"""Consensus-gated weight publication from the training fleet (the port of
``repro.serve.publisher``).

The decentralized average — not any single node's iterate — is the model
you ship; what makes a *node's* iterate an acceptable stand-in is a tight
consensus distance, which grows when gossip goes stale.  The
:class:`WeightPublisher` turns that into an admission policy: a node offers
its parameters every publish interval together with its consensus signal
(the channel's incident version gap, :func:`repro_torch.core.gossip.
fleet_node_gaps` on the host), and the offer is **rejected** whenever the
gap exceeds the configured threshold.

Publication is a double-buffered, versioned plane-snapshot handoff:

* the parameter tree is packed into its :class:`~repro_torch.core.planes.
  PlaneLayout` host buffers — one contiguous CPU tensor per dtype bucket,
  the layout the flat-plane training path keeps its parameters in, so a
  plane-form source (node 0's ``(rows, LANES)`` slice of the stacked plane
  on the card) is one device-to-host copy per bucket;
* the serving side reads the snapshot as a parameter tree of **zero-copy
  views** over those buffers (:meth:`PlaneLayout.view_unpack`), byte-exact
  with :meth:`PlaneLayout.unpack` of the same buffers (re-verified per
  publish with ``check_consistency=True``);
* two buffers alternate: the writer fills the standby buffer while readers
  keep views on the active one, then flips.  A reader that re-reads
  :attr:`WeightPublisher.current` at every swap point (the engine does,
  between decode batches) never observes a torn snapshot; holding a
  snapshot across **two** accepted publishes is the documented hazard — its
  buffer gets rewritten.  :meth:`Snapshot.materialize` detaches a copy.

On a host with CUDA the buffers are pinned, so the copies to and from the
card run at the link's rate.

Snapshots are always in the global (rank-free) plane form: with a sharded
training layout (tp > 1) a plane-form source is the stacked shard planes
``(tp * rows, LANES)`` (:meth:`PlaneLayout.pack_global`), joined into the
global tree through the training layout and packed into the snapshot
layout (the shard row maps differ from the global ones, so a per-bucket
copy would interleave the shards).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.planes import PlaneLayout
from ..utils import tree_leaves, tree_map

Tree = Any

__all__ = ["Snapshot", "WeightPublisher"]


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published weight version.

    ``params`` is the zero-copy view tree over ``planes`` (CPU tensors
    aliasing the bucket buffers); ``gap`` is the consensus signal the
    publish was admitted at.
    """

    version: int
    gap: int
    planes: dict[str, torch.Tensor]
    params: Tree

    def materialize(self) -> "Snapshot":
        """An owned copy of this snapshot, detached from the publisher's
        double buffers (whose views the writer rewrites two accepted
        publishes later): for a consumer that holds the weights across
        publishes."""
        planes = {k: v.clone() for k, v in self.planes.items()}
        params = tree_map(lambda t: t.clone(), self.params)
        return dataclasses.replace(self, planes=planes, params=params)


class WeightPublisher:
    """Double-buffered, versioned, consensus-gated weight handoff.

    ``offer(source, version=..., gap=...)`` publishes iff ``gap <=
    gap_threshold`` and ``version`` advances monotonically; ``source`` is a
    parameter tree in the layout's template structure **or** an
    already-packed plane dict (recognized by its keys being the layout's
    dtype-bucket names), on the host or on the card.  ``current`` is the
    newest accepted :class:`Snapshot` (None before the first publish).

    ``check_consistency=True`` re-verifies every publish byte for byte: the
    view tree must equal a full :meth:`PlaneLayout.unpack` of the same
    buffers.  Stats (``offers``, ``published``, ``rejected``) come from
    :meth:`stats`.
    """

    def __init__(
        self,
        layout: PlaneLayout,
        *,
        gap_threshold: int = 0,
        check_consistency: bool = False,
    ):
        self.train_layout = layout
        self.layout = layout.global_layout()
        self.gap_threshold = int(gap_threshold)
        self.check_consistency = bool(check_consistency)
        self._bufs: list[dict[str, torch.Tensor] | None] = [None, None]
        self._standby = 0
        self._current: Snapshot | None = None
        self.offers = 0
        self.published = 0
        self.rejected = 0
        self.last_rejected_gap: int | None = None

    # -- protocol -----------------------------------------------------------

    @property
    def current(self) -> Snapshot | None:
        return self._current

    def offer(self, source: Tree, *, version: int, gap: int) -> bool:
        """Gate + publish one weight version; returns whether it shipped."""
        self.offers += 1
        version = int(version)
        gap = int(gap)
        if self._current is not None and version <= self._current.version:
            raise ValueError(
                f"publish version must advance: got {version}, current is "
                f"{self._current.version}"
            )
        if gap > self.gap_threshold:
            self.rejected += 1
            self.last_rejected_gap = gap
            return False

        buf = self._fill_standby(source)
        params = self.layout.view_unpack(buf)
        if self.check_consistency:
            self._verify(buf, params)
        self._current = Snapshot(version=version, gap=gap, planes=buf, params=params)
        self._standby ^= 1
        self.published += 1
        return True

    def stats(self) -> dict[str, Any]:
        return {
            "offers": self.offers,
            "published": self.published,
            "rejected": self.rejected,
            "publish_rate": self.published / self.offers if self.offers else 0.0,
            "gap_threshold": self.gap_threshold,
            "current_version": None if self._current is None else self._current.version,
        }

    # -- internals ----------------------------------------------------------

    def _is_plane_dict(self, source: Tree) -> bool:
        return isinstance(source, dict) and set(source) == set(self.layout.segments)

    def _fill_standby(self, source: Tree) -> dict[str, torch.Tensor]:
        layout = self.layout
        buf = self._bufs[self._standby]
        if buf is None:
            pin = torch.cuda.is_available()
            buf = {key: torch.zeros(shape, dtype=dt, pin_memory=pin)
                   for key, (shape, dt) in layout.plane_shapes().items()}
            self._bufs[self._standby] = buf
        if self._is_plane_dict(source) and self.train_layout.tp > 1:
            layout.host_pack(self.train_layout.unpack_global(
                {k: v.detach().cpu() for k, v in source.items()}), out=buf)
        elif self._is_plane_dict(source):
            # the flat-plane training parameters: one copy per dtype bucket
            for key, dst in buf.items():
                src = source[key]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"bucket {key!r}: source plane {tuple(src.shape)}, the "
                                     f"layout's {tuple(dst.shape)}")
                dst.copy_(src)
        else:
            layout.host_pack(source, out=buf)
        return buf

    def _verify(self, buf: dict[str, torch.Tensor], params: Tree) -> None:
        """The handoff contract: views == full unpack, byte for byte."""
        full = self.layout.unpack(buf)
        for view, ref in zip(tree_leaves(params), tree_leaves(full)):
            if (
                view.dtype != ref.dtype
                or view.shape != ref.shape
                or not torch.equal(view.reshape(-1).view(torch.uint8),
                                   ref.reshape(-1).view(torch.uint8))
            ):
                raise AssertionError(
                    "zero-copy snapshot diverged from PlaneLayout.unpack "
                    f"(dtype {view.dtype} vs {ref.dtype}, shape {tuple(view.shape)} "
                    f"vs {tuple(ref.shape)})"
                )
