"""Row-sparse gossip channels: ship only the touched rows of each bucket
(``repro.sparse.channel``).

The dense channels ship the whole payload every round even when a step
touches a small part of it (an untied embedding table, MoE expert slabs).
These channels carry a *dirty-row mask* per payload leaf in the channel
state (``state["rows"]``) and mix only the dirty rows.  Masks are fed by
:meth:`mark` (from :class:`~repro_torch.sparse.tracker.RowTracker`, or from
gradient support through :func:`grad_row_masks`); a "row" is a slice of a
leaf's first per-node axis — a plane row of a ``(rows, LANES)`` bucket, a
coordinate of a stacked simulator parameter.  Every leaf here carries a
leading node axis: ``n`` on the stacked layout, 1 on a rank.

Two modes, as in the reference:

* ``mode="exact"`` — equivalent to dense gossip.  The mask is global and
  monotone: a row touched by any node is dirty on every node from then on
  (stacked: the union over the node axis; on ranks: one all-reduce of a
  ``(rows,)`` u8 per leaf).  Clean rows are equal on every node by
  induction, so the mix skips them: the output is ``where(dirty,
  dense_mix, own_row)``.  The port's dense mixes are fixed-order
  elementwise sums, so a dirty row gets the dense channel's bits, and with
  every row dirty the channel equals the dense one bit for bit.  At delay
  > 0 untouched rows must be stationary (zero weight decay; the train step
  enforces it).
* ``mode="delta"`` — per-sender, per-phase masks with heal-after-delivery:
  receivers substitute their own row for anything a sender did not ship.
  Lossy unless every row ships (then the dense mix's bits).  Delay 0 and
  stateless compressors only.

Top-k compression is refused (it selects entries across the whole bucket
and breaks the row framing).  Crossover: once a leaf's dirty fraction
reaches ``crossover`` the round ships it dense (mask forced all-true).

Byte accounting is state-dependent: every ``apply`` adds measured sparse
and dense-equivalent egress to ``state["rows"]["vol"]`` (a shipped row is
priced at its compressed wire bytes + 4 for an i32 index, capped at the
leaf's dense wire bytes), and ``bytes_per_step(payload_bytes, state)``
reports the realized per-round average.

The distributed channels move only the dirty rows on the wire when the
payload is uncompressed: exact mode sends the dirty rows of each leaf,
gathered into one contiguous block (the receiver knows their indices: the
mask is agreed by the all-reduce), and delta mode sends each sender's row
count, its i32 row indices and the rows; receivers scatter them into the
mix.  ``sent_bytes`` counts what this rank sent; ``staged_bytes`` (gloo
with payloads on a card) what it copied through host memory.  A compressed
payload ships the whole buffer with clean rows zeroed, the reference's own
framing (its compressors quantize over the whole buffer).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core.compression import wire_bytes
from ..core.gossip import (
    STAGE_CHUNK_BYTES,
    DelayedPpermuteChannel,
    DelayedStackedChannel,
    GossipChannel,
    PpermuteChannel,
    _accumulate,
    _rotate_slots,
    delay_matrix,
)
from ..core.topology import Topology
from ..utils import tree_leaves, tree_map, tree_unflatten

Tree = Any

__all__ = [
    "SparseStackedChannel",
    "SparsePpermuteChannel",
    "SparseDelayedPpermuteChannel",
    "SparseGossipChannel",
    "build_sparse_channel",
    "grad_row_masks",
]

_MODES = ("exact", "delta")


def grad_row_masks(grads: Tree) -> Tree:
    """Per-node touched-row masks from gradient support: leaf ``(n, R, ...)``
    -> ``(n, R)`` bool (any nonzero in the row); an ``(n,)`` leaf is one row
    per node.  Feed the result to :meth:`mark`."""

    def leaf(g):
        m = torch.abs(g) > 0
        if g.ndim == 1:
            return m[:, None]
        if g.ndim > 2:
            m = torch.any(m.reshape(m.shape[0], m.shape[1], -1), dim=2)
        return m

    return tree_map(leaf, grads)


def _rows_of(per_node_shape: tuple) -> int:
    return int(per_node_shape[0]) if per_node_shape else 1


def _row_wire(per_node_shape: tuple, compression: str | None) -> float:
    """Wire bytes of one shipped row: compressed row payload + i32 index."""
    tail = int(np.prod(per_node_shape[1:])) if len(per_node_shape) > 1 else 1
    return wire_bytes(4.0 * tail, compression) + 4.0


def _leaf_wire(per_node_shape: tuple, compression: str | None) -> float:
    """Dense wire bytes of the whole leaf (the sparse-framing cost cap)."""
    size = int(np.prod(per_node_shape)) if per_node_shape else 1
    return wire_bytes(4.0 * size, compression)


def _exp(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A mask broadcastable against a leaf ``(lead, R, ...)``: an ``(R,)``
    mask selects alike on every node, a ``(lead, R)`` one per node.  A
    ``(lead,)`` leaf has one row per node."""
    if x.ndim == 1:
        return m.reshape(1) if m.ndim == 1 else m[:, 0]
    lead = (1,) if m.ndim == 1 else ()
    return m.reshape(lead + tuple(m.shape) + (1,) * (x.ndim - 2))


class _RowMaskMixin:
    """Shared dirty-row plumbing: the state layout, :meth:`mark`, the
    crossover and the volume accounting."""

    mode: str
    crossover: float

    def _check_sparse_args(self, mode: str, crossover: float, calls_per_step: int = 1):
        if mode not in _MODES:
            raise ValueError(f"mode={mode!r}; expected one of {_MODES}")
        if not (0.0 < crossover <= 1.0):
            raise ValueError(f"crossover must be in (0, 1], got {crossover}")
        if self._compressor.name.startswith("topk"):
            raise ValueError(
                "row-sparse channels reject top-k compression: top-k selects entries across "
                "the whole bucket and breaks the row framing (dirty-mask sparsity is not top-k)")
        if mode == "delta" and self._stateful_comp:
            raise ValueError("mode='delta' requires a stateless compressor: error feedback on "
                             "rows a peer never receives is unsound")
        self.mode = mode
        self.crossover = float(crossover)
        # multi-gossip algorithms (da-dmsgd) send several payloads per step;
        # delta mode heals a shipped row only after the step's last send
        self.sparse_calls = max(1, int(calls_per_step))
        self.sent_bytes = 0

    @staticmethod
    def _leaf_rows(x) -> int:
        return _rows_of(tuple(x.shape[1:]))

    def _rows_init(self, template: Tree) -> dict:
        period = self.topology.period
        first = tree_leaves(template)[0]
        lead, dev = first.shape[0], first.device

        def dirty(x):
            r = self._leaf_rows(x)
            shape = (lead, period, r) if self.mode == "delta" else (lead, r)
            return torch.zeros(shape, dtype=torch.bool, device=x.device)

        rows = {
            "dirty": tree_map(dirty, template),
            "pending": tree_map(lambda x: torch.zeros((lead, self._leaf_rows(x)),
                                                      dtype=torch.bool, device=x.device),
                                template),
            "vol": {"sparse": torch.zeros(lead, dtype=torch.float32, device=dev),
                    "dense": torch.zeros(lead, dtype=torch.float32, device=dev),
                    "rounds": torch.zeros(lead, dtype=torch.int32, device=dev)},
        }
        if self.mode == "delta":
            # which gossip call of the step this is (heal on the last one)
            rows["call"] = torch.zeros(lead, dtype=torch.int32)
        return rows

    def mark(self, state: Tree, masks: Tree) -> Tree:
        """OR row masks into the pending set (call any number of times
        before ``apply``).  Mask leaves match the payload structure: ``(R,)``
        for every node alike, or ``(lead, R)`` per node; non-bool leaves are
        hit counts (``!= 0``)."""

        def one(p, m):
            m = torch.as_tensor(m).to(p.device)
            if m.dtype != torch.bool:
                m = m != 0
            return p | m.expand(p.shape)

        rows = dict(state["rows"])
        rows["pending"] = tree_map(one, rows["pending"], masks)
        return {**state, "rows": rows}

    def _with_crossover(self, m: torch.Tensor) -> torch.Tensor:
        """Dense fallback: a mask goes all-true once its dirty fraction
        reaches the threshold (from the agreed mask, so every node takes
        the same branch; no host sync)."""
        frac = torch.mean(m.to(torch.float32))
        return m | (frac >= self.crossover)

    def _sparse_egress(self, masks: list, leaves: list, step: int, *,
                       per_sender: bool) -> torch.Tensor:
        """Measured egress bytes this round: shipped rows x (row wire + 4 B
        index), capped per leaf at its dense wire cost, times the phase's
        send count; per node ``(lead,)`` with ``per_sender``, else a scalar."""
        sends = np.float32(len(self.topology.edge_classes(step % self.topology.period)))
        total = None
        for m, x in zip(masks, leaves):
            shape = tuple(x.shape[1:])
            rw = float(np.float32(_row_wire(shape, self.compression)))
            cap = float(np.float32(_leaf_wire(shape, self.compression)))
            count = torch.sum(m.to(torch.float32), dim=-1 if per_sender else None)
            term = torch.clamp(count * rw, max=cap)
            total = term if total is None else total + term
        return total * float(sends)

    def _vol_tick(self, rows: dict, sparse_eg: torch.Tensor, dense_eg: float) -> dict:
        vol = rows["vol"]
        return {**rows, "vol": {
            "sparse": vol["sparse"] + sparse_eg.to(vol["sparse"].device),
            "dense": vol["dense"] + float(np.float32(dense_eg)),
            "rounds": vol["rounds"] + 1,
        }}

    def _tele_sparse(self, new_state: dict, old_state: dict, sparse_eg: torch.Tensor) -> dict:
        """The telemetry's egress bytes: the measured sparse bytes, not the
        dense ones the parent ticked."""
        if "t" not in new_state:
            return new_state
        old = old_state["t"]["bytes"]
        return {**new_state, "t": {**new_state["t"],
                                   "bytes": old + sparse_eg.reshape(()).to(old.device)}}

    def bytes_per_step(self, payload_bytes: float, state: Tree | None = None) -> dict:
        base = GossipChannel.bytes_per_step(self, payload_bytes)
        if state is None or "rows" not in state:
            return base  # the dense analytic count: an upper bound
        vol = {k: v.detach().cpu().numpy() for k, v in state["rows"]["vol"].items()}
        rounds = max(float(np.mean(vol["rounds"])), 1.0)
        return {"egress_bytes": float(np.mean(vol["sparse"])) / rounds,
                "hops": base["hops"],
                "dense_egress_bytes": float(np.mean(vol["dense"])) / rounds}

    def dirty_fractions(self, state: Tree) -> list[float]:
        """Each leaf's fraction of rows dirty on this node (host floats)."""
        out = []
        for d in tree_leaves(state["rows"]["dirty"]):
            out.append(float(d.to(torch.float32).mean()))
        return out


# ---------------------------------------------------------------------------
# Stacked layout (simulator, oracle, CPU tests)
# ---------------------------------------------------------------------------


class SparseStackedChannel(_RowMaskMixin, DelayedStackedChannel):
    """Row-sparse gossip in the stacked ``(n, ...)`` layout.

    Over :class:`~repro_torch.core.gossip.DelayedStackedChannel`: delay 0
    runs the stacked mix underneath and ``delay > 0`` its rings; exact mode
    is a mask around the parent's mixed result, delta mode its own hybrid
    mix."""

    name = "sparse-stacked"

    def __init__(self, topology: Topology, delay=0, *, mode: str = "exact",
                 crossover: float = 0.9, calls_per_step: int = 1,
                 compression: str | None = None, telemetry: bool = False):
        super().__init__(topology, delay, calls_per_step=calls_per_step,
                         compression=compression, telemetry=telemetry)
        self._check_sparse_args(mode, crossover, calls_per_step)
        if mode == "delta" and (delay_matrix(topology.n, delay) != 0).any():
            raise ValueError(
                "mode='delta' requires delay=0: healing a row after delivery is unsound when "
                "the delivery itself is stale (use mode='exact' for delayed sparse gossip)")

    def _init_extra(self, template: Tree) -> dict:
        extra = super()._init_extra(template)
        extra["rows"] = self._rows_init(template)
        return extra

    def _exact_apply(self, state: Tree, tree: Tree, step: int):
        rows = state["rows"]
        # union the pending marks over senders into the monotone global mask
        D = [self._with_crossover(torch.any(d, dim=0) | torch.any(p, dim=0))
             for d, p in zip(tree_leaves(rows["dirty"]), tree_leaves(rows["pending"]))]
        leaves = tree_leaves(tree)
        old_comp = ([c.clone() for c in tree_leaves(state["comp"])]
                    if self._stateful_comp and "comp" in state else None)
        sub = {k: v for k, v in state.items() if k != "rows"}
        sub, mixed = DelayedStackedChannel.apply(self, sub, tree, step)
        # dirty rows take the dense channel's bits; clean rows are identity
        outs = tree_leaves(mixed)
        for m, y, x in zip(D, outs, leaves):
            torch.where(_exp(m, y), y, x.to(y.dtype), out=y)
        if old_comp is not None:
            # row-sparse error feedback: unshipped rows keep their residual
            for m, cn, co in zip(D, tree_leaves(sub["comp"]), old_comp):
                torch.where(_exp(m, cn), cn, co, out=cn)
        sparse_eg = self._sparse_egress(D, leaves, step, per_sender=False)
        sub = self._tele_sparse(sub, state, sparse_eg)
        n = self.topology.n
        new_rows = self._vol_tick(rows, sparse_eg, self._phase_bytes(tree)[step % self.topology.period])
        new_rows["dirty"] = tree_unflatten(rows["dirty"],
                                           [m[None].expand(n, -1).clone() for m in D])
        new_rows["pending"] = tree_map(torch.zeros_like, rows["pending"])
        sub["rows"] = new_rows
        return sub, mixed

    def _delta_phase(self, t: int, leaves: list, masks: list) -> list:
        """Hybrid mix: rows every sender shipped take the dense mix's bits;
        otherwise each receiver substitutes its own row for unshipped
        senders."""
        W, Woff, diag = self._Ws[t], self._Woffs[t], self._diags[t]
        compressed = self._compressor.name != "none"
        outs = []
        for x, m in zip(leaves, masks):
            x32 = x.to(torch.float32)
            n = x.shape[0]
            flat = x32.reshape(n, -1)
            mb = _exp(m, x32).expand(x32.shape).reshape(n, -1)
            dense = torch.empty_like(flat)
            if compressed:
                src = torch.empty_like(x32)
                self._encode_decode(x32, [()] * n, src)
                src = src.reshape(n, -1)
                _accumulate(dense, [(Woff, src)], base=(flat, diag))
                Wm = Woff
            else:
                src = flat
                _accumulate(dense, [(W, flat)])
                Wm = W
            sparse = torch.empty_like(flat)
            for i in range(n):
                acc = torch.mul(flat[i], float(diag[i])) if compressed else None
                for j in np.flatnonzero(Wm[i]):
                    term = torch.where(mb[j], src[j], flat[i]) * float(Wm[i, j])
                    acc = term if acc is None else acc + term
                sparse[i] = acc if acc is not None else 0.0
            all_ship = torch.all(m, dim=0)
            out = torch.where(_exp(all_ship, x32).expand(x32.shape).reshape(n, -1), dense, sparse)
            outs.append(out.reshape(x.shape).to(x.dtype))
        return outs

    def _delta_apply(self, state: Tree, tree: Tree, step: int):
        rows = state["rows"]
        period = self.topology.period
        tau = step % period
        # a touched row is dirty for every phase until that phase ships it
        dirty = [d | p[:, None, :] for d, p in zip(tree_leaves(rows["dirty"]),
                                                   tree_leaves(rows["pending"]))]
        M = [self._with_crossover(d[:, tau]) for d in dirty]
        leaves = tree_leaves(tree)
        mixed = tree_unflatten(tree, self._delta_phase(tau, leaves, M))
        call = int(rows["call"].reshape(-1)[0])
        last = (call + 1) % self.sparse_calls == 0
        sparse_eg = self._sparse_egress(M, leaves, step, per_sender=True)
        new_rows = self._vol_tick(rows, sparse_eg, self._phase_bytes(tree)[tau])
        if last:  # heal: the rows just delivered to this phase's peers
            for d in dirty:
                d[:, tau] = False
        new_rows["dirty"] = tree_unflatten(rows["dirty"], dirty)
        new_rows["pending"] = (tree_map(torch.zeros_like, rows["pending"]) if last
                               else rows["pending"])
        new_rows["call"] = torch.full_like(rows["call"], (call + 1) % self.sparse_calls)
        new_state = {k: v for k, v in state.items() if k != "rows"}
        new_state = self._finish(new_state, tree, step)
        new_state = self._tele_sparse(new_state, state, torch.mean(sparse_eg))
        new_state["rows"] = new_rows
        return new_state, mixed

    def apply(self, state: Tree, tree: Tree, step: int):
        if self.mode == "delta":
            return self._delta_apply(state, tree, step)
        return self._exact_apply(state, tree, step)


# the reference's name for the stacked realization
SparseGossipChannel = SparseStackedChannel


# ---------------------------------------------------------------------------
# Distributed layout (one process per node)
# ---------------------------------------------------------------------------


class _SparseWire:
    """The distributed channels' shared pieces: the mask union and the
    dirty-row exchanges over the parent's ``_Wire``."""

    def _union(self, pending: torch.Tensor) -> torch.Tensor:
        """The OR over the ranks of a ``(1, R)`` mask: one MAX all-reduce of
        a u8 on the group's collective device."""
        g = self.group
        u = pending.to(torch.uint8).to(g.comm_device)
        dist.all_reduce(u, op=dist.ReduceOp.MAX, group=g.pg)
        return u.to(pending.device) > 0

    def _rows_exchange(self, send: torch.Tensor | None, n_recv: int, rowlen: int, dst, src,
                       consume) -> None:
        """Stream ``send`` (k, rowlen) f32 rows to ``dst`` and ``n_recv`` rows
        from ``src``; ``consume(lo, hi, piece)`` sees flat element ranges."""
        if dst is not None:
            self.sent_bytes += 4 * send.numel()
        self._wire.stream(None if dst is None else send.reshape(-1), n_recv * rowlen,
                          torch.float32, self.group.device if send is None else send.device,
                          dst, None if n_recv == 0 else src, consume)

    def _small_exchange(self, send: torch.Tensor | None, numel: int, dtype, dst, src):
        """One small message each way (counts, indices): returns what came
        from ``src`` (None when nothing)."""
        got = (torch.empty(numel, dtype=dtype, device=self.group.device)
               if src is not None and numel else None)
        if dst is not None:
            self.sent_bytes += send.numel() * send.element_size()
        if dst is None and got is None:
            return None
        dev = self.group.device

        def consume(lo, hi, piece):
            got[lo:hi].copy_(piece)

        self._wire.stream(None if dst is None else send.reshape(-1).to(dev), numel, dtype, dev,
                          dst, None if got is None else src, consume)
        return got

    def _exact_rows(self, t: int, x32: torch.Tensor, ship: torch.Tensor, m: torch.Tensor):
        """The exact-mode mix of one leaf: ``self_w * x + sum_c w_c * recv_c``
        over the rows of the agreed mask ``m`` (R,), the rows of ``ship``
        (1, R, ...) on the wire, clean rows identity."""
        R = m.numel()
        xr = x32.reshape(R, -1)
        rowlen = xr.shape[1]
        if bool(m.all()):  # every row: the dense mix's code path
            out = torch.mul(x32, self._self_w[t])
            flat = out.view(-1)
            send = ship.reshape(-1)
            for w, dst, src in self._plan[t]:
                def consume(lo, hi, piece, w=w):
                    flat[lo:hi].add_(piece, alpha=w)

                self._rows_exchange(send, R, rowlen, dst, src, consume)
            return out
        idx = torch.nonzero(m).reshape(-1)
        k = idx.numel()
        out = x32.clone()
        if k == 0:
            return out
        acc = torch.mul(xr.index_select(0, idx), self._self_w[t])
        send = ship.reshape(R, -1).index_select(0, idx)
        flat = acc.view(-1)
        for w, dst, src in self._plan[t]:
            def consume(lo, hi, piece, w=w):
                flat[lo:hi].add_(piece, alpha=w)

            self._rows_exchange(send, k, rowlen, dst, src, consume)
        out.reshape(R, -1).index_copy_(0, idx, acc)
        return out

    def _masked_compressed(self, t: int, x32: torch.Tensor, m: torch.Tensor, st):
        """The reference's full-buffer framing for a compressed message:
        clean rows zeroed on the wire; error feedback kept on unshipped
        rows; the result masked to identity on clean rows."""
        enc, dec = self._compressor.encode, self._compressor.decode
        me = _exp(m, x32[0][None])[0]
        wire = torch.where(me, x32[0], torch.zeros((), dtype=x32.dtype, device=x32.device))
        if self._stateful_comp:
            msg, new = enc(wire, st[0])
            st[0].copy_(torch.where(me, new, st[0]))
            del new
        else:
            msg, _ = enc(wire, ())
        parts = tree_leaves(msg)
        out = torch.mul(x32, self._self_w[t])
        for w, dst, src in self._plan[t]:
            if dst is not None:
                self.sent_bytes += sum(p.numel() * p.element_size() for p in parts)
            got = self._exchange_msg(parts, dst, src)
            if got is not None:
                out[0].add_(dec(tree_unflatten(msg, got), x32[0]).to(torch.float32), alpha=w)
        return torch.where(_exp(m, x32), out, x32)


    def _delta_compressed(self, t: int, x32: torch.Tensor, m: torch.Tensor):
        """Delta mode's full-buffer framing for a compressed message (the
        reference's): the sender's unshipped rows zeroed, its ``(R,)`` mask
        riding along as a u8 message; receivers substitute their own rows
        for the rows a sender did not ship."""
        enc, dec = self._compressor.encode, self._compressor.decode
        x0 = x32[0]
        me = _exp(m, x0[None])[0]
        msg, _ = enc(torch.where(me, x0, torch.zeros((), dtype=x0.dtype, device=x0.device)), ())
        parts = tree_leaves(msg) + [m.to(torch.uint8)]
        out = torch.mul(x32, self._self_w[t])
        for w, dst, src in self._plan[t]:
            if dst is not None:
                self.sent_bytes += sum(p.numel() * p.element_size() for p in parts)
            got = self._exchange_msg(parts, dst, src)
            if got is None:  # nothing arrives: the reference adds w * x (w is 0)
                out[0].add_(x0, alpha=w)
                continue
            rm = _exp(got[-1] > 0, x0[None])[0]
            out[0].add_(torch.where(rm, dec(tree_unflatten(msg, got[:-1]), x0).to(torch.float32),
                                    x0), alpha=w)
        return out


class SparsePpermuteChannel(_SparseWire, _RowMaskMixin, PpermuteChannel):
    """Row-sparse :class:`~repro_torch.core.gossip.PpermuteChannel` (delay 0).

    Exact mode unions the pending marks with one all-reduce per leaf, so
    every rank holds the same mask, ships the dirty rows, and leaves clean
    rows as they are.  Delta mode ships each sender's own dirty rows with
    their indices; receivers substitute their own rows for the rest."""

    name = "sparse-ppermute"

    def __init__(self, topology: Topology, group, *, mode: str = "exact",
                 crossover: float = 0.9, calls_per_step: int = 1,
                 compression: str | None = None, telemetry: bool = False,
                 chunk_bytes: int = STAGE_CHUNK_BYTES):
        super().__init__(topology, group, compression=compression, telemetry=telemetry,
                         chunk_bytes=chunk_bytes)
        self._check_sparse_args(mode, crossover, calls_per_step)

    def _init_extra(self, template: Tree) -> dict:
        extra = super()._init_extra(template)
        extra["rows"] = self._rows_init(template)
        return extra

    def _delta_rows(self, t: int, x32: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """The delta-mode mix of one leaf: ``self_w * x + sum_c w_c *
        where(recv_mask_c, recv_c, x)``; each sender ships its count, its
        row indices (when not every row) and the rows."""
        R = m.numel()
        xr = x32.reshape(R, -1)
        rowlen = xr.shape[1]
        idx = torch.nonzero(m).reshape(-1)
        k = idx.numel()
        send = xr if k == R else xr.index_select(0, idx)
        count = torch.tensor([k], dtype=torch.int64)
        idx32 = idx.to(torch.int32)
        out = torch.mul(x32, self._self_w[t])
        outr = out.view(R, -1)
        for w, dst, src in self._plan[t]:
            kk = self._small_exchange(count, 1, torch.int64, dst, src)
            kk = 0 if kk is None else int(kk[0])
            ridx = self._small_exchange(idx32 if k < R else None, kk if kk < R else 0,
                                        torch.int32, dst if k < R else None, src)
            if src is None:  # nothing arrives: the reference adds w * x (w is 0)
                self._rows_exchange(send, 0, rowlen, dst, None, None)
                outr.add_(xr, alpha=w)
                continue
            if kk == R:  # every row: added as it arrives
                flat = out.view(-1)

                def consume(lo, hi, piece, w=w):
                    flat[lo:hi].add_(piece, alpha=w)

                self._rows_exchange(send, kk, rowlen, dst, src, consume)
                continue
            got = torch.empty((kk, rowlen), dtype=torch.float32, device=x32.device)
            gflat = got.view(-1)

            def consume(lo, hi, piece):
                gflat[lo:hi].copy_(piece)

            self._rows_exchange(send, kk, rowlen, dst, src, consume)
            ridx = ridx.to(torch.int64) if ridx is not None else ridx
            before = outr.index_select(0, ridx) if kk else None
            outr.add_(xr, alpha=w)
            if kk:
                before.add_(got, alpha=w)
                outr.index_copy_(0, ridx, before)
            del got, before
        return out

    def _sparse_apply(self, state: Tree, tree: Tree, step: int):
        rows = state["rows"]
        period = self.topology.period
        tau = step % period
        leaves = tree_leaves(tree)
        compressed = self._compressor.name != "none"
        comp = state.get("comp", ())
        states = tree_leaves(comp) if compressed and self._stateful_comp else [()] * len(leaves)
        if self.mode == "exact":
            ship = [self._with_crossover(d[0] | self._union(p)[0])
                    for d, p in zip(tree_leaves(rows["dirty"]), tree_leaves(rows["pending"]))]
            new_dirty = [m[None] for m in ship]
        else:
            dirty = [d | p[:, None, :] for d, p in zip(tree_leaves(rows["dirty"]),
                                                       tree_leaves(rows["pending"]))]
            ship = [self._with_crossover(d[0, tau]) for d in dirty]
            call = int(rows["call"].reshape(-1)[0])
            last = (call + 1) % self.sparse_calls == 0
            if last:  # heal once the step's last call has shipped the rows
                for d in dirty:
                    d[:, tau] = False
            new_dirty = dirty
        mixed = []
        for x, m, st in zip(leaves, ship, states):
            x32 = x.to(torch.float32)
            if compressed and self.mode == "delta":
                out = self._delta_compressed(tau, x32, m)
            elif compressed:
                out = self._masked_compressed(tau, x32, m, st)
            elif self.mode == "exact":
                out = self._exact_rows(tau, x32, x32, m)
            else:
                out = self._delta_rows(tau, x32, m)
            mixed.append(out.to(x.dtype))
        sparse_eg = self._sparse_egress(ship, leaves, step, per_sender=False)
        new_rows = self._vol_tick(rows, sparse_eg, self._phase_bytes(tree)[tau])
        new_rows["dirty"] = tree_unflatten(rows["dirty"], new_dirty)
        if self.mode == "delta":
            new_rows["pending"] = (tree_map(torch.zeros_like, rows["pending"]) if last
                                   else rows["pending"])
            new_rows["call"] = torch.full_like(rows["call"], (call + 1) % self.sparse_calls)
        else:
            new_rows["pending"] = tree_map(torch.zeros_like, rows["pending"])
        new_state = {k: v for k, v in state.items() if k != "rows"}
        new_state = self._finish(new_state, tree, step, comp=comp)
        new_state = self._tele_sparse(new_state, state, sparse_eg)
        new_state["rows"] = new_rows
        return new_state, tree_unflatten(tree, mixed)

    def apply(self, state: Tree, tree: Tree, step: int):
        return self._timed(self._sparse_apply, state, tree, step)

    def collectives_per_round(self, payload: Tree, state: Tree | None = None) -> float:
        base = super().collectives_per_round(payload)
        n_leaves = len(tree_leaves(payload))
        if self.mode == "exact":
            return base + n_leaves  # + one mask-union all-reduce per leaf
        # + the count and the indices beside each leaf's rows, per class
        sends = np.mean([len(self.topology.edge_classes(t))
                         for t in range(self.topology.period)])
        return base + 2.0 * float(sends) * n_leaves


class SparseDelayedPpermuteChannel(_SparseWire, _RowMaskMixin, DelayedPpermuteChannel):
    """Row-sparse :class:`~repro_torch.core.gossip.DelayedPpermuteChannel`
    (exact mode only, delay >= 1).

    The ring holds the rank's raw payloads; the wire ships the delayed
    payload's currently dirty rows.  A receiver's clean rows stay its own
    (a row clean under the monotone global mask was in consensus when it
    was published), so the output equals the stacked channel's exact mode
    under the same delay."""

    name = "sparse-delayed-ppermute"

    def __init__(self, topology: Topology, group, delay: int, *, crossover: float = 0.9,
                 calls_per_step: int = 1, telemetry: bool = False,
                 compression: str | None = None, chunk_bytes: int = STAGE_CHUNK_BYTES):
        super().__init__(topology, group, delay, calls_per_step=calls_per_step,
                         telemetry=telemetry, compression=compression,
                         chunk_bytes=chunk_bytes)
        if self.delay < 1:
            raise ValueError("SparseDelayedPpermuteChannel requires delay >= 1 (use "
                             "SparsePpermuteChannel for the undelayed wire path)")
        self._check_sparse_args("exact", crossover, calls_per_step)

    def _init_extra(self, template: Tree) -> dict:
        extra = super()._init_extra(template)
        extra["rows"] = self._rows_init(template)
        return extra

    def _sparse_apply(self, state: Tree, tree: Tree, step: int):
        rows = state["rows"]
        D = [self._with_crossover(d[0] | self._union(p)[0])
             for d, p in zip(tree_leaves(rows["dirty"]), tree_leaves(rows["pending"]))]
        t = step % self.topology.period
        slot = state["delay"]["s0"]
        count = int(slot["count"].reshape(-1)[0])
        pos = count % self._ring
        read = (count - min(self.delay, count)) % self._ring
        leaves = tree_leaves(tree)
        mixed = []
        for x, hist, m in zip(leaves, tree_leaves(slot["hist"]), D):
            x32 = x.to(torch.float32)
            if x32.data_ptr() != hist[:, pos].data_ptr():  # else written there already
                hist[:, pos].copy_(x32)
            mixed.append(self._exact_rows(t, x32, hist[:, read], m).to(x.dtype))
        new_slot = {"hist": slot["hist"],
                    "count": torch.full((1,), count + 1, dtype=torch.int32)}
        # push-time accounting: the payload pushed now ships `delay` rounds
        # later with this mask
        sparse_eg = self._sparse_egress(D, leaves, step, per_sender=False)
        new_rows = self._vol_tick(rows, sparse_eg, self._phase_bytes(tree)[t])
        new_rows["dirty"] = tree_unflatten(rows["dirty"], [m[None] for m in D])
        new_rows["pending"] = tree_map(torch.zeros_like, rows["pending"])
        new_state = {k: v for k, v in state.items() if k != "rows"}
        new_state["delay"] = _rotate_slots(state["delay"], self._slots, new_slot)
        new_state = self._finish(new_state, tree, step)
        new_state = self._tele_sparse(new_state, state, sparse_eg)
        new_state["rows"] = new_rows
        return new_state, tree_unflatten(tree, mixed)

    def apply(self, state: Tree, tree: Tree, step: int):
        return self._timed(self._sparse_apply, state, tree, step)

    def collectives_per_round(self, payload: Tree, state: Tree | None = None) -> float:
        # the parent's wire collectives + one mask-union all-reduce per leaf
        return super().collectives_per_round(payload) + len(tree_leaves(payload))


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def build_sparse_channel(impl: str, topology: Topology, group=None, *, mode: str = "exact",
                         crossover: float = 0.9, delay: int = 0,
                         compression: str | None = None, calls_per_step: int = 1,
                         telemetry: bool = False, chunk_bytes: int = STAGE_CHUNK_BYTES):
    """The sparse counterpart of :func:`~repro_torch.core.gossip.build_channel`
    for ``impl`` in {stacked, ppermute}; ``delay > 0`` selects the delayed
    variant (exact mode only).  ``ppermute`` needs the rank's node group."""
    if impl == "stacked":
        return SparseStackedChannel(topology, delay, mode=mode, crossover=crossover,
                                    calls_per_step=calls_per_step, compression=compression,
                                    telemetry=telemetry)
    if group is None:
        raise ValueError(f"impl={impl!r} needs a node group")
    if impl == "ppermute":
        if delay:
            if mode != "exact":
                raise ValueError("delayed sparse gossip supports mode='exact' only")
            return SparseDelayedPpermuteChannel(topology, group, delay, crossover=crossover,
                                                calls_per_step=calls_per_step,
                                                telemetry=telemetry, compression=compression,
                                                chunk_bytes=chunk_bytes)
        return SparsePpermuteChannel(topology, group, mode=mode, crossover=crossover,
                                     calls_per_step=calls_per_step, compression=compression,
                                     telemetry=telemetry, chunk_bytes=chunk_bytes)
    raise ValueError(f"unknown sparse gossip impl {impl!r} (stacked | ppermute)")
