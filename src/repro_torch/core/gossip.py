"""Gossip transports: the :class:`GossipChannel` protocol and its stacked
transports.

All communication of the paper's partial-averaging operator
``x_i <- sum_j w_ij x_j`` (eq. (3)) goes through a *channel*: a config
object bundling topology, compression and staleness, whose dynamic state
(compression error feedback, delay rings, telemetry) is one dict tree::

    channel.init(template)              -> state
    channel.apply(state, tree, step)    -> (state, tree)  # one gossip round
    channel.version_gaps(state)         -> (n, n) per-edge version gaps
    channel.node_gaps(state)            -> (n,) worst incident gap per node

:func:`fleet_node_gaps` reads the per-node gaps on the host, the signal the
serving publisher gates on.

The transports of this port keep n replicas on one device, leaves carrying
a leading node axis ``(n, ...)``, as ``repro.core.gossip``'s stacked
channels do:

* :class:`StackedChannel` — the dense ``W @`` mix per leaf in float32;
  with ``compression``, each node's payload is encoded and decoded before
  the off-diagonal mix, ``diag * x32 + Woff @ xhat``.  The products are
  elementwise sums in a fixed order (:func:`_accumulate`), so that a leaf
  mixes to the same bits alone and inside a plane.
* :class:`DelayedStackedChannel` — per-edge delays with ring buffers,
  ``x_i <- w_ii x_i(t) + sum_j w_ij x_j(t - d_ij)``.  At uniform delay 0
  it runs :class:`StackedChannel`'s code, so it equals it bit for bit.

The state layout is that of ``repro``'s stacked channels: the telemetry is
two scalars, a residual mirrors the stacked payload, and each ring slot
``s<i>`` holds ``hist`` leaves of shape ``(ring, n, ...)`` and a scalar
``count``.  (``repro``'s trainer holds ``DelayedPpermuteChannel``'s per-node
state instead, node axis first: ``(n, ring, ...)`` and a ``count`` per
node; a resume across the packages re-initializes what does not match.)

To fit the card, ``apply`` updates the state's residuals and ring slots in
place and returns them in the new state: the caller passes each state on
once and does not reuse it.  An uncompressed delayed channel also offers
its next ring slot (:meth:`GossipChannel.payload_slot`), which
``run_update`` hands to the payload stage as its output buffer, so that
the payload is written into the ring and never beside it.  The ring's
``count`` is a CPU tensor, so that picking a slot and reading the version
gaps need no device sync.  A mix accumulates its terms into its output a
column chunk at a time, in the reference's group order, instead of
materializing one ``W_d @ stale`` product per delay group.

The distributed transports come with a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import tree_leaves, tree_map, tree_unflatten
from .compression import get_compressor, wire_bytes
from .topology import Topology

Tree = Any

__all__ = ["GossipChannel", "StackedChannel", "DelayedStackedChannel", "delay_matrix",
           "make_stacked_mean", "fleet_node_gaps"]

# columns per chunk of an accumulated mix: an (n, 2**24) f32 product is
# 256 MiB at 4 nodes
_MIX_COLS = 1 << 24


def delay_matrix(n: int, delay) -> np.ndarray:
    """Normalize a delay spec (int or ``(n, n)`` array) to an int matrix with
    a zero diagonal (self-contributions are never stale)."""
    if np.isscalar(delay):
        D = np.full((n, n), int(delay), dtype=np.int64)
    else:
        D = np.asarray(delay, dtype=np.int64).copy()
        if D.shape != (n, n):
            raise ValueError(f"delay matrix must be ({n}, {n}), got {D.shape}")
    if (D < 0).any():
        raise ValueError("delays must be non-negative")
    np.fill_diagonal(D, 0)
    return D


def _fresh_slot(template: Tree, ring: int) -> dict:
    hist = tree_map(
        lambda x: torch.zeros((ring,) + tuple(x.shape), dtype=torch.float32, device=x.device),
        template,
    )
    return {"hist": hist, "count": torch.zeros((), dtype=torch.int32)}


def _rotate_slots(slots: dict, n_slots: int, new_slot: dict) -> dict:
    """Consume slot s0, shift the rest down, append the updated slot last —
    each gossip call within a step keeps its own history."""
    keys = [f"s{i}" for i in range(n_slots)]
    rotated = {keys[i]: slots[keys[i + 1]] for i in range(n_slots - 1)}
    rotated[keys[-1]] = new_slot
    return rotated


def _delayed_version_gaps(state: Tree, masked_D: np.ndarray) -> np.ndarray:
    """Shared warmup-gap rule: count is post-apply, so the round just
    executed used ``d_eff = min(d, count - 1)`` (warmup reads the oldest
    recorded payload; round 0 is fresh)."""
    last = max(int(state["delay"]["s0"]["count"]) - 1, 0)
    return np.minimum(masked_D, last).astype(np.int32)


def _incident_gaps(gaps: np.ndarray) -> np.ndarray:
    """Per-node worst *incident*-edge gap from an ``(n, n)`` gap matrix —
    both directions (see :meth:`GossipChannel.node_gaps`)."""
    return np.maximum(gaps.max(axis=1), gaps.max(axis=0))


def _edge_mask(topology: Topology) -> np.ndarray:
    """Union over period phases of the off-diagonal gossip support."""
    mask = np.zeros((topology.n, topology.n), dtype=np.int64)
    for t in range(topology.period):
        W = topology.W(t)
        mask |= (np.abs(W - np.diag(np.diag(W))) > 0).astype(np.int64)
    return mask


def _accumulate(out: torch.Tensor, terms, base=None) -> None:
    """``out = base + W_1 @ s_1 + W_2 @ s_2 + ...`` on ``(n, N)`` f32
    operands, left to right as the reference adds its ``einsum`` products:
    each product is summed whole (over its sources ``j`` in ascending
    order, zero weights skipped), then added.  ``W_k`` are host matrices,
    ``base`` is ``(x, d)`` for ``d[i] * x[i]`` or None (the sum starts with
    the first product).

    Every element is computed from its own column by the same elementwise
    ops, whatever the width of the operand: cuBLAS's product of the same
    4 x 4 weights with an (n, 3584) leaf and with the plane holding it
    rounds differently, so a plane mix would not equal a per-leaf mix bit
    for bit.  Rows go one chunk of ``_MIX_COLS`` columns at a time, so that
    a group's product needs only a chunk-sized temporary."""
    n, N = out.shape
    for c0 in range(0, N, _MIX_COLS):
        cols = slice(c0, min(N, c0 + _MIX_COLS))
        for i in range(n):
            dst = out[i, cols]
            started = base is not None
            if started:
                torch.mul(base[0][i, cols], float(base[1][i]), out=dst)
            for W, src in terms:
                js = np.flatnonzero(W[i])
                if not len(js):
                    continue
                acc = torch.mul(src[js[0], cols], float(W[i, js[0]]),
                                out=None if started else dst)
                for j in js[1:]:
                    acc.add_(src[j, cols], alpha=float(W[i, j]))
                if started:
                    dst.add_(acc)
                started = True
            if not started:
                dst.zero_()


class GossipChannel:
    """Stateful gossip transport (see the module docstring for the protocol).

    Subclasses set ``topology``, ``compression`` and ``_telemetry`` through
    :meth:`_setup` and implement ``apply`` (and ``_init_extra`` for state of
    their own).
    """

    name = "gossip"
    _stacked_layout = False  # True when payload leaves carry the (n, ...) axis

    topology: Topology
    compression: str | None

    def _setup(self, topology: Topology, compression: str | None, telemetry: bool):
        self.topology = topology
        self.compression = compression
        self._compressor = get_compressor(compression)
        self._telemetry = bool(telemetry)
        # stateful compressors (error feedback) carry a residual mirroring
        # the payload; stateless ones return ()
        self._stateful_comp = isinstance(self._compressor.init(torch.zeros(1)), torch.Tensor)

    @staticmethod
    def _payload_nbytes(tree: Tree) -> float:
        """f32 wire size of one payload copy (from the leaf shapes)."""
        return 4.0 * sum(float(np.prod(tuple(x.shape))) for x in tree_leaves(tree))

    def _phase_bytes(self, tree: Tree) -> list[float]:
        """Per-phase per-node egress bytes, indexable by ``step % period``."""
        nbytes = self._payload_nbytes(tree)
        if self._stacked_layout:
            nbytes /= self.topology.n
        per_payload = wire_bytes(nbytes, self.compression)
        return [
            len(self.topology.edge_classes(t)) * per_payload
            for t in range(self.topology.period)
        ]

    def init(self, template: Tree) -> dict:
        """Zero state for payloads shaped like ``template``."""
        state: dict = {}
        if self._telemetry:
            dev = tree_leaves(template)[0].device
            state["t"] = {
                "bytes": torch.zeros((), dtype=torch.float32, device=dev),
                "rounds": torch.zeros((), dtype=torch.int32, device=dev),
            }
        state.update(self._init_extra(template))
        return state

    def _init_extra(self, template: Tree) -> dict:
        return {}

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        raise NotImplementedError

    def _finish(self, state: Tree, tree: Tree, step: int, comp: Tree | None = None) -> Tree:
        """Post-round writeback: the compression state (when the state
        carries a ``"comp"`` node) and the telemetry tick (rounds + egress
        bytes, accumulated in f32 as the reference does)."""
        if not isinstance(state, dict):
            return state
        if "comp" in state and comp is not None:
            state = {**state, "comp": comp}
        if "t" in state:
            t = state["t"]
            egress = self._phase_bytes(tree)[step % self.topology.period]
            state = {
                **state,
                "t": {"bytes": t["bytes"] + float(np.float32(egress)),
                      "rounds": t["rounds"] + 1},
            }
        return state

    def has_staleness(self) -> bool:
        """Whether the transport can deliver stale payloads (a configured
        delay ring)."""
        return getattr(self, "_depth", 0) > 0

    def payload_slot(self, state: Tree):
        """The buffers the next ``apply`` records its payload in, for the
        payload's producer to write straight into (None: no such buffer)."""
        return None

    def version_gaps(self, state: Tree) -> np.ndarray:
        """``(n, n)`` int32 of per-edge iterate-version gaps of the most
        recent ``apply``: zeros for undelayed channels."""
        return np.zeros((self.topology.n, self.topology.n), np.int32)

    def node_gaps(self, state: Tree):
        """Per-node worst version gap on any edge *incident* to the node, in
        either direction (payloads it consumed stale, and the age at which
        its own payloads reach its readers): ``(n,)`` int32 for a delayed
        channel, the scalar 0 for a staleness-free one.  Staleness-aware
        algorithms fold it into their update
        (:func:`~repro_torch.core.update_spec.staleness_damping`)."""
        if not self.has_staleness():
            return 0
        return torch.from_numpy(_incident_gaps(self.version_gaps(state)))


class StackedChannel(GossipChannel):
    """Dense ``W @`` transport over stacked ``(n, ...)`` leaves, optionally
    compressed (each node encodes its payload; the mix reads the decoded
    payloads off the diagonal and the raw one on it)."""

    name = "stacked"
    _stacked_layout = True

    def __init__(
        self,
        topology: Topology,
        *,
        compression: str | None = None,
        telemetry: bool = False,
    ):
        self._setup(topology, compression, telemetry)
        self._Ws = [np.asarray(topology.W(t), np.float32) for t in range(topology.period)]
        self._diags = [np.diag(W).copy() for W in self._Ws]
        self._Woffs = [W - np.diag(np.diag(W)) for W in self._Ws]

    def _init_extra(self, template: Tree) -> dict:
        if self._stateful_comp:
            return {"comp": tree_map(self._compressor.init, template)}
        return {}

    def _mix_plain(self, t: int, tree: Tree) -> Tree:
        def leaf(x):
            x32 = x.to(torch.float32).reshape(x.shape[0], -1)
            y = torch.empty_like(x32)
            _accumulate(y, [(self._Ws[t], x32)])
            return y.reshape(x.shape).to(x.dtype)

        return tree_map(leaf, tree)

    def _encode_decode(self, x32: torch.Tensor, st, dest: torch.Tensor) -> None:
        """Encode each node's payload ``x32[i]`` (threading its residual
        ``st[i]``, updated in place) and write what the wire delivers,
        decoded, into ``dest[i]``: one node's temporaries at a time."""
        enc, dec = self._compressor.encode, self._compressor.decode
        for i in range(x32.shape[0]):
            if self._stateful_comp:
                msg, new = enc(x32[i], st[i])
                st[i].copy_(new)
                del new
            else:
                msg, _ = enc(x32[i], ())
            dest[i].copy_(dec(msg, x32[i]))
            del msg

    def _mix_compressed(self, t: int, tree: Tree, comp: Tree) -> Tree:
        leaves = tree_leaves(tree)
        states = tree_leaves(comp) if self._stateful_comp else [()] * len(leaves)
        outs = []
        for x, st in zip(leaves, states):
            x32 = x.to(torch.float32)
            xhat = torch.empty_like(x32)
            self._encode_decode(x32, st, xhat)
            n = x.shape[0]
            flat = x32.reshape(n, -1)
            y = torch.empty_like(flat)
            _accumulate(y, [(self._Woffs[t], xhat.reshape(n, -1))], base=(flat, self._diags[t]))
            del xhat
            outs.append(y.reshape(x.shape).to(x.dtype))
        return tree_unflatten(tree, outs)

    def _plain_apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        t = step % self.topology.period
        if self._compressor.name == "none":
            return self._finish(state, tree, step), self._mix_plain(t, tree)
        comp = state.get("comp", ()) if isinstance(state, dict) else ()
        mixed = self._mix_compressed(t, tree, comp)
        return self._finish(state, tree, step, comp=comp), mixed

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        return self._plain_apply(state, tree, step)


class DelayedStackedChannel(StackedChannel):
    """Stacked gossip with per-edge delay ring buffers (bounded staleness).

    Every edge carries a fixed integer delay and the receiver mixes the
    sender's payload from ``d_ij`` gossip rounds ago.  Before the buffers
    warm up every edge reads the oldest payload recorded so far, so round 0
    is fresh gossip.  ``delay`` is an int or an ``(n, n)`` matrix; for
    algorithms with more than one gossip per step (da-dmsgd) pass
    ``calls_per_step=opt.gossips_per_step``: each call keeps its own ring
    slot.  With compression the ring stores the *decoded* payloads (what the
    wire delivered) and the self-contribution stays raw and current.
    """

    name = "delayed-stacked"

    def __init__(
        self,
        topology: Topology,
        delay,
        *,
        calls_per_step: int = 1,
        compression: str | None = None,
        telemetry: bool = False,
    ):
        super().__init__(topology, compression=compression, telemetry=telemetry)
        self._D = delay_matrix(topology.n, delay)
        self._depth = int(self._D.max())
        self._ring = self._depth + 1
        self._slots = max(1, int(calls_per_step))
        self._gap_mask = _edge_mask(topology)
        # per-phase, per-delay weight matrices: W_t masked to the edges of
        # delay d.  The uncompressed mix keeps the diagonal inside the d = 0
        # group (the slot just written is the current payload), the
        # compressed one takes the raw diagonal apart and off-diagonal
        # groups: the reference's two reduction orders
        self._groups: list[list[tuple[int, np.ndarray]]] = []
        self._groups_off: list[list[tuple[int, np.ndarray]]] = []
        for W, Woff in zip(self._Ws, self._Woffs):
            per_t, per_t_off = [], []
            for d in (int(v) for v in np.unique(self._D)):
                Wd = np.where(self._D == d, W, 0.0).astype(np.float32)
                if (Wd != 0.0).any():
                    per_t.append((d, Wd))
                Wdo = np.where(self._D == d, Woff, 0.0).astype(np.float32)
                if (Wdo != 0.0).any():
                    per_t_off.append((d, Wdo))
            self._groups.append(per_t)
            self._groups_off.append(per_t_off)

    def _init_extra(self, template: Tree) -> dict:
        extra = super()._init_extra(template)
        if self._depth > 0:
            extra["delay"] = {
                f"s{i}": _fresh_slot(template, self._ring) for i in range(self._slots)
            }
        return extra

    def payload_slot(self, state: Tree):
        """An uncompressed delay ring records the raw f32 payload: the next
        call's ring slot, as views, so that the update's payload stage
        writes it there and no payload copy sits beside the ring."""
        if self._depth == 0 or self._compressor.name != "none":
            return None
        slot = state["delay"]["s0"]
        pos = int(slot["count"]) % self._ring
        return tree_map(lambda h: h[pos], slot["hist"])

    def _apply_phase(self, t: int, tree: Tree, slot: dict, comp: Tree) -> tuple[Tree, dict]:
        """One delayed mix: record the (decoded, when compressed) payload in
        the ring slot, then combine the per-delay groups."""
        count = int(slot["count"])
        pos = count % self._ring
        leaves = tree_leaves(tree)
        hists = tree_leaves(slot["hist"])
        compressed = self._compressor.name != "none"
        groups = self._groups_off[t] if compressed else self._groups[t]
        states = tree_leaves(comp) if compressed and self._stateful_comp else [()] * len(leaves)
        mixed = []
        for x, hist, st in zip(leaves, hists, states):
            x32 = x.to(torch.float32)
            n, dev = x.shape[0], x.device
            if compressed:
                self._encode_decode(x32, st, hist[pos])
            elif x32.data_ptr() != hist[pos].data_ptr():  # else written there already
                hist[pos].copy_(x32)
            # before warmup, fall back to the oldest recorded payload
            terms = [(Wd, hist[(count - min(d, count)) % self._ring].reshape(n, -1))
                     for d, Wd in groups]
            out = torch.empty((n, x32[0].numel()), dtype=torch.float32, device=dev)
            _accumulate(out, terms,
                        base=(x32.reshape(n, -1), self._diags[t]) if compressed else None)
            mixed.append(out.reshape(x.shape).to(x.dtype))
        new_slot = {"hist": slot["hist"], "count": torch.tensor(count + 1, dtype=torch.int32)}
        return tree_unflatten(tree, mixed), new_slot

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        if self._depth == 0:
            return self._plain_apply(state, tree, step)
        comp = state.get("comp", ())
        mixed, new_slot = self._apply_phase(step % self.topology.period, tree,
                                            state["delay"]["s0"], comp)
        new_state = {**state, "delay": _rotate_slots(state["delay"], self._slots, new_slot)}
        return self._finish(new_state, tree, step, comp=comp), mixed

    def version_gaps(self, state: Tree) -> np.ndarray:
        if self._depth == 0:
            return super().version_gaps(state)
        return _delayed_version_gaps(state, self._D * self._gap_mask)


def make_stacked_mean(n_nodes: int):
    """Exact global average, broadcast back to every node (stacked layout).
    The result is materialized (not an expanded view), so a stage kernel can
    read it as a contiguous buffer."""

    def mean(tree):
        def leaf(x):
            m = torch.mean(x.to(torch.float32), dim=0, keepdim=True)
            return m.expand(x.shape).to(x.dtype).contiguous()

        return tree_map(leaf, tree)

    return mean


def fleet_node_gaps(channel: GossipChannel, state: Tree) -> np.ndarray:
    """Host-side ``(n,)`` per-node consensus gaps for the whole fleet: entry
    ``i`` is the worst version gap on any edge incident to node ``i``, in
    either direction — the vector :meth:`GossipChannel.node_gaps` gives the
    step.  Staleness-free channels return zeros."""
    n = channel.topology.n
    if not channel.has_staleness():
        return np.zeros(n, np.int32)
    return _incident_gaps(channel.version_gaps(state)).astype(np.int32)
