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

The distributed transports run one process per node
(:mod:`repro_torch.launch.mesh`); each rank holds its payload leaves with a
node axis of size 1, ``(1, ...)``, as a shard_map block does, and talks
over ``torch.distributed``:

* :class:`PpermuteChannel` — one point-to-point exchange per edge class
  (``repro``'s ``ppermute``): ``self_w[i] x_i + sum_c recv_weight_c[i]
  decode(recv_c)`` in f32, in class order, with every compressor; an
  error-feedback residual per rank.  Messages go one at a time, so one
  receive buffer is live (``repro``'s ``serialize=True``).
* :class:`DelayedPpermuteChannel` — a ring of the rank's own raw f32
  payloads, ``calls_per_step`` slots, shipping the one ``delay`` rounds old
  (the oldest recorded during warmup).  Delay 0 runs
  :class:`PpermuteChannel`'s code.
* :class:`AllgatherChannel` — the naive baseline: an all-gather of the
  payload, then the rank's row of ``W``.

Their state gathered over the ranks (node axis first) is ``repro``'s
trainer layout: ring slots ``(n, ring, ...)``, a ``count`` and telemetry
per node.  On gloo with payloads on a card (several ranks sharing it),
every message is copied device -> pinned host -> wire -> pinned host ->
device in chunks of :data:`STAGE_CHUNK_BYTES` (:class:`_Wire`); an
uncompressed message is mixed chunk by chunk as it arrives, so the
receive side holds one chunk, not a payload copy.
:func:`make_psum_mean` is the exact mean over the ranks (an f32
``all_reduce`` sum divided by n).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..launch.costmodel import record_collective
from ..trace import span
from ..utils import tree_leaves, tree_map, tree_unflatten
from .compression import get_compressor, wire_bytes
from .topology import Topology

Tree = Any

__all__ = ["GossipChannel", "StackedChannel", "DelayedStackedChannel", "PpermuteChannel",
           "DelayedPpermuteChannel", "AllgatherChannel", "build_channel", "delay_matrix",
           "make_stacked_mean", "make_psum_mean", "fleet_node_gaps", "gossip_bytes_per_step",
           "STAGE_CHUNK_BYTES"]

# columns per chunk of an accumulated mix: an (n, 2**24) f32 product is
# 256 MiB at 4 nodes
_MIX_COLS = 1 << 24
# bytes per chunk of a distributed message: what one exchange moves, and the
# size of each staging buffer (a pinned host buffer each way, one on the
# device for the receive)
STAGE_CHUNK_BYTES = 1 << 26


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
    with span("gossip.mix"):
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
    _impl = "ppermute"  # byte-accounting model (gossip_bytes_per_step impl)
    _tele_shape: tuple = ()  # (1,) on a distributed rank: gathered, one entry per node

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
                "bytes": torch.zeros(self._tele_shape, dtype=torch.float32, device=dev),
                "rounds": torch.zeros(self._tele_shape, dtype=torch.int32, device=dev),
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
            state = self._tick(state, self._phase_bytes(tree)[step % self.topology.period])
        return state

    @staticmethod
    def _tick(state: dict, egress_bytes: float) -> dict:
        """One round on the telemetry: rounds + 1, egress bytes added in f32."""
        if "t" not in state:
            return state
        t = state["t"]
        return {**state, "t": {"bytes": t["bytes"] + float(np.float32(egress_bytes)),
                               "rounds": t["rounds"] + 1}}

    def bytes_per_step(self, payload_bytes: float, state: Tree | None = None) -> dict:
        """Per-node egress bytes and latency hops of one round (the analytic
        count of :func:`gossip_bytes_per_step`; ``state`` is unused by these
        fixed-payload channels)."""
        return gossip_bytes_per_step(self.topology, payload_bytes, impl=self._impl,
                                     compression=self.compression)

    def collectives_per_round(self, payload: Tree, state: Tree | None = None) -> float:
        """Collective operations one ``apply`` issues for this payload (period
        mean): edge classes x payload leaves x message parts (int8's
        ``{q, scale}``, top-k's ``{v, i}``) on the point-to-point path; the
        stacked channels mix in place and issue none."""
        if self._stacked_layout:
            return 0.0
        probe = torch.zeros((2, 2), dtype=torch.float32)
        msg, _ = self._compressor.encode(probe, self._compressor.init(probe))
        parts = len(tree_leaves(msg))
        sends = np.mean([len(self.topology.edge_classes(t))
                         for t in range(self.topology.period)])
        return float(sends) * len(tree_leaves(payload)) * parts

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
            with span("gossip.codec"):
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


# ---------------------------------------------------------------------------
# Distributed channels: one process per node, leaves (1, ...) on each rank
# ---------------------------------------------------------------------------


class _Wire:
    """Moves one channel's messages between the ranks of a node group.

    A flat tensor goes in chunks of ``chunk_bytes``: for each chunk the send
    and the receive are posted together in one ``dist.batch_isend_irecv``
    and waited on, and the received piece is handed to a ``consume``
    callback before the next chunk reuses its buffer.  With gloo and
    tensors on a card (``NodeGroup.staged``), each chunk is copied to a
    pinned host buffer (a synchronous copy, so the payload's producers have
    finished before the send) and the received bytes back to a device
    buffer.  The buffers are allocated at first use and kept; each is the
    size of the largest chunk it took.  Every rank makes the same calls in
    the same order with the same sizes: that pairs each send with its
    receive.

    Each call is one collective of the cost model
    (:func:`~repro_torch.launch.costmodel.record_collective`): a
    :meth:`stream` one permute of its message, :meth:`gather_stream` one
    all-gather, :meth:`all_reduce_` and :meth:`reduce` one all-reduce.  On a
    dry group (:func:`~repro_torch.launch.mesh.dry_grid`) nothing moves: the
    tensors must be on the meta device, and a receive is a meta tensor."""

    def __init__(self, group, chunk_bytes: int = STAGE_CHUNK_BYTES):
        if chunk_bytes % 8:
            raise ValueError(f"chunk_bytes must be a multiple of 8, got {chunk_bytes}")
        self.group = group
        self.chunk_bytes = int(chunk_bytes)
        self._bufs: dict = {}
        self.staged_bytes = 0  # bytes copied through host memory, both ways

    def _buf(self, name: str, nbytes: int, device, *, host: bool = False) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < nbytes:
            self._bufs.pop(name, None)
            del buf
            if host:  # pinned, where there is a card to copy from
                buf = torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=torch.cuda.is_available())
            else:
                buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
            self._bufs[name] = buf
        return buf[:nbytes]

    def _chunks(self, numel: int, itemsize: int):
        step = max(1, self.chunk_bytes // itemsize)
        return [(lo, min(numel, lo + step)) for lo in range(0, numel, step)]

    def stream(self, send: torch.Tensor | None, numel: int, dtype: torch.dtype, device,
               dst: int | None, src: int | None, consume) -> None:
        """Send the flat contiguous ``send`` to rank ``dst`` and receive
        ``numel`` elements of ``dtype`` from rank ``src`` (either None:
        nothing that way); ``consume(lo, hi, piece)`` sees each received
        element range ``[lo, hi)`` as a tensor on ``device``.  The two
        directions may differ in size: each is chunked on its own and the
        k-th chunks of both go out together, so every message's chunks pair
        with its receiver's."""
        if dst is None and src is None:
            return
        staged, pg = self.group.staged, self.group.pg
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = send.numel() * send.element_size() if send is not None else numel * itemsize
        record_collective("collective-permute", self.group,
                          send.shape if send is not None else (numel,), nbytes, nbytes)
        if self.group.dry:
            _check_meta(send, device)
            if src is not None:
                consume(0, numel, torch.empty(numel, dtype=dtype, device="meta"))
            return
        outs = ([] if dst is None else
                [(lo, hi) for lo, hi in self._chunks(send.numel(), send.element_size())])
        ins = [] if src is None else self._chunks(numel, itemsize)
        for k in range(max(len(outs), len(ins))):
            ops = []
            if k < len(outs):
                lo, hi = outs[k]
                out = send[lo:hi].view(torch.uint8)
                if staged:
                    out = self._buf("send", out.numel(), None, host=True).copy_(out)
                    self.staged_bytes += out.numel()
                ops.append(dist.P2POp(dist.isend, out, self.group.peer(dst), group=pg))
            if k < len(ins):
                lo, hi = ins[k]
                nb = (hi - lo) * itemsize
                into = self._buf("recv", nb, device, host=staged)
                ops.append(dist.P2POp(dist.irecv, into, self.group.peer(src), group=pg))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            if k < len(ins):
                if staged:
                    into = self._buf("recv_dev", nb, device).copy_(into)
                    self.staged_bytes += nb
                consume(lo, hi, into.view(dtype))

    def gather_stream(self, x: torch.Tensor, consume) -> None:
        """All-gather the flat f32 ``x`` chunk by chunk; ``consume(lo, hi,
        pieces)`` sees every rank's elements ``[lo, hi)``, by rank."""
        staged, pg, world = self.group.staged, self.group.pg, self.group.world
        nbytes = x.numel() * 4
        record_collective("all-gather", self.group, x.shape, nbytes, world * nbytes)
        if self.group.dry:
            _check_meta(x)
            consume(0, x.numel(), [torch.empty_like(x) for _ in range(world)])
            return
        for lo, hi in self._chunks(x.numel(), 4):
            nb = (hi - lo) * 4
            mine = x[lo:hi].view(torch.uint8)
            if staged:
                mine = self._buf("send", nb, None, host=True).copy_(mine)
                self.staged_bytes += nb
            slab = self._buf("gather", world * nb, x.device, host=staged)
            dist.all_gather(list(slab.view(world, nb)), mine, group=pg)
            if staged:
                slab = self._buf("gather_dev", world * nb, x.device).copy_(slab)
                self.staged_bytes += world * nb
            consume(lo, hi, [p.view(torch.float32) for p in slab.view(world, nb)])

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the flat f32 ``x`` over the ranks, in place, chunk by chunk."""
        staged, pg = self.group.staged, self.group.pg
        nbytes = x.numel() * x.element_size()
        record_collective("all-reduce", self.group, x.shape, nbytes, nbytes)
        if self.group.dry:
            _check_meta(x)
            return x
        for lo, hi in self._chunks(x.numel(), 4):
            part = x[lo:hi]
            if staged:
                nb = (hi - lo) * 4
                host = self._buf("send", nb, None, host=True).view(torch.float32).copy_(part)
                dist.all_reduce(host, group=pg)
                part.copy_(host)
                self.staged_bytes += 2 * nb
            else:
                dist.all_reduce(part, group=pg)
        return x

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) of the small ``x`` on the group's
        ``comm_device`` over the ranks, in place, in one call."""
        nbytes = x.numel() * x.element_size()
        record_collective("all-reduce", self.group, x.shape, nbytes, nbytes)
        if self.group.dry:
            _check_meta(x)
            return x
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=rop, group=self.group.pg)
        return x


def _check_meta(*tensors) -> None:
    """A dry group moves nothing: it takes meta tensors only."""
    for t in tensors:
        dev = t if isinstance(t, torch.device) or t is None else t.device
        if dev is not None and torch.device(dev).type != "meta":
            raise ValueError(f"a dry group takes meta tensors only, got one on {dev}")


class PpermuteChannel(GossipChannel):
    """Edge-class gossip between processes (``repro``'s ``PpermuteChannel``).

    Rank ``i`` holds payload leaves ``(1, ...)``.  Each edge class of phase
    ``t`` is one exchange: the rank sends its (encoded) payload to
    ``perm[i]`` and receives from the node that sends to it, or nothing
    (where ``ppermute`` gives zeros, and ``recv_weight[i]`` is 0).  The mix
    is ``self_w[i] * x + sum_c recv_weight_c[i] * decode(recv_c)`` in f32,
    the classes in order.  Leaves go one at a time, each through every
    class, so one message is in flight and one receive buffer live at a
    time (the reference's ``serialize=True`` memory contract).  A compressor
    encodes the node's payload ``x[0]`` (threading its residual, updated in
    place), and every tensor of the message is sent.

    ``timings``, when set to a list, receives the host seconds of each
    ``apply`` between two device syncs."""

    name = "ppermute"
    _tele_shape = (1,)

    def __init__(self, topology: Topology, group, *, compression: str | None = None,
                 telemetry: bool = False, chunk_bytes: int = STAGE_CHUNK_BYTES):
        if group.world != topology.n:
            raise ValueError(f"a {topology.n}-node topology on a group of {group.world} ranks")
        self._setup(topology, compression, telemetry)
        self.group = group
        self._wire = _Wire(group, chunk_bytes)
        self.timings: list | None = None
        me = group.rank
        # per phase, per class: (receive weight, send to, receive from)
        self._plan = []
        for t in range(topology.period):
            per_t = []
            for c in topology.edge_classes(t):
                src = [s for s, d in c.pairs if d == me]
                to = c.perm[me]
                per_t.append((float(np.float32(c.recv_weight[me])),
                              None if to < 0 else int(to), src[0] if src else None))
            self._plan.append(per_t)
        self._self_w = [float(np.float32(topology.self_weight(t)[me]))
                        for t in range(topology.period)]

    @property
    def staged_bytes(self) -> int:
        """Bytes this rank copied through host memory so far, both ways."""
        return self._wire.staged_bytes

    def _init_extra(self, template: Tree) -> dict:
        if self._stateful_comp:
            return {"comp": tree_map(self._compressor.init, template)}
        return {}

    def _mix_leaf(self, t: int, x32: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        """``self_w * x32 + sum_c w_c * recv_c`` of an uncompressed message,
        each received chunk added as it arrives."""
        out = torch.mul(x32, self._self_w[t])
        flat, send = out.view(-1), msg.reshape(-1)
        for w, dst, src in self._plan[t]:
            def consume(lo, hi, piece, w=w):
                flat[lo:hi].add_(piece, alpha=w)

            self._wire.stream(send, flat.numel(), torch.float32, flat.device, dst, src, consume)
        return out

    def _exchange_msg(self, parts: list, dst, src) -> list | None:
        """One class of a compressed mix: send every tensor of the message,
        receive one shaped like each (None when nothing arrives)."""
        got = [torch.empty_like(p) for p in parts] if src is not None else None
        for k, p in enumerate(parts):
            flat = p.reshape(-1)
            into = got[k].view(-1) if got is not None else None
            self._wire.stream(flat, flat.numel(), p.dtype, p.device, dst, src,
                              lambda lo, hi, piece, into=into: into[lo:hi].copy_(piece))
        return got

    def _mix(self, t: int, tree: Tree, comp: Tree) -> Tree:
        leaves = tree_leaves(tree)
        compressed = self._compressor.name != "none"
        states = tree_leaves(comp) if compressed and self._stateful_comp else [()] * len(leaves)
        enc, dec = self._compressor.encode, self._compressor.decode
        mixed = []
        for x, st in zip(leaves, states):
            x32 = x.to(torch.float32)
            if not compressed:
                mixed.append(self._mix_leaf(t, x32, x32).to(x.dtype))
                continue
            if self._stateful_comp:
                msg, new = enc(x32[0], st[0])
                st[0].copy_(new)
                del new
            else:
                msg, _ = enc(x32[0], ())
            parts = tree_leaves(msg)
            out = torch.mul(x32, self._self_w[t])
            for w, dst, src in self._plan[t]:
                got = self._exchange_msg(parts, dst, src)
                if got is not None:
                    out[0].add_(dec(tree_unflatten(msg, got), x32[0]).to(torch.float32),
                                alpha=w)
                del got
            del msg, parts
            mixed.append(out.to(x.dtype))
        return tree_unflatten(tree, mixed)

    def _timed(self, fn, *args):
        if self.timings is None:
            return fn(*args)
        cuda = self.group.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.group.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(self.group.device)
        self.timings.append(time.perf_counter() - t0)
        return out

    def _plain_apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        comp = state.get("comp", ()) if isinstance(state, dict) else ()
        mixed = self._mix(step % self.topology.period, tree, comp)
        return self._finish(state, tree, step, comp=comp), mixed

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        return self._timed(self._plain_apply, state, tree, step)

    def node_gaps(self, state: Tree):
        """This rank's worst incident version gap as ``(1,)`` int32 (the
        scalar 0 without staleness)."""
        if not self.has_staleness():
            return 0
        me = self.group.rank
        return torch.from_numpy(_incident_gaps(self.version_gaps(state))[me:me + 1].copy())


class DelayedPpermuteChannel(PpermuteChannel):
    """:class:`PpermuteChannel` holding payloads back ``delay`` rounds
    (``repro``'s ``DelayedPpermuteChannel``).

    Each rank keeps a ring of its own raw f32 payloads, one slot per gossip
    call of the step (``calls_per_step``), each ``{"hist": (1, ring, ...),
    "count": (1,)}``.  A round records the fresh payload at ``count % ring``
    (or finds it there, written by the payload stage through
    :meth:`payload_slot`) and ships the one ``min(delay, count)`` rounds old
    along every edge class; the self-contribution stays current.
    Compression raises, as in the reference.  Delay 0 runs
    :class:`PpermuteChannel`'s code."""

    name = "delayed-ppermute"

    def __init__(self, topology: Topology, group, delay: int, *, calls_per_step: int = 1,
                 telemetry: bool = False, compression: str | None = None,
                 chunk_bytes: int = STAGE_CHUNK_BYTES):
        if compression not in (None, "none"):
            raise ValueError(
                "DelayedPpermuteChannel does not support message compression "
                "yet (the ring buffer stores raw f32 payloads); pass "
                "compression=None or use the delayed stacked channel"
            )
        super().__init__(topology, group, telemetry=telemetry, chunk_bytes=chunk_bytes)
        self.delay = int(delay)
        if self.delay < 0:
            raise ValueError("delay must be non-negative")
        self._depth = self.delay
        self._ring = self.delay + 1
        self._slots = max(1, int(calls_per_step))
        self._gap_mask = _edge_mask(topology)

    def _fresh(self, template: Tree) -> dict:
        hist = tree_map(lambda x: torch.zeros((x.shape[0], self._ring) + tuple(x.shape[1:]),
                                              dtype=torch.float32, device=x.device), template)
        return {"hist": hist, "count": torch.zeros((1,), dtype=torch.int32)}

    def _init_extra(self, template: Tree) -> dict:
        if self._depth == 0:
            return {}
        return {"delay": {f"s{i}": self._fresh(template) for i in range(self._slots)}}

    def payload_slot(self, state: Tree):
        """The next call's ring slot as ``(1, ...)`` views, for the payload
        stage to write into (None at delay 0)."""
        if self._depth == 0:
            return None
        slot = state["delay"]["s0"]
        pos = int(slot["count"][0]) % self._ring
        return tree_map(lambda h: h[:, pos], slot["hist"])

    def _delayed_apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        t = step % self.topology.period
        slot = state["delay"]["s0"]
        count = int(slot["count"][0])
        pos = count % self._ring
        # before warmup, ship the oldest recorded payload (round 0 is fresh)
        read = (count - min(self.delay, count)) % self._ring
        mixed = []
        for x, hist in zip(tree_leaves(tree), tree_leaves(slot["hist"])):
            x32 = x.to(torch.float32)
            if x32.data_ptr() != hist[:, pos].data_ptr():  # else written there already
                hist[:, pos].copy_(x32)
            mixed.append(self._mix_leaf(t, x32, hist[:, read]).to(x.dtype))
        new_slot = {"hist": slot["hist"],
                    "count": torch.full((1,), count + 1, dtype=torch.int32)}
        new_state = {**state, "delay": _rotate_slots(state["delay"], self._slots, new_slot)}
        return self._finish(new_state, tree, step), tree_unflatten(tree, mixed)

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        if self._depth == 0:
            return super().apply(state, tree, step)
        return self._timed(self._delayed_apply, state, tree, step)

    def version_gaps(self, state: Tree) -> np.ndarray:
        if self._depth == 0:
            return super().version_gaps(state)
        return _delayed_version_gaps(state, self.delay * self._gap_mask)


class AllgatherChannel(PpermuteChannel):
    """The naive baseline (``repro``'s ``AllgatherChannel``): all-gather the
    f32 payload over the ranks, then reduce with this rank's row of ``W``,
    ``sum_j W[i, j] x_j`` in the order of ``j``, a chunk at a time.  No
    compression, no delay."""

    name = "allgather"
    _impl = "allgather"

    def __init__(self, topology: Topology, group, *, telemetry: bool = False,
                 chunk_bytes: int = STAGE_CHUNK_BYTES):
        super().__init__(topology, group, telemetry=telemetry, chunk_bytes=chunk_bytes)
        self._rows = [np.asarray(topology.W(t), np.float32)[group.rank]
                      for t in range(topology.period)]

    def _plain_apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        row = self._rows[step % self.topology.period]
        mixed = []
        for x in tree_leaves(tree):
            x32 = x.to(torch.float32)
            out = torch.empty_like(x32)
            flat = out.view(-1)

            def consume(lo, hi, pieces, flat=flat):
                dst = torch.mul(pieces[0], float(row[0]), out=flat[lo:hi])
                for j in range(1, len(pieces)):
                    dst.add_(pieces[j], alpha=float(row[j]))

            self._wire.gather_stream(x32.reshape(-1), consume)
            mixed.append(out.to(x.dtype))
        if isinstance(state, dict):
            state = self._tick(state, (self.topology.n - 1) * self._payload_nbytes(tree))
        return state, tree_unflatten(tree, mixed)

    def collectives_per_round(self, payload: Tree, state: Tree | None = None) -> float:
        # one raw-f32 all_gather per payload leaf, whatever the topology
        return float(len(tree_leaves(payload)))


def build_channel(impl: str, topology: Topology, group=None, *, compression: str | None = None,
                  delay: int = 0, calls_per_step: int = 1, telemetry: bool = False,
                  chunk_bytes: int = STAGE_CHUNK_BYTES) -> GossipChannel:
    """The channel for ``impl`` in {stacked, ppermute, allgather}
    (``repro.core.gossip.build_channel``); ``delay > 0`` selects the delayed
    variant.  The distributed ones need the rank's node ``group``."""
    if impl == "stacked":
        if delay:
            return DelayedStackedChannel(topology, delay, calls_per_step=calls_per_step,
                                         compression=compression, telemetry=telemetry)
        return StackedChannel(topology, compression=compression, telemetry=telemetry)
    if group is None:
        raise ValueError(f"impl={impl!r} needs a node group")
    if impl == "ppermute":
        if delay:
            return DelayedPpermuteChannel(topology, group, delay, calls_per_step=calls_per_step,
                                          telemetry=telemetry, compression=compression,
                                          chunk_bytes=chunk_bytes)
        return PpermuteChannel(topology, group, compression=compression, telemetry=telemetry,
                               chunk_bytes=chunk_bytes)
    if impl == "allgather":
        if delay:
            raise ValueError("allgather has no delayed variant (O(n) baseline)")
        if compression not in (None, "none"):
            raise ValueError(
                "impl='allgather' cannot compress (the payload is all-gathered"
                " raw); pass compression=None or use impl='ppermute'"
            )
        return AllgatherChannel(topology, group, telemetry=telemetry, chunk_bytes=chunk_bytes)
    raise ValueError(f"unknown gossip impl {impl!r}")


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


def make_psum_mean(group, n_nodes: int):
    """Exact average over the ranks of ``group`` (PmSGD / SlowMo sync): each
    leaf's f32 ``all_reduce`` sum divided by ``n_nodes``, in the leaf's
    dtype (``repro``'s ``psum(x) / n``).  Gloo sums in its own order, so it
    equals the stacked mean to rounding only."""
    wire = _Wire(group)

    def mean(tree):
        def leaf(x):
            y = x.to(torch.float32, copy=True)
            wire.all_reduce_(y.view(-1))
            return y.div_(n_nodes).to(x.dtype)

        return tree_map(leaf, tree)

    return mean


def fleet_node_gaps(channel: GossipChannel, state: Tree) -> np.ndarray:
    """Host-side ``(n,)`` per-node consensus gaps for the whole fleet: entry
    ``i`` is the worst version gap on any edge incident to node ``i``, in
    either direction — the vector :meth:`GossipChannel.node_gaps` gives the
    step.  Staleness-free channels return zeros.  A distributed channel
    gathers every rank's own gap (a collective: every rank calls it)."""
    n = channel.topology.n
    if not channel.has_staleness():
        return np.zeros(n, np.int32)
    if channel._stacked_layout:
        return _incident_gaps(channel.version_gaps(state)).astype(np.int32)
    group = channel.group
    mine = torch.as_tensor(channel.node_gaps(state), dtype=torch.int64).to(group.comm_device)
    every = [torch.empty_like(mine) for _ in range(group.world)]
    dist.all_gather(every, mine, group=group.pg)
    return torch.cat(every).cpu().numpy().astype(np.int32)


def gossip_bytes_per_step(topology: Topology, payload_bytes: float, *, impl: str = "ppermute",
                          compression: str | None = None) -> dict[str, float]:
    """Per-node egress bytes and latency hops of one gossip round (averaged
    over the topology period), ``repro.core.gossip.gossip_bytes_per_step``.
    The allgather baseline ships raw f32 and cannot compress."""
    n = topology.n
    if impl == "allgather":
        if compression is not None:
            raise ValueError(
                "impl='allgather' cannot compress: the payload is all-gathered raw before the "
                "local W-row reduction; pass compression=None or use impl='ppermute'"
            )
        return {"egress_bytes": (n - 1) / n * payload_bytes * n, "hops": n - 1}
    per_payload = wire_bytes(payload_bytes, compression)
    sends = np.mean([len(topology.edge_classes(t)) for t in range(topology.period)])
    return {"egress_bytes": float(sends) * per_payload, "hops": float(sends)}
