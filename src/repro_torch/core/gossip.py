"""Gossip transports: the :class:`GossipChannel` protocol and its stacked
transport.

All communication of the paper's partial-averaging operator
``x_i <- sum_j w_ij x_j`` (eq. (3)) goes through a *channel*: a config
object bundling topology and compression, whose dynamic state (telemetry
here; compression residuals and delay rings in later slices) is one dict
tree::

    channel.init(template)              -> state
    channel.apply(state, tree, step)    -> (state, tree)  # one gossip round
    channel.node_gaps(state)            -> per-node version gap

:func:`fleet_node_gaps` reads the per-node gaps on the host, the signal the
serving publisher gates on.

:class:`StackedChannel` is the transport of this slice: leaves carry a
leading node axis ``(n, ...)`` (n replicas on one device) and the mix is the
dense ``W @`` product per leaf in float32, as in ``repro.core.gossip``.
The distributed transports, delayed channels and compression beyond the
identity come with later slices.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import tree_leaves, tree_map
from .compression import get_compressor, wire_bytes
from .topology import Topology

Tree = Any

__all__ = ["GossipChannel", "StackedChannel", "make_stacked_mean", "fleet_node_gaps"]


class GossipChannel:
    """Stateful gossip transport (see the module docstring for the protocol).

    Subclasses set ``topology``, ``compression`` and ``_telemetry`` through
    :meth:`_setup` and implement ``apply``.
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
        return state

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        raise NotImplementedError

    def _finish(self, state: Tree, tree: Tree, step: int) -> Tree:
        """Post-round telemetry tick (rounds + egress bytes)."""
        if not isinstance(state, dict) or "t" not in state:
            return state
        t = state["t"]
        egress = self._phase_bytes(tree)[step % self.topology.period]
        return {
            **state,
            "t": {"bytes": t["bytes"] + float(egress), "rounds": t["rounds"] + 1},
        }

    def node_gaps(self, state: Tree):
        """Per-node worst incident version gap: the scalar 0, since every
        transport of this slice is staleness-free."""
        return 0

    def has_staleness(self) -> bool:
        """Whether the transport can deliver stale payloads (a delayed
        channel); none of this slice's can."""
        return False

    def version_gaps(self, state: Tree):
        raise NotImplementedError("version gaps come with the delayed channels")


class StackedChannel(GossipChannel):
    """Dense ``W @`` transport over stacked ``(n, ...)`` leaves."""

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
        self._W_dev: dict = {}

    def _W(self, t: int, device: torch.device) -> torch.Tensor:
        key = (t, str(device))
        if key not in self._W_dev:
            self._W_dev[key] = torch.from_numpy(self._Ws[t]).to(device)
        return self._W_dev[key]

    def _mix_plain(self, t: int, tree: Tree) -> Tree:
        def leaf(x):
            W = self._W(t, x.device)
            y = W @ x.to(torch.float32).reshape(x.shape[0], -1)
            return y.reshape(x.shape).to(x.dtype)

        return tree_map(leaf, tree)

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        mixed = self._mix_plain(step % self.topology.period, tree)
        return self._finish(state, tree, step), mixed


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
    ``i`` is the worst version gap on any edge incident to node ``i``.  A
    staleness-free channel returns zeros; the version-gap branch comes with
    the delayed channels and raises until then."""
    n = channel.topology.n
    if not channel.has_staleness():
        return np.zeros(n, np.int32)
    raise NotImplementedError(
        "fleet_node_gaps of a delayed channel comes with the delayed channels"
    )
