"""Fault-tolerant gossip runtime: chaos injection, health tracking,
self-healing mixing and checkpoint-free recovery (``repro.resilience``).

The pieces compose as wrappers around any
:class:`~repro_torch.core.gossip.GossipChannel` —
``ResilientChannel(ChaosChannel(inner))`` injects faults on the wire and
heals them one layer up — on the stacked channels and on the distributed
ones (one process per node).  See each module's docstring for the
contracts.
"""

from .chaos import (
    BitCorrupt,
    ChaosChannel,
    ChaosSchedule,
    Drop,
    Duplicate,
    ExtraDelay,
    Fault,
    NaNInject,
    PeerSilence,
)
from .health import ALIVE, DEAD, SUSPECT, HealthConfig, HealthMonitor, fleet_sender_gaps
from .recovery import plan_rejoin, rejoin_node, reset_rows
from .resilient import ResilientChannel, healed_W, with_trust

__all__ = [
    "ALIVE",
    "BitCorrupt",
    "ChaosChannel",
    "ChaosSchedule",
    "DEAD",
    "Drop",
    "Duplicate",
    "ExtraDelay",
    "Fault",
    "HealthConfig",
    "HealthMonitor",
    "fleet_sender_gaps",
    "NaNInject",
    "PeerSilence",
    "ResilientChannel",
    "SUSPECT",
    "healed_W",
    "plan_rejoin",
    "rejoin_node",
    "reset_rows",
    "with_trust",
]
