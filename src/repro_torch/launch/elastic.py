"""Elastic / fault-tolerance controller (the port of ``repro.launch.elastic``).

Orchestrates the fail-stop -> shrink -> continue lifecycle on top of the
checkpoint and topology primitives, on the host (numpy and the port's own
topology):

* :func:`plan_recovery`: given the surviving node set, decide between
  *rerouting* (same node count, dead nodes excluded from the gossip graph —
  no state surgery, the Metropolis reweighting keeps W doubly stochastic)
  and *rescaling* (consensus-collapse the replicas to a new node count);
* :func:`apply_recovery`: execute the plan against a global state
  (:func:`~repro_torch.train.checkpoint.elastic_reshape` for a rescale).

The end-to-end drill (gather, shrink to n/2, re-form the group, resume)
runs in ``repro_torch.launch.train --simulate-nodes N --failure-drill``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from ..core.topology import Topology, TopologySpec, build_topology
from ..train.checkpoint import elastic_reshape

Tree = Any

__all__ = ["RecoveryPlan", "plan_recovery", "apply_recovery", "survivors_connected"]


def survivors_connected(topo: Topology, dead: Sequence[int]) -> bool:
    """Whether the union-over-phases gossip graph stays connected on the
    survivor set.  Connectivity over the period is the right notion for
    time-varying topologies: one-peer matchings are disconnected in every
    single phase but mix over the cycle.  A disconnected survivor graph
    means a reroute would split-brain (each component converges to its own
    consensus), so the planner must rescale instead."""
    n = topo.n
    gone = set(int(d) for d in dead)
    alive = np.asarray([i for i in range(n) if i not in gone])
    if alive.size <= 1:
        return True
    adj = np.zeros((n, n), bool)
    for t in range(topo.period):
        W = np.abs(np.asarray(topo.W(t)))
        adj |= (W - np.diag(np.diag(W))) > 0
    sub = adj[np.ix_(alive, alive)]
    sub |= sub.T
    reach = np.zeros(alive.size, bool)
    reach[0] = True
    frontier = reach.copy()
    while frontier.any():
        nxt = sub[frontier].any(axis=0) & ~reach
        reach |= nxt
        frontier = nxt
    return bool(reach.all())


def _max_constructible(topology: str | TopologySpec, alive: int) -> tuple[int, Topology]:
    """Largest node count ``<= alive`` the topology family builds at (ring,
    exp and full build anywhere, the matching families want an even n,
    one-peer-exp a power of two), probed downward from ``alive``."""
    if isinstance(topology, Topology):
        raise ValueError(
            "cannot rescale a pre-built Topology instance: pass the family "
            "name or TopologySpec so the survivor-sized graph can be rebuilt"
        )
    for m in range(int(alive), 0, -1):
        try:
            return m, build_topology(topology, m)
        except (AssertionError, ValueError):
            continue
    # a family with a minimum size (one-peer-exp needs n >= 2) degrades to
    # the trivial lone-survivor topology rather than failing the recovery
    return 1, build_topology("full", 1)


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    mode: str  # "reroute" | "rescale"
    n_nodes: int
    topology: Topology
    dead: tuple[int, ...]


def plan_recovery(
    topology: str | TopologySpec | Topology,
    n_nodes: int,
    dead: Sequence[int],
    *,
    allow_reroute: bool = True,
) -> RecoveryPlan:
    """Choose the cheapest recovery for a set of fail-stopped nodes.

    Rerouting keeps the node count (dead indices idle with self-weight 1),
    viable only while the survivor graph stays connected over the
    topology's period and at most ``max(1, n // 8)`` nodes died.  Otherwise
    rescale to the largest node count the topology family builds at,
    probed downward from the survivor count."""
    dead = tuple(sorted(set(int(d) for d in dead)))
    alive = n_nodes - len(dead)
    if alive < 1:
        raise ValueError("no survivors")

    if allow_reroute and len(dead) <= max(1, n_nodes // 8):
        base = build_topology(topology, n_nodes)
        if survivors_connected(base, dead):
            return RecoveryPlan(mode="reroute", n_nodes=n_nodes,
                                topology=base.exclude(dead), dead=dead)
        # few failures, but in the wrong places: a reroute would partition
        # the graph, so collapse to consensus and rescale

    new_n, topo = _max_constructible(topology, alive)
    return RecoveryPlan(mode="rescale", n_nodes=new_n, topology=topo, dead=dead)


def apply_recovery(state: Tree, plan: RecoveryPlan) -> Tree:
    """The global state for the recovered configuration."""
    if plan.mode == "reroute":
        return state  # gossip weights change; per-node state is untouched
    return elastic_reshape(state, plan.n_nodes)
