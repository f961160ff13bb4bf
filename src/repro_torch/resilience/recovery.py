"""Checkpoint-free peer recovery: rejoin from a neighbor's live snapshot
(``repro.resilience.recovery``).

A node that fail-stopped and comes back needs no checkpoint file: a healthy
neighbor's consensus-gated serving snapshot
(:class:`~repro_torch.serve.publisher.WeightPublisher`) holds near-consensus
weights.  Recovery is:

1. clone the donor's snapshot (:meth:`Snapshot.materialize`: the published
   views alias a double buffer the donor rewrites two publishes later);
2. :func:`rejoin_node`: write the cloned parameters into the rejoiner's row
   and zero its momentum and error-feedback rows (stale optimizer state
   would inject a phantom gradient);
3. re-enter the topology through :func:`plan_rejoin` over the still-dead
   set, and trust the peer again (``HealthMonitor.report_alive`` +
   ``with_trust``).

Chaos and resilience bookkeeping (``miss`` counters, trust masks) is
replicated per round and heals itself: it is not row-reset.

The port writes the rows in place (the train state is updated in place
throughout, and on the plane path ``params`` are views of the parameter
planes, so writing a row through them writes the plane).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.gossip import Tree
from ..launch.elastic import RecoveryPlan, plan_recovery
from ..utils import tree_leaves, tree_map

__all__ = ["plan_rejoin", "reset_rows", "rejoin_node"]


def reset_rows(tree: Tree, node: int, n: int) -> Tree:
    """Zero row ``node`` of every leaf with a leading node axis of size
    ``n`` (in place; returns ``tree``); raise for a leaf without one."""
    for leaf in tree_leaves(tree):
        if leaf.ndim == 0 or leaf.shape[0] != n:
            raise ValueError(f"leaf of shape {tuple(leaf.shape)} has no leading node axis of "
                             f"size {n}; cannot row-reset it")
    for leaf in tree_leaves(tree):
        leaf[node].zero_()
    return tree


def rejoin_node(state: dict, node: int, donor_params: Tree, *, params_key: str = "params",
                reset: Sequence[str] = ("opt",)) -> dict:
    """Re-admit ``node`` into a stacked state (host-side call, rows written
    in place): its row of every leaf under ``params_key`` becomes the donor
    snapshot's, and its rows in every ``reset`` bucket (momentum, residuals)
    become zeros.  Returns the state."""
    params = state[params_key]
    lead = {leaf.shape[0] for leaf in tree_leaves(params)}
    if len(lead) != 1:
        raise ValueError(f"inconsistent leading node axes: {sorted(lead)}")
    n = lead.pop()
    if not 0 <= int(node) < n:
        raise ValueError(f"node {node} out of range for n={n}")

    def check(leaf, donor):
        donor = torch.as_tensor(np.asarray(donor) if not isinstance(donor, torch.Tensor)
                                else donor)
        if tuple(donor.shape) != tuple(leaf.shape[1:]):
            raise ValueError(f"donor leaf {tuple(donor.shape)} does not match row "
                             f"{tuple(leaf.shape[1:])}")
        return donor

    donors = tree_map(check, params, donor_params)
    for key in reset:  # every check before the first write
        for leaf in tree_leaves(state[key]):
            if leaf.ndim == 0 or leaf.shape[0] != n:
                raise ValueError(f"leaf of shape {tuple(leaf.shape)} has no leading node axis "
                                 f"of size {n}; cannot row-reset it")
    for leaf, donor in zip(tree_leaves(params), tree_leaves(donors)):
        leaf[int(node)].copy_(donor.to(device=leaf.device, dtype=leaf.dtype))
    for key in reset:
        reset_rows(state[key], int(node), n)
    return state


def plan_rejoin(topology_ref, n_nodes: int, still_dead: Sequence[int]) -> RecoveryPlan:
    """Topology re-entry after a rejoin: the recovery plan over whichever
    peers are still dead (none: the full original topology)."""
    return plan_recovery(topology_ref, n_nodes, sorted(still_dead))
