"""TrainState: stacked per-node parameters + optimizer + channel state.

Every parameter and optimizer leaf carries a leading *node* axis of size
``n_nodes`` — one model replica per decentralized node, all on one device.
The ``"channel"`` bucket is the gossip transport's state.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.gossip import GossipChannel
from ..core.optimizers import Optimizer
from ..models import transformer as T
from ..utils import tree_map

Tree = Any

__all__ = ["init_train_state"]


def init_train_state(
    cfg: ModelConfig,
    opt: Optimizer,
    n_nodes: int,
    *,
    device: torch.device,
    seed: int = 0,
    channel: GossipChannel | None = None,
) -> Tree:
    """One init, copied to every node (as ``repro``'s ``make_train_state_fn``
    broadcasts it).  The copies are real (``repeat``), not an ``expand``:
    the nodes diverge after step 0 and the fused engine updates them in
    place."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen)
    stacked = tree_map(lambda x: x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.ndim), params)
    del params
    return {
        "step": 0,
        "params": stacked,
        "opt": opt.init(stacked),
        "channel": channel.init(stacked) if channel is not None else {},
    }
