"""TrainState: stacked per-node parameters + optimizer + channel state.

Every parameter and optimizer leaf carries a leading *node* axis of size
``n_nodes`` — one model replica per decentralized node, all on one device.
The ``"channel"`` bucket is the gossip transport's state.

With a plane layout (:func:`model_plane_layout`, the flat-plane path) the
parameters *live* in stacked ``(n, rows, LANES)`` planes, held under
``"planes"``: ``"params"`` is a tree of views into them (each leaf its
segment's rows, contiguous per node), the optimizer buckets and the channel
state are plane dicts, and the update writes the planes in place.  This
keeps the reference's numbers (its step packs ``params`` and the gradient
anew every step, ``repro/train/step.py:402-404``) without that per-step
pack and unpack: two copies of 10.6 GB at qwen3-0.6b x 4 nodes in f32.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.gossip import GossipChannel
from ..core.optimizers import Optimizer
from ..core.planes import PlaneLayout
from ..models import transformer as T
from ..utils import tree_map

Tree = Any

__all__ = ["init_train_state", "model_plane_layout"]


def model_plane_layout(cfg: ModelConfig) -> PlaneLayout:
    """The flat-plane layout of this model's per-node parameter tree (tp = 1;
    from meta tensors, no allocation).  The step, the state initializer and
    the publisher must all derive it from the same template."""
    return PlaneLayout.build(T.init_params(cfg, torch.Generator(), device="meta"))


def init_train_state(
    cfg: ModelConfig,
    opt: Optimizer,
    n_nodes: int,
    *,
    device: torch.device,
    seed: int = 0,
    channel: GossipChannel | None = None,
    plane_layout: PlaneLayout | None = None,
) -> Tree:
    """One init, copied to every node (as ``repro``'s ``make_train_state_fn``
    broadcasts it).  The copies are real (``repeat``), not an ``expand``:
    the nodes diverge after step 0 and the fused engine updates them in
    place.  With ``plane_layout`` the state is in plane form (module
    docstring): ``opt.init`` and ``channel.init`` of the f32 planes give the
    reference's packed optimizer and channel state, since every initial
    bucket is zeros or a copy of the parameters and pads stay zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen)
    if plane_layout is not None:
        one = plane_layout.pack(params)
        del params
        planes = {k: p.unsqueeze(0).repeat(n_nodes, 1, 1) for k, p in one.items()}
        del one
        template = {k: p.to(torch.float32) for k, p in planes.items()}
        return {
            "step": 0,
            "params": plane_layout.view_unpack(planes, leading=1),
            "planes": planes,
            "opt": opt.init(template),
            "channel": channel.init(template) if channel is not None else {},
        }
    stacked = tree_map(lambda x: x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.ndim), params)
    del params
    return {
        "step": 0,
        "params": stacked,
        "opt": opt.init(stacked),
        "channel": channel.init(stacked) if channel is not None else {},
    }
