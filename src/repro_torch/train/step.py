"""The decentralized train step for ``n`` nodes stacked on one device.

Per step:

1. each node's gradient of ``forward_loss`` over its batch shard, computed
   node by node so that only one node's activations are alive at a time,
   written into slot ``i`` of the stacked gradient tree;
2. the finite guard: a node whose gradient norm is non-finite has its
   gradient zeroed before the update (its payload stays finite, so its
   neighbours keep mixing clean iterates) and its optimizer state restored
   after it;
3. the algorithm's update tail through ``run_update`` with the stacked
   ``W @`` channel and the stacked mean — either the reference optimizer
   step or, with ``fused_update``, the fused stage engine
   (:mod:`repro_torch.kernels.fused_update`) writing ``x`` and ``m`` in
   place.

This is the single-device counterpart of ``repro.train.step``'s shard_map
step; the distributed transports come with a later slice.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.gossip import StackedChannel, make_stacked_mean
from ..core.optimizers import OptimizerConfig, make_optimizer
from ..core.schedules import ScheduleConfig, build_schedule
from ..core.topology import build_topology
from ..core.update_spec import run_update, update_spec
from ..kernels.fused_update import make_stage
from ..models import transformer as T
from ..utils import tree_leaves, tree_unflatten

Tree = Any

__all__ = ["TrainConfig", "build_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``repro.train.step.TrainConfig`` that the trainer sets in
    this slice.  No ``grad_clip``: on stacked trees ``grad_scalars`` takes one
    norm over all nodes, while repro's step clips each node by its own norm."""

    algorithm: str = "decentlam"
    topology: str = "exp"
    momentum: float = 0.9
    schedule: ScheduleConfig = ScheduleConfig()
    fused_update: bool = False
    fused_impl: str = "triton"  # triton | torch (the kernel's plain version)
    # skip a node's optimizer update when its grad norm goes non-finite (the
    # skip count surfaces as the "skipped_nonfinite" metric)
    finite_guard: bool = True

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(
            algorithm=self.algorithm,
            momentum=self.momentum,
        )


def _node_grads(params: Tree, batch: dict, cfg: ModelConfig, n_nodes: int):
    """Per-node loss and gradient, one node at a time, into a stacked f32
    gradient tree.  Returns ``(grads, losses (n,))``."""
    leaves = tree_leaves(params)
    g_leaves = [torch.empty(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    b = batch["tokens"].shape[0] // n_nodes
    losses = []
    for i in range(n_nodes):
        leaves_i = [p[i].detach().requires_grad_() for p in leaves]
        batch_i = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        loss, _ = T.forward_loss(tree_unflatten(params, leaves_i), batch_i, cfg)
        for gl, gi in zip(g_leaves, torch.autograd.grad(loss, leaves_i)):
            gl[i].copy_(gi)
        losses.append(loss.detach())
    return tree_unflatten(params, g_leaves), torch.stack(losses)


def _node_grad_norms(grads: Tree, n_nodes: int) -> torch.Tensor:
    """(n,) f32 global gradient norm per node.  Float32 accumulation of the
    squares, so it is non-finite exactly when the reference's sum of squares
    is."""
    per_leaf = [
        torch.linalg.vector_norm(gl.reshape(n_nodes, -1), dim=1) for gl in tree_leaves(grads)
    ]
    return torch.linalg.vector_norm(torch.stack(per_leaf, dim=1), dim=1)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, n_nodes: int):
    """Returns ``(train_step, channel)``.

    ``train_step(state, batch) -> (state, metrics)``: ``state`` is an
    :func:`~repro_torch.train.train_state.init_train_state` dict (it is
    updated in place on the fused path and must not be reused); ``batch``
    holds ``(n_nodes * per_node_batch, seq)`` tokens and targets, node ``i``
    owning rows ``[i * b, (i + 1) * b)``.  The returned channel is the
    transport the step gossips through: pass it to ``init_train_state``.
    """
    topology = build_topology(tcfg.topology, n_nodes)
    if tcfg.algorithm == "decentlam" and topology.period > 1 and tcfg.momentum > 0.5:
        warnings.warn(
            "DecentLaM's convergence analysis assumes a static mixing matrix"
            " (paper Assumption A.3); with time-varying topologies the"
            f" momentum on the gossip penalty can resonate at beta="
            f"{tcfg.momentum} > 0.5. Consider beta <= 0.5 or a static topology.",
            stacklevel=2,
        )
    ocfg = tcfg.opt_config()
    opt = make_optimizer(ocfg)
    spec = update_spec(ocfg)
    lr_fn = build_schedule(tcfg.schedule)
    channel = StackedChannel(topology, telemetry=True)
    mean = make_stacked_mean(n_nodes)
    stage = make_stage(tcfg.fused_impl, inplace=True) if tcfg.fused_update else None

    def train_step(state: Tree, batch: dict):
        params, opt_state = state["params"], state["opt"]
        step_idx = state["step"]
        dev = tree_leaves(params)[0].device
        lr = torch.full((), lr_fn(step_idx), dtype=torch.float32, device=dev)

        grads, losses = _node_grads(params, batch, cfg, n_nodes)

        bad, saved = None, None
        if tcfg.finite_guard:
            finite = torch.isfinite(_node_grad_norms(grads, n_nodes))
            bad = torch.nonzero(~finite).reshape(-1)  # one host sync per step
        if bad is not None and bad.numel():
            for gl in tree_leaves(grads):
                gl[bad] = 0.0
            saved = {k: [t[bad].clone() for t in tree_leaves(v)] for k, v in opt_state.items()}

        if tcfg.fused_update:
            new_params, new_opt, comp = run_update(
                spec, ocfg, x=params, g=grads, state=opt_state, lr=lr,
                step_idx=step_idx, gossip=channel, mean=mean,
                comp_state=state["channel"], stage=stage,
            )
        else:
            new_params, new_opt, comp = opt.step(
                params, grads, opt_state, lr=lr, step_idx=step_idx,
                gossip=channel, mean=mean, comp_state=state["channel"],
            )
        del grads
        if saved is not None:
            # out of place: state buckets may share buffers (d2's m_prev is m)
            new_opt = {
                k: tree_unflatten(v, [t.index_put((bad,), o) for t, o in zip(tree_leaves(v), saved[k])])
                for k, v in new_opt.items()
            }

        metrics = {
            "loss": torch.mean(losses),
            "lr": lr,
            "skipped_nonfinite": 0.0 if bad is None else float(bad.numel()),
        }
        new_state = {"step": step_idx + 1, "params": new_params, "opt": new_opt,
                     "channel": comp}
        return new_state, metrics

    return train_step, channel
