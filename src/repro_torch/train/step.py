"""The decentralized train step for ``n`` nodes stacked on one device.

Per step:

1. each node's gradient of ``forward_loss``'s total (the cross entropy
   plus the MoE router terms) over its batch shard, computed node by node
   so that only one node's activations are alive at a time, written into
   slot ``i`` of the stacked gradient tree;
2. the finite guard: a node whose gradient norm is non-finite has its
   gradient zeroed before the update (its payload stays finite, so its
   neighbours keep mixing clean iterates) and its optimizer state restored
   after it;
3. the gradient-preprocessing scalars per node: each node clips by its
   own gradient norm and takes its own LARS norms
   (:func:`~repro_torch.core.update_spec.node_grad_scalars`), as inside
   ``repro``'s shard_map step, where each node's shard sees only itself;
4. the algorithm's update tail through ``run_update`` with the stacked
   ``W @`` channel and the stacked mean — either the reference optimizer
   step or, with ``fused_update``, the fused stage engine
   (:mod:`repro_torch.kernels.fused_update`) writing ``x`` and ``m`` in
   place.

With ``flat_planes`` the step runs on the train state's plane form
(:mod:`repro_torch.train.train_state`): the gradient of each node is
written straight into a stacked gradient plane through its views, and the
tail runs on the planes — one stage launch per dtype bucket
(``make_plane_stage``), the LARS ratios as row columns — writing the
parameter plane, and so the parameter views, in place.

Stale and compressed gossip: ``gossip_delay > 0`` gossips through a
:class:`~repro_torch.core.gossip.DelayedStackedChannel` (ring buffers in
the channel state, one slot per gossip call of the step), and
``compression`` encodes each node's payload before the mix.  The delayed
channel reports each node's incident version gap, ``(n,)``, which
``decentlam-sa`` turns into its per-node damping ``sg``; the fused engine
reads it as one float per node.

:func:`build_dist_train_step` is the counterpart of ``repro.train.step``'s
shard_map step: one process per node (:mod:`repro_torch.launch.mesh`),
each rank holding its replica with a node axis of size 1 and taking the
gradient on its own rows ``[i*b, (i+1)*b)`` of the same global batch the
stacked step sees.  It gossips through a distributed channel (``ppermute``
or ``allgather``, delayed when asked), means through ``make_psum_mean``
(pmsgd, slowmo), and reduces its metrics over the ranks: the loss is the
mean over nodes, ``gossip_gap`` the fleet maximum, the consensus distance
``(1/n) sum_i ||x_i - x_bar||^2`` from two ``all_reduce`` sums.  The stage
kernel launches on the rank's own node (a node axis of 1).  Tensor
parallelism (tp > 1) and row-sparse gossip raise: they wait for ROADMAP
queue 1, items 2 and 3.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core.gossip import (
    DelayedStackedChannel,
    GossipChannel,
    StackedChannel,
    _Wire,
    build_channel,
    make_psum_mean,
    make_stacked_mean,
)
from ..core.optimizers import OptimizerConfig, make_optimizer
from ..core.planes import plane_scalars
from ..core.schedules import ScheduleConfig, build_schedule
from ..core.topology import build_topology
from ..core.update_spec import node_grad_scalars, run_update, update_spec
from ..kernels.fused_update import make_plane_stage, make_stage
from ..models import transformer as T
from ..utils import tree_leaves, tree_unflatten
from .train_state import model_plane_layout

Tree = Any

__all__ = ["TrainConfig", "build_train_step", "build_dist_train_step", "build_gossip_channel"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``repro.train.step.TrainConfig`` that the single-process
    trainer reads, with the reference's defaults — except ``runtime``, whose
    default computes in float32 (the reference CLI's ``--dtype`` default)."""

    algorithm: str = "decentlam"
    topology: str = "exp"
    # the distributed step's transport: ppermute | allgather (the stacked
    # step always mixes with W @)
    gossip_impl: str = "ppermute"
    gossip_delay: int = 0  # hold payloads back k rounds (a delay ring)
    compression: str | None = None
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # per node: each node clips by its own norm
    # decentlam-sa gap-damping schedule (read off the delayed channel's
    # version gaps; inert for the other algorithms)
    sa_damping: float = 0.5
    sa_floor: float = 0.0
    grad_accum: int = 1  # microbatches per node, gradients summed in f32
    schedule: ScheduleConfig = ScheduleConfig()
    runtime: T.RuntimeConfig = T.RuntimeConfig(dtype="float32")
    fused_update: bool = False
    fused_impl: str = "triton"  # triton | torch (the kernel's plain version)
    # the update tail on the train state's plane form: one stage launch per
    # dtype bucket, the parameters living in the planes (tp = 1)
    flat_planes: bool = False
    track_consensus: bool = False  # add (1/n) sum_i ||x_i - x_bar||^2 to the metrics
    # skip a node's optimizer update when its grad norm goes non-finite (the
    # skip count surfaces as the "skipped_nonfinite" metric)
    finite_guard: bool = True
    # row-sparse gossip (repro.sparse): not ported, raises
    sparse_gossip: bool = False

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(
            algorithm=self.algorithm,
            momentum=self.momentum,
            weight_decay=self.weight_decay,
            grad_clip=self.grad_clip,
            sa_damping=self.sa_damping,
            sa_floor=self.sa_floor,
        )


def build_gossip_channel(tcfg: TrainConfig, topology, gossips_per_step: int) -> GossipChannel:
    """The transport for a train config: the delayed stacked channel (one
    ring slot per gossip call of the step) when ``gossip_delay > 0``, else
    the stacked channel; compressed as configured, telemetry on."""
    if tcfg.gossip_delay > 0:
        return DelayedStackedChannel(topology, tcfg.gossip_delay,
                                     calls_per_step=gossips_per_step,
                                     compression=tcfg.compression, telemetry=True)
    return StackedChannel(topology, compression=tcfg.compression, telemetry=True)


def _node_grads(params: Tree, batch: dict, cfg: ModelConfig, n_nodes: int, out=None,
                rt: T.RuntimeConfig = T.RuntimeConfig(dtype="float32"), accum: int = 1):
    """Per-node loss and gradient, one node at a time, into a stacked f32
    gradient tree (``out``'s leaves where given: the views of a gradient
    plane).  With ``accum`` > 1 each node's rows split into ``accum``
    microbatches, and the gradient and the loss accumulate ``g += g_j /
    accum`` in f32 from zeros, as the reference's scan does, and each model
    metric (``xent`` and the MoE router terms) is the mean over the
    microbatches.  Returns ``(grads, per-node values)``: ``{"loss": (n,)}``,
    each node's total, and ``{metric: (n,)}``."""
    leaves = tree_leaves(params)
    g_leaves = (tree_leaves(out) if out is not None else
                [torch.empty(p.shape, dtype=torch.float32, device=p.device) for p in leaves])
    b = batch["tokens"].shape[0] // n_nodes
    if b % accum:
        raise ValueError(f"{b} rows per node do not split into {accum} microbatches")
    mb = b // accum
    losses, node_metrics = [], []
    for i in range(n_nodes):
        leaves_i = [p[i].detach().requires_grad_() for p in leaves]
        params_i = tree_unflatten(params, leaves_i)
        loss_i = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        micro = []
        for j in range(accum):
            lo = i * b + j * mb
            batch_j = {k: v[lo:lo + mb] for k, v in batch.items()}
            loss, metrics = T.forward_loss(params_i, batch_j, cfg, rt)
            micro.append({k: v.detach() for k, v in metrics.items()})
            grads = torch.autograd.grad(loss, leaves_i)
            if accum == 1:
                for gl, gi in zip(g_leaves, grads):
                    gl[i].copy_(gi)
                loss_i = loss.detach()
                continue
            if j == 0:
                for gl in g_leaves:
                    gl[i].zero_()
            for gl, gi in zip(g_leaves, grads):
                gl[i].add_(gi.to(torch.float32) / accum)
            loss_i = loss_i + loss.detach().to(torch.float32) / accum
            del grads
        losses.append(loss_i)
        node_metrics.append(micro[0] if accum == 1 else
                            {k: torch.mean(torch.stack([m[k] for m in micro]))
                             for k in micro[0]})
    per_node = {k: torch.stack([m[k] for m in node_metrics]) for k in node_metrics[0]}
    return tree_unflatten(params, g_leaves), {"loss": torch.stack(losses), **per_node}


def _consensus_sq(x: Tree, n_nodes: int) -> torch.Tensor:
    """``(1/n) sum_i ||x_i - x_bar||^2`` over all leaves of a stacked tree (or
    of stacked planes, whose zero pads add nothing), node by node: the
    reference's per-node sums, then their sum over nodes."""
    total = torch.zeros((), dtype=torch.float32, device=tree_leaves(x)[0].device)
    for leaf in tree_leaves(x):
        xb = torch.sum(leaf.to(torch.float32), dim=0) / n_nodes
        per_node = torch.stack([torch.sum((leaf[i].to(torch.float32) - xb) ** 2)
                                for i in range(n_nodes)])
        total = total + torch.sum(per_node) / n_nodes
    return total


def _node_grad_norms(grads: Tree, n_nodes: int) -> torch.Tensor:
    """(n,) f32 global gradient norm per node (of a stacked tree or of
    stacked planes, whose zero pads add nothing).  Float32 accumulation of
    the squares, so it is non-finite exactly when the reference's sum of
    squares is."""
    per_leaf = [
        torch.linalg.vector_norm(gl.reshape(n_nodes, -1), dim=1) for gl in tree_leaves(grads)
    ]
    return torch.linalg.vector_norm(torch.stack(per_leaf, dim=1), dim=1)


class _Stacked:
    """The fleet of the stacked step: every node in this process."""

    def __init__(self, n_nodes: int):
        self.n = n_nodes

    def rows(self, batch: dict) -> dict:
        return batch

    def reduce(self, per_node: dict, skipped: int, gaps):
        """The mean over nodes of each per-node value, the skip count and
        the fleet's largest gap."""
        return ({k: torch.mean(v) for k, v in per_node.items()}, float(skipped),
                float(torch.as_tensor(gaps).max()))

    def consensus(self, x: Tree) -> torch.Tensor:
        return _consensus_sq(x, self.n)


class _Ranks:
    """The fleet of the distributed step: this process is node ``group.rank``
    of ``group.world``; metrics reduce over the ranks."""

    def __init__(self, group):
        self.group, self.n = group, group.world
        self._wire = _Wire(group)

    def rows(self, batch: dict) -> dict:
        b = batch["tokens"].shape[0] // self.n
        lo = self.group.rank * b
        return {k: v[lo:lo + b] for k, v in batch.items()}

    def reduce(self, per_node: dict, skipped: int, gaps):
        dev, pg = self.group.comm_device, self.group.pg
        names = sorted(per_node)
        sums = torch.stack([per_node[k].sum().to(device=dev, dtype=torch.float32)
                            for k in names] + [torch.tensor(float(skipped), device=dev)])
        gap = torch.as_tensor(gaps, dtype=torch.float32).max().reshape(1).to(dev)
        dist.all_reduce(sums, group=pg)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=pg)
        return ({k: sums[j] / self.n for j, k in enumerate(names)}, float(sums[-1]),
                float(gap[0]))

    def consensus(self, x: Tree) -> torch.Tensor:
        """``repro``'s ``_consensus_metric``: per leaf the mean over the
        ranks, then the sum over the ranks of the squared distance, over n."""
        total = torch.zeros((), dtype=torch.float32)
        for leaf in tree_leaves(x):
            xf = leaf.to(torch.float32)
            xb = self._wire.all_reduce_(xf.clone().view(-1)).view(xf.shape) / self.n
            sq = torch.sum((xf - xb) ** 2).reshape(1).to(self.group.comm_device)
            dist.all_reduce(sq, group=self.group.pg)
            total = total + sq[0].cpu() / self.n
        return total


def _step_fn(cfg: ModelConfig, tcfg: TrainConfig, fleet, channel: GossipChannel, mean):
    """The step body shared by the stacked and the distributed step; the
    ``fleet`` says which rows this process trains on and how its metrics
    reduce.  Every leaf here has a node axis of the nodes in this process."""
    ocfg = tcfg.opt_config()
    opt = make_optimizer(ocfg)
    spec = update_spec(ocfg)
    lr_fn = build_schedule(tcfg.schedule)
    if tcfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {tcfg.grad_accum}")
    if tcfg.sparse_gossip:
        raise NotImplementedError("row-sparse gossip is not ported yet (ROADMAP queue 1, item 3)")
    n_local = 1 if isinstance(fleet, _Ranks) else fleet.n
    rt = tcfg.runtime
    if tcfg.flat_planes:
        layout = model_plane_layout(cfg)
        stage = make_plane_stage(tcfg.fused_impl if tcfg.fused_update else "torch",
                                 inplace=True)
    else:
        stage = make_stage(tcfg.fused_impl, inplace=True) if tcfg.fused_update else None

    def train_step(state: Tree, batch: dict):
        params, opt_state = state["params"], state["opt"]
        step_idx = state["step"]
        dev = tree_leaves(params)[0].device
        lr = torch.full((), lr_fn(step_idx), dtype=torch.float32, device=dev)
        batch = fleet.rows(batch)

        planes = g_planes = None
        if tcfg.flat_planes:
            planes = state["planes"]
            # every segment element is written below; the pads are zeroed
            # (inert in the tail and in the finite guard's norms)
            g_planes = {k: torch.empty(p.shape, dtype=torch.float32, device=dev)
                        for k, p in planes.items()}
            layout.zero_pads(g_planes, leading=1)
            grads, per_node = _node_grads(params, batch, cfg, n_local,
                                          layout.view_unpack(g_planes, leading=1), rt,
                                          tcfg.grad_accum)
        else:
            grads, per_node = _node_grads(params, batch, cfg, n_local, None, rt,
                                          tcfg.grad_accum)

        bad, saved = None, None
        if tcfg.finite_guard:
            norms = _node_grad_norms(g_planes if planes is not None else grads, n_local)
            bad = torch.nonzero(~torch.isfinite(norms)).reshape(-1)  # one host sync per step
        if bad is not None and bad.numel():
            for gl in tree_leaves(g_planes if planes is not None else grads):
                gl[bad] = 0.0
            saved = {k: [t[bad].clone() for t in tree_leaves(v)] for k, v in opt_state.items()}

        if planes is not None:
            new_x, new_opt, comp = run_update(
                spec, ocfg, x=planes, g=g_planes, state=opt_state, lr=lr,
                step_idx=step_idx, gossip=channel, mean=mean,
                comp_state=state["channel"], stage=stage,
                scalars=plane_scalars(ocfg, layout, params, grads, stacked=True),
            )
            for k, p in planes.items():
                if new_x[k] is not p:
                    # a state bucket that is the parameter plane itself
                    # (d2's x_prev of f32 parameters) keeps the old values
                    for v in new_opt.values():
                        if v.get(k) is p:
                            v[k] = p.clone()
                    p.copy_(new_x[k])
            new_params = params  # the views now read the new planes
        elif tcfg.fused_update:
            new_params, new_opt, comp = run_update(
                spec, ocfg, x=params, g=grads, state=opt_state, lr=lr,
                step_idx=step_idx, gossip=channel, mean=mean,
                comp_state=state["channel"], stage=stage,
                scalars=node_grad_scalars(ocfg, params, grads),
            )
        else:
            new_params, new_opt, comp = opt.step(
                params, grads, opt_state, lr=lr, step_idx=step_idx,
                gossip=channel, mean=mean, comp_state=state["channel"],
                scalars=node_grad_scalars(ocfg, params, grads),
            )
        del grads, g_planes
        if saved is not None:
            # out of place: state buckets may share buffers (d2's m_prev is m)
            new_opt = {
                k: tree_unflatten(v, [t.index_put((bad,), o) for t, o in zip(tree_leaves(v), saved[k])])
                for k, v in new_opt.items()
            }

        means, skipped, gap = fleet.reduce(per_node, 0 if bad is None else bad.numel(),
                                           channel.node_gaps(comp))
        metrics = {
            # the mean over nodes of each node's total (cross entropy plus
            # the MoE router terms) as "loss", and of xent and the router terms
            **means,
            "lr": lr,
            "skipped_nonfinite": skipped,
            # fleet-worst incident gossip gap of this round (0 on undelayed
            # channels): the signal the serving publisher gates on
            "gossip_gap": gap,
        }
        if tcfg.track_consensus:
            metrics["consensus_sq"] = fleet.consensus(planes if planes is not None
                                                      else new_params)
        new_state = {"step": step_idx + 1, "params": new_params, "opt": new_opt,
                     "channel": comp}
        if planes is not None:
            new_state["planes"] = planes
        return new_state, metrics

    return train_step


def _topology(tcfg: TrainConfig, n_nodes: int):
    topology = build_topology(tcfg.topology, n_nodes)
    if tcfg.algorithm == "decentlam" and topology.period > 1 and tcfg.momentum > 0.5:
        warnings.warn(
            "DecentLaM's convergence analysis assumes a static mixing matrix"
            " (paper Assumption A.3); with time-varying topologies the"
            f" momentum on the gossip penalty can resonate at beta="
            f"{tcfg.momentum} > 0.5. Consider beta <= 0.5 or a static topology.",
            stacklevel=3,
        )
    return topology


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, n_nodes: int):
    """Returns ``(train_step, channel)``.

    ``train_step(state, batch) -> (state, metrics)``: ``state`` is an
    :func:`~repro_torch.train.train_state.init_train_state` dict (it is
    updated in place on the fused path and must not be reused); ``batch``
    holds ``(n_nodes * per_node_batch, seq)`` tokens and targets, node ``i``
    owning rows ``[i * b, (i + 1) * b)``.  The returned channel is the
    transport the step gossips through: pass it to ``init_train_state``.
    """
    topology = _topology(tcfg, n_nodes)
    channel = build_gossip_channel(tcfg, topology,
                                   make_optimizer(tcfg.opt_config()).gossips_per_step)
    step = _step_fn(cfg, tcfg, _Stacked(n_nodes), channel, make_stacked_mean(n_nodes))
    return step, channel


def build_dist_train_step(cfg: ModelConfig, tcfg: TrainConfig, group, *, tp: int = 1):
    """Returns ``(train_step, channel)`` for this rank of the node ``group``
    (``repro.train.step.build_train_step`` at tp = 1).

    ``train_step(state, batch) -> (state, metrics)``: ``state`` is this
    rank's state (:func:`~repro_torch.train.train_state.init_train_state`
    with one node, or a scattered one), updated in place on the fused path;
    ``batch`` is the global batch of ``group.world * b`` rows, of which the
    rank takes ``[rank * b, (rank + 1) * b)``.  Every rank calls it at every
    step.  The channel is ``tcfg.gossip_impl`` (``ppermute`` or
    ``allgather``; delayed with ``gossip_delay``), telemetry on."""
    if tp != 1:
        raise NotImplementedError(
            f"tensor parallelism (tp={tp}) is not ported yet (ROADMAP queue 1, item 2)")
    if tcfg.gossip_impl not in ("ppermute", "allgather"):
        raise ValueError(
            f"gossip_impl={tcfg.gossip_impl!r}; the distributed step needs a distributed "
            "transport: ppermute | allgather")
    n = group.world
    topology = _topology(tcfg, n)
    channel = build_channel(tcfg.gossip_impl, topology, group, compression=tcfg.compression,
                            delay=tcfg.gossip_delay,
                            calls_per_step=make_optimizer(tcfg.opt_config()).gossips_per_step,
                            telemetry=True)
    step = _step_fn(cfg, tcfg, _Ranks(group), channel, make_psum_mean(group, n))
    return step, channel
