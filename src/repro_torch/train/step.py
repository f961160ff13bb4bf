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
kernel launches on the rank's own node (a node axis of 1).

Tensor parallelism: on a ``(nodes x tp)`` grid
(:class:`~repro_torch.launch.mesh.Grid`) each rank holds its model rank's
shard of its node, takes the gradient through the model group's
collectives (:mod:`repro_torch.models.layers`: every leaf's gradient, joined
over the group, is its tp = 1 gradient, replicated leaves whole on every
rank), and gossips its shard over its node group, one model column at a
time.  The node's scalars sum over the model group: the clip and LARS
norms (a sharded leaf's squared norm summed, a replicated one counted
once), the finite guard's squared gradient norm, and the loss, which the
sharded cross entropy already sums; the consensus metric is the mean over
the model group of each column's, as the reference's.  On flat planes the
stage kernel runs on the rank's local planes, unchanged: the same launches
per rank and step as at tp = 1.  Sparse gossip at tp > 1 raises, as the
reference's does.

Row-sparse gossip (``sparse_gossip``, :mod:`repro_torch.sparse`) runs on the
distributed step with ``ppermute`` on flat planes, as the reference's: the
forward pass collects the MoE groups' expert hits, a
:class:`~repro_torch.sparse.RowTracker` turns them and the rank's token ids
into plane-row masks, and ``channel.mark`` feeds them to the sparse channel
before the update tail.  The stacked step refuses it, as the reference's
refuses it for a non-distributed transport.

Fault tolerance (:mod:`repro_torch.resilience`): ``chaos`` wraps the
channel in a :class:`~repro_torch.resilience.ChaosChannel` and
``resilient`` then in a :class:`~repro_torch.resilience.ResilientChannel`
(outside-in: faults on the wire, healed one layer up), in both builders.
The host's health loop sets the trust mask (``launch/train.py``).
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
from ..models.layers import TPContext
from ..trace import span
from ..utils import tree_leaves, tree_map, tree_unflatten
from .train_state import model_plane_layout

Tree = Any

__all__ = ["TrainConfig", "build_train_step", "build_dist_train_step", "build_gossip_channel",
           "build_dist_channel"]


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
    # row-sparse gossip (repro.sparse): ship only the touched rows of each
    # plane bucket per round; the distributed step with ppermute on flat
    # planes only.  "exact" equals dense gossip; "delta" heals rows after
    # delivery (lossy, delay 0 only)
    sparse_gossip: bool = False
    sparse_mode: str = "exact"  # exact | delta
    sparse_crossover: float = 0.9  # dirty fraction at which a bucket goes dense
    # fault tolerance (repro.resilience): a seeded fault schedule on the
    # wire, and/or the self-healing ResilientChannel around the transport
    chaos: Any = None  # ChaosSchedule | None (frozen, hashable)
    resilient: bool = False
    resilient_gap: int | None = None  # on-the-fly distrust bound on a sender's gap

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(
            algorithm=self.algorithm,
            momentum=self.momentum,
            weight_decay=self.weight_decay,
            grad_clip=self.grad_clip,
            sa_damping=self.sa_damping,
            sa_floor=self.sa_floor,
        )


def _wrap_resilience(tcfg: TrainConfig, channel: GossipChannel) -> GossipChannel:
    """The resilience wrappers, outside-in: chaos injects on the wire, the
    resilient layer heals one level up (so it also heals real faults)."""
    if tcfg.chaos is not None:
        from ..resilience import ChaosChannel

        channel = ChaosChannel(channel, tcfg.chaos)
    if tcfg.resilient:
        from ..resilience import ResilientChannel

        channel = ResilientChannel(channel, suspect_gap=tcfg.resilient_gap)
    return channel


def build_gossip_channel(tcfg: TrainConfig, topology, gossips_per_step: int) -> GossipChannel:
    """The transport for a train config: the delayed stacked channel (one
    ring slot per gossip call of the step) when ``gossip_delay > 0``, else
    the stacked channel; compressed as configured, telemetry on; wrapped in
    the chaos and resilient layers when asked."""
    if tcfg.gossip_delay > 0:
        channel = DelayedStackedChannel(topology, tcfg.gossip_delay,
                                        calls_per_step=gossips_per_step,
                                        compression=tcfg.compression, telemetry=True)
    else:
        channel = StackedChannel(topology, compression=tcfg.compression, telemetry=True)
    return _wrap_resilience(tcfg, channel)


def build_dist_channel(tcfg: TrainConfig, topology, group,
                       gossips_per_step: int) -> GossipChannel:
    """The distributed step's transport (``repro.train.step.
    build_gossip_channel``): ppermute or allgather, delayed when
    ``gossip_delay > 0``, telemetry on; the row-sparse ppermute channel with
    ``sparse_gossip`` (which needs ``ppermute``, ``weight_decay == 0`` at a
    delay, and refuses the resilience wrappers); else wrapped in the chaos
    and resilient layers when asked."""
    if tcfg.gossip_impl not in ("ppermute", "allgather"):
        raise ValueError(
            f"gossip_impl={tcfg.gossip_impl!r}; the distributed step needs a distributed "
            "transport: ppermute | allgather")
    if tcfg.sparse_gossip and (tcfg.chaos is not None or tcfg.resilient):
        # the sparse channels ship row segments, not whole payloads: the
        # wrappers' sender-side masking would corrupt the row addressing
        raise ValueError("chaos/resilient wrappers do not compose with sparse_gossip: use "
                         "dense gossip for fault-injection runs")
    if tcfg.sparse_gossip:
        if tcfg.gossip_impl != "ppermute":
            raise ValueError("sparse_gossip requires gossip_impl='ppermute' (the sparse "
                             "channels ride the edge-class wire path)")
        if tcfg.gossip_delay > 0 and tcfg.weight_decay != 0.0:
            # delayed exact sparsity skips rows that stay in consensus; weight
            # decay drifts untouched rows, which the channel never re-ships
            raise ValueError("sparse_gossip with gossip_delay > 0 requires weight_decay == 0 "
                             "(untouched rows must be stationary for delayed exact "
                             "row-skipping to be lossless)")
        from ..sparse import build_sparse_channel

        return build_sparse_channel("ppermute", topology, group, mode=tcfg.sparse_mode,
                                    crossover=tcfg.sparse_crossover,
                                    compression=tcfg.compression, delay=tcfg.gossip_delay,
                                    calls_per_step=gossips_per_step, telemetry=True)
    channel = build_channel(tcfg.gossip_impl, topology, group, compression=tcfg.compression,
                            delay=tcfg.gossip_delay, calls_per_step=gossips_per_step,
                            telemetry=True)
    return _wrap_resilience(tcfg, channel)


def _node_grads(params: Tree, batch: dict, cfg: ModelConfig, n_nodes: int, out: Tree,
                rt: T.RuntimeConfig = T.RuntimeConfig(dtype="float32"), accum: int = 1,
                row_info: list | None = None, tp: TPContext | None = None):
    """Per-node loss and gradient, one node at a time, into ``out``, a
    stacked f32 gradient tree (on flat planes the views of a gradient
    plane).  With ``accum`` > 1 each node's rows split into ``accum``
    microbatches, and the gradient and the loss accumulate ``g += g_j /
    accum`` in f32 from zeros, as the reference's scan does, and each model
    metric (``xent`` and the MoE router terms) is the mean over the
    microbatches.  Returns ``(grads, per-node values)``: ``{"loss": (n,)}``,
    each node's total, and ``{metric: (n,)}``.  With a ``row_info`` list the
    forward passes collect the MoE groups' expert hits, and node ``i``'s
    ``{"moe/g<k>": (Lg, E)}`` (the union over its microbatches) is appended
    to it.  Each microbatch's forward runs in a ``train.forward`` span, its
    backward and the gradient's copy or sum in ``train.backward``, the
    per-node metrics' stacking in ``train.metrics`` (:mod:`repro_torch.trace`)."""
    leaves = tree_leaves(params)
    g_leaves = tree_leaves(out)
    b = batch["tokens"].shape[0] // n_nodes
    if b % accum:
        raise ValueError(f"{b} rows per node do not split into {accum} microbatches")
    mb = b // accum
    losses, node_micro = [], []
    for i in range(n_nodes):
        micro = []
        for j in range(accum):
            with span("train.forward"):
                if j == 0:
                    leaves_i = [p[i].detach().requires_grad_() for p in leaves]
                    params_i = tree_unflatten(params, leaves_i)
                    loss_i = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                lo = i * b + j * mb
                batch_j = {k: v[lo:lo + mb] for k, v in batch.items()}
                loss, metrics = T.forward_loss(params_i, batch_j, cfg, rt,
                                               collect_rows=row_info is not None,
                                               **({} if tp is None else {"tp": tp}))
                hits = metrics.pop("_row_info", None)
                if hits is not None:
                    hits_i = hits if j == 0 else {k: hits_i[k] + v for k, v in hits.items()}
                micro.append({k: v.detach() for k, v in metrics.items()})
            with span("train.backward"):
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
        node_micro.append(micro)
        if row_info is not None:
            row_info.append(hits_i)
    with span("train.metrics"):
        node_metrics = [micro[0] if accum == 1 else
                        {k: torch.mean(torch.stack([m[k] for m in micro])) for k in micro[0]}
                        for micro in node_micro]
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


def _node_grad_norms(grads: Tree, n_nodes: int, tp: TPContext | None = None,
                     replicated: list | None = None) -> torch.Tensor:
    """(n,) f32 global gradient norm per node (of a stacked tree or of
    stacked planes, whose zero pads add nothing).  Float32 accumulation of
    the squares, so it is non-finite exactly when the reference's sum of
    squares is.  With a model group, the squares sum over it, less the
    ``replicated`` leaves' (views of the rank's gradient) on every model
    rank but 0, so that each is counted once and every rank of a node
    decides alike."""
    per_leaf = [
        torch.linalg.vector_norm(gl.reshape(n_nodes, -1), dim=1) for gl in tree_leaves(grads)
    ]
    norms = torch.linalg.vector_norm(torch.stack(per_leaf, dim=1), dim=1)
    if tp is None or not tp.enabled:
        return norms
    sq = torch.square(norms)
    if tp.index and replicated:
        sq = sq - torch.stack([torch.sum(torch.square(gl.reshape(n_nodes, -1).to(torch.float32)),
                                         dim=1) for gl in replicated]).sum(0)
    return torch.sqrt(tp.all_reduce(sq))


def _to_host(x: torch.Tensor, dev="cpu") -> torch.Tensor:
    """``x.to(dev)``; a copy off the device to the host is a host sync, in a
    ``sync.metrics`` span."""
    if torch.device(dev).type == "cpu" and x.device.type not in ("cpu", "meta"):
        with span("sync.metrics"):
            return x.to(dev)
    return x.to(dev)


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
    of ``group.world``; metrics reduce over the ranks (``tp``: the node's
    model group, over which the consensus metric is averaged)."""

    def __init__(self, group, tp: TPContext | None = None):
        self.group, self.n, self.tp = group, group.world, tp
        self._wire = _Wire(group)

    def rows(self, batch: dict) -> dict:
        b = batch["tokens"].shape[0] // self.n
        lo = self.group.rank * b
        return {k: v[lo:lo + b] for k, v in batch.items()}

    def reduce(self, per_node: dict, skipped: int, gaps):
        dev = self.group.comm_device
        names = sorted(per_node)
        sums = torch.stack([_to_host(per_node[k].sum().to(torch.float32), dev)
                            for k in names] + [torch.tensor(float(skipped), device=dev)])
        gap = torch.as_tensor(gaps, dtype=torch.float32).max().reshape(1).to(dev)
        self._wire.reduce(sums)
        self._wire.reduce(gap, "max")
        means = {k: sums[j] / self.n for j, k in enumerate(names)}
        if self.group.dry:  # the dry run: no values to read
            return means, 0.0, 0.0
        return means, float(_to_host(sums[-1])), float(_to_host(gap[0]))

    def consensus(self, x: Tree) -> torch.Tensor:
        """``repro``'s ``_consensus_metric``: per leaf the mean over the
        ranks, then the sum over the ranks of the squared distance, over n;
        at tp > 1 each model rank's sum over its shard (replicated leaves
        whole), then the mean over the model group (``pmean``).  On the
        host."""
        comm = self.group.comm_device
        total = torch.zeros((), dtype=torch.float32, device=comm)
        for leaf in tree_leaves(x):
            xf = leaf.to(torch.float32)
            xb = self._wire.all_reduce_(xf.clone().view(-1)).view(xf.shape) / self.n
            sq = _to_host(torch.sum((xf - xb) ** 2).reshape(1), comm)
            dist.all_reduce(sq, group=self.group.pg)
            total = total + sq[0] / self.n
        if self.tp is not None and self.tp.enabled:
            # on the model group's own device (NCCL takes no host tensor)
            total = self.tp.all_reduce(total.to(self.tp.group.comm_device)) / self.tp.size
        return _to_host(total)


def _step_fn(cfg: ModelConfig, tcfg: TrainConfig, fleet, channel: GossipChannel, mean,
             tp: TPContext | None = None):
    """The step body shared by the stacked and the distributed step; the
    ``fleet`` says which rows this process trains on and how its metrics
    reduce, ``tp`` is the node's model group (None: tp = 1).  Every leaf
    here has a node axis of the nodes in this process."""
    ocfg = tcfg.opt_config()
    opt = make_optimizer(ocfg)
    spec = update_spec(ocfg)
    lr_fn = build_schedule(tcfg.schedule)
    if tcfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {tcfg.grad_accum}")
    n_local = 1 if isinstance(fleet, _Ranks) else fleet.n
    rt = tcfg.runtime
    tps = tp.size if tp is not None else 1
    layout = model_plane_layout(cfg, tps) if tcfg.flat_planes or tps > 1 else None
    if tps > 1:
        if tcfg.sparse_gossip:
            raise NotImplementedError(
                "sparse_gossip at tp > 1 is refused, as the reference refuses it: per-rank "
                "dirty masks make the volume telemetry vary over the model group; use dense "
                "gossip at tp > 1")
        sharded = [a is not None for a in tree_leaves(layout.shard_axes())]
    else:
        sharded = None
    if tcfg.flat_planes:
        stage = make_plane_stage(tcfg.fused_impl if tcfg.fused_update else "torch",
                                 inplace=True)
    else:
        stage = make_stage(tcfg.fused_impl, inplace=True) if tcfg.fused_update else None
    tracker = None
    if tcfg.sparse_gossip:
        if not isinstance(fleet, _Ranks):
            # the stacked W @ mix is the oracle layout; the reference's train
            # step refuses sparse gossip on a non-distributed transport too
            raise ValueError("sparse_gossip runs on the distributed step "
                             "(build_dist_train_step, gossip_impl='ppermute')")
        if not tcfg.flat_planes:
            raise ValueError("sparse_gossip requires flat_planes=True: the RowTracker "
                             "addresses the gossip payload through the plane row->segment map")
        from ..sparse import RowTracker

        tracker = RowTracker.for_model(layout, tied_embeddings=cfg.tie_embeddings)

    def train_step(state: Tree, batch: dict):
        # the phases' spans tile the step (repro_torch.trace)
        params, opt_state = state["params"], state["opt"]
        step_idx = state["step"]
        dev = tree_leaves(params)[0].device
        planes = g_planes = None
        row_info = [] if tracker is not None else None
        with span("train.prepare"):
            lr = torch.full((), lr_fn(step_idx), dtype=torch.float32, device=dev)
            batch = fleet.rows(batch)
            if tcfg.flat_planes:
                planes = state["planes"]
                # every segment element is written below; the pads are zeroed
                # (inert in the tail and in the finite guard's norms)
                g_planes = {k: torch.empty(p.shape, dtype=torch.float32, device=dev)
                            for k, p in planes.items()}
                layout.zero_pads(g_planes, leading=1)
                g_out = layout.view_unpack(g_planes, leading=1)
            else:
                g_out = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
        grads, per_node = _node_grads(params, batch, cfg, n_local, g_out, rt, tcfg.grad_accum,
                                      row_info, tp)

        bad, saved = None, None
        if tcfg.finite_guard:
            with span("train.guard"):
                replicated = (None if sharded is None else
                              [g for g, sh in zip(tree_leaves(grads), sharded) if not sh])
                norms = _node_grad_norms(g_planes if planes is not None else grads, n_local,
                                         tp, replicated)
                if norms.device.type == "meta":  # the dry run: no node is bad
                    bad = torch.zeros(0, dtype=torch.int64)
                else:
                    nonfinite = ~torch.isfinite(norms)
                    with span("sync.finite_guard"):  # one host sync a step
                        bad = torch.nonzero(nonfinite)
                    bad = bad.reshape(-1)
                if bad.numel():
                    for gl in tree_leaves(g_planes if planes is not None else grads):
                        gl[bad] = 0.0
                    saved = {k: [t[bad].clone() for t in tree_leaves(v)]
                             for k, v in opt_state.items()}

        with span("train.update"):
            comp_state = state["channel"]
            if tracker is not None:
                # the rows this step touched: the rank's token ids and its MoE
                # groups' expert hits, over the dense leaves' base rows
                comp_state = channel.mark(comp_state, tracker.step_masks(
                    {"embed": batch["tokens"], **row_info[0]}, device=dev))
            if planes is not None:
                new_x, new_opt, comp = run_update(
                    spec, ocfg, x=planes, g=g_planes, state=opt_state, lr=lr,
                    step_idx=step_idx, gossip=channel, mean=mean,
                    comp_state=comp_state, stage=stage,
                    scalars=plane_scalars(ocfg, layout, params, grads, stacked=True, tp=tp),
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
                    comp_state=comp_state, stage=stage,
                    scalars=node_grad_scalars(ocfg, params, grads, tp=tp, sharded=sharded),
                )
            else:
                new_params, new_opt, comp = opt.step(
                    params, grads, opt_state, lr=lr, step_idx=step_idx,
                    gossip=channel, mean=mean, comp_state=comp_state,
                    scalars=node_grad_scalars(ocfg, params, grads, tp=tp, sharded=sharded),
                )
            del grads, g_planes, g_out
            if saved is not None:
                # out of place: state buckets may share buffers (d2's m_prev is m)
                new_opt = {
                    k: tree_unflatten(v, [t.index_put((bad,), o)
                                          for t, o in zip(tree_leaves(v), saved[k])])
                    for k, v in new_opt.items()
                }

        with span("train.metrics"):
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
    (``repro.train.step.build_train_step``), or of a ``(nodes x tp)`` grid
    (``group`` a :class:`~repro_torch.launch.mesh.Grid`, whose tp is used).

    ``train_step(state, batch) -> (state, metrics)``: ``state`` is this
    rank's state (:func:`~repro_torch.train.train_state.init_train_state`
    with one node, or a scattered one), updated in place on the fused path;
    ``batch`` is the global batch of ``group.world * b`` rows, of which the
    rank takes ``[rank * b, (rank + 1) * b)``.  Every rank calls it at every
    step (on a grid, the batch is the node's: every model rank of a node
    takes the same rows).  The channel is :func:`build_dist_channel`'s,
    over the node group.  The step's ``tp`` attribute is its model group's
    :class:`~repro_torch.models.layers.TPContext` (None at tp = 1)."""
    from ..launch.mesh import Grid

    ctx = None
    if isinstance(group, Grid):
        grid, tp = group, group.tp
        group = grid.node
        T.check_tp(cfg, tp)
        ctx = TPContext(grid.model) if tp > 1 else None
    elif tp != 1:
        raise ValueError(f"tp={tp} needs a Grid (launch.mesh.init_grid), not a NodeGroup")
    n = group.world
    topology = _topology(tcfg, n)
    channel = build_dist_channel(tcfg, topology, group,
                                 make_optimizer(tcfg.opt_config()).gossips_per_step)
    step = _step_fn(cfg, tcfg, _Ranks(group, ctx), channel, make_psum_mean(group, n), ctx)
    step.tp = ctx
    return step, channel
