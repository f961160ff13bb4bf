"""Decentralized trainer: ``n`` nodes stacked on one device, or one process
per node.

Runs DecentLaM (or any of the eleven algorithms) on synthetic LM data with
the node replicas stacked on one card (``--nodes N``), the ``W @`` gossip
between them — delayed (``--gossip-delay``) and compressed
(``--compression``) as asked — and the update tail either through the
reference optimizer step or, with ``--fused-update``, through the fused
stage kernel.  ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and
at the end; ``--resume`` continues from the latest checkpoint there
(elastically reshaped when the node count differs).

``--simulate-nodes N`` runs ``repro``'s trainer layout instead: N spawned
processes, one node each, gossiping over ``torch.distributed``
(``--gossip-impl ppermute`` or ``allgather``; :mod:`repro_torch.launch.mesh`
picks NCCL with a card per rank, else gloo).  Rank 0 gathers the state for
checkpoints and writes them; ``--failure-drill`` shrinks the nodes to n/2
halfway (rank 0 gathers the state and collapses it with
``elastic_reshape``, the upper half of the nodes leave with all their
model ranks, the survivors form a new grid and resume).  Under
``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the same flags run this
process as one rank of the launched group.
``--tp T`` adds tensor parallelism there: ``--simulate-nodes N --tp T``
spawns ``N x T`` ranks laid out as ``(nodes x tp)`` (under torchrun
``WORLD_SIZE`` must be ``N x T``); each node's T ranks split the dense
decoder Megatron-style and gossip their shards over the node groups.
Checkpoints hold the global state, the channel's included, and resume
across tp through the manifest's ``plane_tp``.  ``--serve-while-training``
there (tp = 1) has rank 0 publish its node through the consensus-gated
publisher, every rank taking part in the fleet's gap gather, and serve from
the snapshots.

Examples::

    # qwen3-0.6b at full width, 4 nodes, Triton update tail (needs a GPU)
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch qwen3-0.6b --steps 5 --seq-len 256 --per-node-batch 4 \\
        --algorithm decentlam --topology exp --fused-update --fused-impl triton

    # the same on flat parameter planes (2 stage launches per step), serving
    # node 0's weights while it trains
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch qwen3-0.6b --steps 8 --seq-len 256 --per-node-batch 4 \\
        --fused-update --fused-impl triton --flat-planes \\
        --serve-while-training --publish-every 2

    # staleness-aware DecentLaM over one round of gossip delay, per-node
    # damping in the stage kernel, with the consensus distance per step
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch qwen3-0.6b --steps 8 --seq-len 256 --per-node-batch 4 \\
        --fused-update --fused-impl triton --flat-planes \\
        --algorithm decentlam-sa --gossip-delay 1 --track-consensus

    # one process per node: 4 ranks sharing the card over gloo (NCCL with a
    # card per rank), flat planes, the stage kernel at a node axis of 1
    PYTHONPATH=src python -m repro_torch.launch.train --simulate-nodes 4 \\
        --arch qwen3-0.6b --steps 3 --seq-len 256 --per-node-batch 4 \\
        --gossip-impl ppermute --fused-update --fused-impl triton --flat-planes

    # the same on the host CPU, with a checkpoint and the shrink to 2 nodes
    PYTHONPATH=src python -m repro_torch.launch.train --simulate-nodes 4 \\
        --device cpu --arch qwen3-0.6b --smoke --steps 6 --seq-len 32 \\
        --per-node-batch 2 --fused-update --ckpt-dir build/ckpt --failure-drill

    # the drill on a (2 x 2) grid: the 4 ranks shrink to 1 node x 2 model ranks
    PYTHONPATH=src python -m repro_torch.launch.train --simulate-nodes 2 --tp 2 \\
        --device cpu --smoke --steps 3 --failure-drill

    # 2 nodes x 2-way tensor parallelism: 4 ranks (on one card over gloo)
    PYTHONPATH=src python -m repro_torch.launch.train --simulate-nodes 2 --tp 2 \\
        --arch qwen3-0.6b --steps 3 --seq-len 256 --per-node-batch 4 \\
        --fused-update --fused-impl triton --flat-planes

    # several cards, one process each (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-0.6b --steps 5 --seq-len 256 --per-node-batch 4 --fused-update \\
        --flat-planes

    # granite-moe-1b-a400m (32 experts, top-8) cut to 12 of its 24 layers, on
    # planes; the log line adds the cross entropy and the router terms
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch granite-moe-1b-a400m --depth 12 --steps 5 --seq-len 256 \\
        --per-node-batch 4 --fused-update --fused-impl triton --flat-planes

    # fault injection healed by the resilient layer: node 1 silent for steps
    # 2..13 (distrusted by the health monitor, its weight given back to each
    # receiver), then a NaN-poisoned payload from node 2 (quarantined)
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 --arch qwen3-0.6b \\
        --smoke --steps 16 --seq-len 32 --per-node-batch 2 --fused-update --device cpu \\
        --flat-planes --chaos 'silence,nodes=1,start=2,stop=14' \\
        --chaos 'nan,nodes=2,frac=0.001,start=6,stop=7' --resilient

    # tiny LM on the host CPU (the kernel's plain version), int8 gossip with
    # error feedback, checkpointed every 2 steps; then resumed to step 6
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 --preset tiny \\
        --steps 4 --seq-len 32 --per-node-batch 2 --fused-update --device cpu \\
        --compression int8-row-ef --ckpt-dir build/ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 --preset tiny \\
        --steps 6 --seq-len 32 --per-node-batch 2 --fused-update --device cpu \\
        --compression int8-row-ef --ckpt-dir build/ckpt --resume
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..configs import get_config, tiny_lm
from ..core.optimizers import make_optimizer
from ..core.schedules import ScheduleConfig
from ..data.pipeline import prefetch_to_device
from ..data.synthetic import SyntheticLM, SyntheticLMConfig
from ..models import transformer as T
from ..models.transformer import RuntimeConfig, count_params
from ..train.checkpoint import (
    check_plane_manifest,
    elastic_reshape,
    restore_checkpoint,
    save_checkpoint,
)
from ..train.step import TrainConfig, build_dist_train_step, build_train_step
from ..train.train_state import (
    ensure_channel_state,
    gather_grid_state,
    global_tree_state,
    init_train_state,
    model_plane_layout,
    reconcile_plane_state,
    scatter_grid_state,
)
from .mesh import init_grid, init_node_group, run_ranks, shrink_grid
from ..utils import resolve_device, tree_leaves, tree_map


def _parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nodes", type=int, default=4,
                   help="decentralized nodes, stacked as replicas on the one device")
    p.add_argument("--simulate-nodes", dest="simulate_nodes", type=int, default=0,
                   help="run N processes, one node each, over torch.distributed (replaces "
                   "--nodes)")
    p.add_argument("--gossip-impl", dest="gossip_impl", default="ppermute",
                   choices=["ppermute", "allgather"],
                   help="the distributed transport (with --simulate-nodes or under torchrun)")
    p.add_argument("--failure-drill", dest="failure_drill", action="store_true",
                   help="with --simulate-nodes: halfway, gather the state, elastic-shrink "
                   "to n/2, re-form the group with the lower half of the ranks, resume")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="with --simulate-nodes: fail the run when a rank outlives this many "
                   "seconds (0 = no deadline)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks per node (with --simulate-nodes or under "
                   "torchrun; the dense decoders)")
    p.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    p.add_argument("--arch", default=None, help="use an assigned arch instead")
    p.add_argument("--smoke", action="store_true",
                   help="with --arch: use the reduced smoke config")
    p.add_argument("--depth", type=int, default=0,
                   help="cut the model to this many layers (width unchanged; 0 = "
                   "the config's depth)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--algorithm", default="decentlam")
    p.add_argument("--topology", default="exp")
    p.add_argument("--gossip-delay", dest="gossip_delay", type=int, default=0,
                   help="hold gossip payloads back k rounds (delayed stacked channel; "
                   "bounded staleness)")
    p.add_argument("--compression", default=None,
                   help="gossip compressor: bf16 | int8 | int8-row | int8-row-ef | topk:<rate>")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--sa-damping", dest="sa_damping", type=float, default=0.5,
                   help="decentlam-sa: base of the per-gap momentum damping "
                   "(sg = sa_damping**version_gap, per node, read off the delayed channel)")
    p.add_argument("--sa-floor", dest="sa_floor", type=float, default=0.0,
                   help="decentlam-sa: lower bound on the damping factor")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=128)
    p.add_argument("--per-node-batch", dest="per_node_batch", type=int, default=8)
    p.add_argument("--heterogeneity", type=float, default=0.2)
    p.add_argument("--grad-accum", dest="grad_accum", type=int, default=1,
                   help="microbatches per node and step (gradients summed in f32)")
    p.add_argument("--dtype", default="float32",
                   help="activation / compute dtype of the forward pass (parameters stay f32)")
    p.add_argument("--fused-update", dest="fused_update", action="store_true")
    p.add_argument("--fused-impl", dest="fused_impl", default="triton",
                   choices=["triton", "torch"],
                   help="the stage kernel (triton) or its plain version (torch)")
    p.add_argument("--flat-planes", dest="flat_planes", action="store_true",
                   help="keep the parameters and the optimizer state in dtype-bucketed "
                   "plane buffers and run the update tail on them (one stage launch "
                   "per bucket)")
    p.add_argument("--serve-while-training", dest="serve_while_training",
                   action="store_true",
                   help="publish node 0's weights through the consensus-gated "
                   "WeightPublisher every --publish-every steps and advance a "
                   "continuous-batching ServeEngine one tick per train step over a "
                   "synthetic request load")
    p.add_argument("--publish-every", dest="publish_every", type=int, default=20,
                   help="steps between publication offers")
    p.add_argument("--publish-gap-threshold", dest="publish_gap_threshold", type=int,
                   default=1, help="max incident gossip version gap a node may carry and "
                   "still publish (see fleet_node_gaps)")
    p.add_argument("--serve-requests", dest="serve_requests", type=int, default=8,
                   help="synthetic requests for the serve demo")
    p.add_argument("--no-finite-guard", dest="finite_guard", action="store_false",
                   help="disable the non-finite-gradient skip guard")
    p.add_argument("--max-skipped-steps", dest="max_skipped_steps", type=int, default=0,
                   help="abort once this many steps had their update skipped by the finite "
                   "guard (0 = no budget)")
    p.add_argument("--chaos", action="append", default=None, metavar="SPEC",
                   help="inject a wire fault (repeatable).  SPEC is 'KIND[,key=val...]' with "
                   "KIND in silence|drop|dup|delay|corrupt|nan and keys nodes=0-2 (range) or "
                   "nodes=0.3.5 (list), start=, stop=, prob=, frac=, bit=.  e.g. --chaos "
                   "'drop,prob=0.2' --chaos 'silence,nodes=0-1,start=50,stop=120'")
    p.add_argument("--chaos-seed", dest="chaos_seed", type=int, default=0)
    p.add_argument("--resilient", action="store_true",
                   help="wrap the transport in the self-healing ResilientChannel (trust-masked "
                   "mixing with W-row renormalization + NaN/Inf payload quarantine) and drive "
                   "its trust mask from a gap-based HealthMonitor")
    p.add_argument("--resilient-gap", dest="resilient_gap", type=int, default=None,
                   help="distrust bound on a sender's version gap, applied in the round (None "
                   "= the host monitor only)")
    p.add_argument("--health-every", dest="health_every", type=int, default=1,
                   help="steps between health-monitor observations when --resilient is set")
    p.add_argument("--ckpt-dir", dest="ckpt_dir", default=None)
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint under --ckpt-dir")
    p.add_argument("--track-consensus", dest="track_consensus", action="store_true",
                   help="report (1/n) sum_i ||x_i - x_bar||^2 after every step")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--measure-json", dest="measure_json", default=None,
                   help="write the run's step time, tokens/s and peak memory here")
    p.add_argument("--log-every", dest="log_every", type=int, default=10)
    return p.parse_args(argv)


def _parse_chaos(specs, seed):
    """A ChaosSchedule from repeated ``--chaos 'KIND[,key=val...]'`` specs
    (``repro.launch.train._parse_chaos``)."""
    from ..resilience import (
        BitCorrupt, ChaosSchedule, Drop, Duplicate, ExtraDelay, NaNInject, PeerSilence,
    )

    kinds = {"silence": PeerSilence, "drop": Drop, "dup": Duplicate,
             "delay": ExtraDelay, "corrupt": BitCorrupt, "nan": NaNInject}
    faults = []
    for spec in specs:
        kind, _, rest = spec.partition(",")
        if kind not in kinds:
            raise SystemExit(f"--chaos: unknown kind {kind!r} (want {'|'.join(kinds)})")
        kw = {}
        for item in filter(None, rest.split(",")):
            k, _, v = item.partition("=")
            if k == "nodes":
                if "-" in v:
                    lo, hi = v.split("-")
                    kw["nodes"] = tuple(range(int(lo), int(hi) + 1))
                else:
                    kw["nodes"] = tuple(int(i) for i in v.split("."))
            elif k in ("start", "stop", "bit"):
                kw[k] = int(v)
            elif k in ("prob", "frac"):
                kw[k] = float(v)
            else:
                raise SystemExit(f"--chaos: unknown key {k!r} in {spec!r}")
        try:
            faults.append(kinds[kind](**kw))
        except TypeError as e:
            raise SystemExit(f"--chaos: {spec!r}: {e}")
    return ChaosSchedule(faults=tuple(faults), seed=seed)


class _Health:
    """The host health loop of ``--resilient``: every ``--health-every``
    steps the monitor observes the per-sender version gaps
    (``fleet_sender_gaps``, a collective on ranks), and a changed trust mask
    goes into the channel state (``with_trust``).  ``states`` holds the
    monitor's states at each observation."""

    def __init__(self, every: int, n_nodes: int, lead: bool = True):
        from ..resilience import HealthMonitor

        self.every, self.lead = every, lead
        self.monitor = HealthMonitor(n_nodes)
        self.applied = self.monitor.trust.copy()
        self.states: list = []

    def __call__(self, step: int, state: dict, channel) -> dict:
        import numpy as np

        from ..resilience import fleet_sender_gaps, with_trust

        if step % self.every:
            return state
        trust = self.monitor.observe(fleet_sender_gaps(channel, state["channel"]))
        self.states.append((step, self.monitor.states()))
        if not np.array_equal(trust, self.applied):
            state = {**state, "channel": with_trust(state["channel"], trust)}
            self.applied = trust.copy()
            if self.lead:
                print(f"health: {self.monitor.states()} (step {step})", flush=True)
        return state


def _quarantined(state: dict):
    """The resilient layer's quarantine counts (None without it)."""
    res = state["channel"].get("res")
    return None if res is None else [int(v) for v in res["quarantined"].reshape(-1).cpu()]


def _serve_demo(args, cfg, layout, channel, device, runtime, on_serve, lead: bool = True):
    """The serving-while-training demo: a publisher over the plane layout, an
    engine (4 slots, prompts up to 32 tokens, 16 new) over it, and
    ``--serve-requests`` requests of 4..32 tokens from ``default_rng(7)``,
    on the ``lead`` process (rank 0 of the one-process-per-node trainer;
    the others get None for both).  Returns ``(publisher, engine,
    serve(step, state))``: every ``--publish-every`` steps every process
    takes part in the fleet's gap gather and the lead offers node 0's
    weights (its state's node 0: the stacked state's first node, or rank
    0's own), then its engine ticks once.  ``on_serve(engine, publisher)``,
    if given, runs on the lead once both exist; what it returns is the
    demo's stats' ``"on_serve"`` (``serve.hooked``)."""
    import numpy as np

    from ..core.gossip import fleet_node_gaps
    from ..serve import Request, ServeEngine, WeightPublisher

    pub = engine = hooked = None
    if lead:
        pub = WeightPublisher(layout, gap_threshold=args.publish_gap_threshold)
        engine = ServeEngine(cfg, slots=4, max_prompt=32, max_new=16, publisher=pub,
                             runtime=runtime, device=device)
        if on_serve is not None:
            hooked = on_serve(engine, pub)
        srng = np.random.default_rng(7)
        for i in range(args.serve_requests):
            n = int(srng.integers(4, 33))
            engine.submit(Request(rid=i, tokens=srng.integers(0, cfg.vocab_size, n)
                                  .astype(np.int32), max_new_tokens=16))

    def serve(step, state):
        """One cooperative slice: maybe publish, then one engine tick."""
        if step % args.publish_every == 0:
            gaps = fleet_node_gaps(channel, state["channel"])  # a collective on ranks
            if lead:
                # node 0's iterate: its slice of each plane (one copy per
                # bucket), or of each leaf on the per-leaf path
                if "planes" in state:
                    src = {k: p[0] for k, p in state["planes"].items()}
                else:
                    src = tree_map(lambda x: x[0], state["params"])
                shipped = pub.offer(src, version=step + 1, gap=int(gaps[0]))
                print(f"publish v{step + 1} gap={int(gaps[0])} -> "
                      f"{'shipped' if shipped else 'held (gate)'}", flush=True)
        if lead:
            engine.tick()

    serve.hooked = hooked
    return pub, engine, serve


def _drain(args, pub, engine, serve) -> dict:
    """Drain what the cooperative ticks left in flight (unless the gate
    never cleared a single version: nothing to serve with); the demo's
    stats."""
    done = engine.run_until_drained() if pub.current else engine.completions
    ps, es = pub.stats(), engine.stats()
    print(f"serve: {len(done)}/{args.serve_requests} requests done, {es['swaps']} weight "
          f"swap(s); published {ps['published']}/{ps['offers']} offers (rate "
          f"{ps['publish_rate']:.2f}, threshold {ps['gap_threshold']}, final "
          f"v{ps['current_version']})", flush=True)
    out = {"publisher": ps, "engine": es, "completed": len(done)}
    if serve.hooked is not None:
        out["on_serve"] = serve.hooked
    return out


def _channel_layout(host: dict, manifest: dict, layout: str) -> dict:
    """A restored state whose delay ring was written by the other trainer
    (``"channel_layout"`` in the manifest: ``stacked`` ring slots are
    ``(ring, n, ...)``, ``per-node`` ones ``(n, ring, ...)``) loses the ring,
    which ``ensure_channel_state`` then re-initializes."""
    stored = manifest.get("channel_layout")
    if stored is None or stored == layout or "delay" not in host.get("channel", {}):
        return host
    return {**host, "channel": {k: v for k, v in host["channel"].items() if k != "delay"}}


def _stored_layout(cfg, manifest: dict):
    """The plane layout a checkpoint was written with (the manifest's
    ``plane_tp``; a manifest without it was written at tp = 1)."""
    return model_plane_layout(cfg, int(manifest.get("plane_tp") or 1))


def resume_state(ckpt_dir: str, cfg, channel, layout, flat_planes: bool, n_nodes: int,
                 device) -> dict:
    """The latest checkpoint under ``ckpt_dir`` as a run's state on
    ``device``: elastically reshaped when it holds another node count,
    checked against the plane layout it was written with (the manifest's
    ``plane_tp``: a checkpoint of a tensor-parallel run converts), its
    optimizer buckets (and parameters) in the form the run keeps
    (``flat_planes``), its channel state kept where it matches ``channel``."""
    host, manifest = restore_checkpoint(ckpt_dir)
    host = _channel_layout(host, manifest, "stacked")
    stored_n = tree_leaves(host["params"])[0].shape[0]
    if stored_n != n_nodes:
        print(f"elastic reshape {stored_n} -> {n_nodes}", flush=True)
        host = elastic_reshape(host, n_nodes)
    cur_layout = layout or model_plane_layout(cfg)
    stored = _stored_layout(cfg, manifest)
    check_plane_manifest(manifest, stored)
    host = global_tree_state(host, stored, cur_layout)
    state = _to_device(host, device)
    del host
    state = reconcile_plane_state(state, cur_layout, flat_planes)
    state = ensure_channel_state(state, channel, cur_layout if flat_planes else None)
    print(f"resumed from step {state['step']}", flush=True)
    return state


# the model's metrics per step, beside the loss (the mean over nodes of each
# node's total): the cross entropy and the MoE router terms
MODEL_METRICS = ("xent", "moe_load_balance", "moe_router_z")


def _model_metrics(cfg, metrics: dict, lists: dict) -> str:
    """Append this step's model metrics to ``lists``; the log line's part
    for them (the router terms of a MoE model)."""
    for k, v in lists.items():
        v.append(float(metrics[k]))
    if not cfg.moe:
        return ""
    return (f" xent {lists['xent'][-1]:.4f} lb {lists['moe_load_balance'][-1]:.4f} "
            f"z {lists['moe_router_z'][-1]:.4f}")


def preset_config(name: str):
    """``--preset``: ``tiny`` or ``100m`` (repro's ``lm-100m``)."""
    if name == "100m":
        return tiny_lm("lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                       d_ff=3072, vocab_size=50304)
    return tiny_lm()


def _enc_frames(cfg):
    """The encoder-decoder's stub frame shape ``(T_enc, d)`` for the data
    (None for a decoder-only model)."""
    return (cfg.enc_seq, cfg.d_model) if cfg.arch_kind == "encdec" else None


def _model_config(args):
    cfg = get_config(args.arch, smoke=args.smoke) if args.arch else preset_config(args.preset)
    if args.depth:
        cfg = dataclasses.replace(cfg, n_layers=args.depth)
    return cfg


def _train_config(args) -> TrainConfig:
    return TrainConfig(
        algorithm=args.algorithm,
        topology=args.topology,
        gossip_impl=args.gossip_impl,
        gossip_delay=args.gossip_delay,
        compression=args.compression,
        momentum=args.momentum,
        sa_damping=args.sa_damping,
        sa_floor=args.sa_floor,
        grad_accum=args.grad_accum,
        schedule=ScheduleConfig(
            kind="warmup_cosine", peak_lr=args.lr,
            warmup_steps=min(args.warmup, max(args.steps // 5, 1)),
            total_steps=max(args.steps, 2),
        ),
        runtime=RuntimeConfig(dtype=args.dtype),
        fused_update=args.fused_update,
        fused_impl=args.fused_impl,
        flat_planes=args.flat_planes,
        track_consensus=args.track_consensus,
        finite_guard=args.finite_guard,
        chaos=_parse_chaos(args.chaos, args.chaos_seed) if args.chaos else None,
        resilient=args.resilient,
        resilient_gap=args.resilient_gap,
    )


def main(argv=None, *, on_step=None, serve_runtime=None, on_serve=None,
         on_shrink=None) -> dict:
    """Run the trainer; returns ``{losses, lrs, step_s, tokens_per_s,
    peak_mem_bytes, ...}`` (losses/lrs per step, and ``gossip_gaps`` and,
    with ``--track-consensus``, ``consensus_sq`` per step).  ``on_step(step,
    state, metrics)``, if given, is called after each step has finished on
    the device (a profiler's ``step``, for example).  With
    ``--serve-while-training`` the engine takes ``serve_runtime`` (default:
    the engine's own, float32 with the plain attention), ``on_serve(engine,
    publisher)`` sees both once they exist, and the result holds the demo's
    ``"serve"`` stats (with what ``on_serve`` returned, where not None, as
    their ``"on_serve"``).  With ``--resume`` the run continues from the latest
    checkpoint's step to ``--steps``, and the result's lists cover the steps
    it ran.

    With ``--simulate-nodes`` (or under torchrun) the run is
    :func:`rank_main` on every rank and the result is rank 0's; ``on_step``
    and ``on_shrink`` then run in every rank's process and ``on_serve`` on
    rank 0's, and must be picklable (module-level functions), and
    ``serve_runtime`` goes to rank 0's engine.  ``--tp T`` there runs ``N x T``
    ranks; the stacked trainer refuses it."""
    args = _parse(argv)
    cfg = _model_config(args)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.tp < 1:
        raise ValueError(f"--tp {args.tp}: want 1 or more")
    if args.tp > 1:
        T.check_tp(cfg, args.tp)
        if not (args.simulate_nodes or launched):
            raise NotImplementedError(
                f"--tp {args.tp}: the stacked trainer (--nodes) runs at tp = 1; tensor "
                "parallelism runs one process per rank: pass --simulate-nodes N (N x tp ranks) "
                "or launch under torchrun")
        if args.serve_while_training:
            raise ValueError("--serve-while-training requires --tp 1 (as repro's)")
    if args.simulate_nodes or launched:
        resolve_device(args.device)  # no CUDA on a CUDA request raises here
        if launched:
            world = int(os.environ["WORLD_SIZE"])
            if world % args.tp:
                raise ValueError(f"WORLD_SIZE {world} is not N x tp for --tp {args.tp}")
            group = init_node_group(int(os.environ["RANK"]), world, "env://",
                                    device=args.device)
            try:
                return rank_main(group, argv, on_step, on_shrink, serve_runtime, on_serve)
            finally:
                torch.distributed.destroy_process_group()
        return run_ranks(rank_main, args.simulate_nodes * args.tp, argv, on_step, on_shrink,
                         serve_runtime, on_serve, device=args.device,
                         timeout_s=args.timeout or None)[0]
    device = resolve_device(args.device)
    n_nodes = args.nodes
    tcfg = _train_config(args)
    step_fn, channel = build_train_step(cfg, tcfg, n_nodes)
    opt = make_optimizer(tcfg.opt_config())
    layout = model_plane_layout(cfg) if args.flat_planes or args.serve_while_training else None
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if args.resume and args.ckpt_dir:
        state = resume_state(args.ckpt_dir, cfg, channel, layout, args.flat_planes, n_nodes,
                             device)
    else:
        state = init_train_state(cfg, opt, n_nodes, device=device, channel=channel,
                                 plane_layout=layout if args.flat_planes else None)
    start = state["step"]
    n_params = count_params(state["params"]) // n_nodes
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"params/node x {n_nodes} nodes on {device}", flush=True)

    serve = None
    if args.serve_while_training:
        pub, engine, serve = _serve_demo(args, cfg, layout, channel, device, serve_runtime,
                                         on_serve)

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        per_node_batch=args.per_node_batch, n_nodes=n_nodes,
        heterogeneity=args.heterogeneity, enc_frames=_enc_frames(cfg),
    ))

    def checkpoint(state):
        return save_checkpoint(args.ckpt_dir, state,
                               metadata={"n_nodes": n_nodes, "algorithm": args.algorithm,
                                         "channel_layout": "stacked"},
                               plane_layout=layout if args.flat_planes else None)

    losses, lrs, gaps, consensus, step_times = [], [], [], [], []
    model_metrics = {k: [] for k in MODEL_METRICS}
    skipped_steps, saved = 0, False
    health = _Health(args.health_every, n_nodes) if args.resilient else None
    t0 = time.perf_counter()
    batches = prefetch_to_device(lambda k: data.batch(start + k), device,
                                 max(args.steps - start, 0))
    for k, batch in enumerate(batches):
        step = start + k
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        if cuda:
            torch.cuda.synchronize(device)
        step_times.append(time.perf_counter() - ts)
        if on_step is not None:
            on_step(step, state, metrics)
        if args.max_skipped_steps and metrics["skipped_nonfinite"] > 0:
            skipped_steps += 1
            if skipped_steps > args.max_skipped_steps:
                raise RuntimeError(
                    f"aborting at step {step}: the finite guard skipped the optimizer update "
                    f"on {skipped_steps} steps, exceeding --max-skipped-steps="
                    f"{args.max_skipped_steps} — the gradients are persistently non-finite"
                )
        if health is not None:
            state = health(step, state, channel)
        if serve is not None:
            serve(step, state)
        losses.append(loss)
        lrs.append(float(metrics["lr"]))
        gaps.append(metrics["gossip_gap"])
        msg = f"step {step:5d} loss {loss:.4f} lr {lrs[-1]:.2e}" + _model_metrics(
            cfg, metrics, model_metrics)
        if args.track_consensus:
            consensus.append(float(metrics["consensus_sq"]))
            msg += f" consensus {consensus[-1]:.3e}"
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"{msg} ({step_times[-1]:.3f}s)", flush=True)
        saved = bool(args.ckpt_dir) and (step + 1) % args.ckpt_every == 0
        if saved:
            print(f"checkpointed -> {checkpoint(state)}", flush=True)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    # steady state excludes the run's first step (kernel JIT, cuBLAS and
    # allocator warm-up)
    warm = step_times[1:] or step_times
    step_s = sum(warm) / len(warm) if warm else float("nan")
    tokens = n_nodes * args.per_node_batch * args.seq_len
    result = {
        "arch": args.arch or args.preset,
        "n_layers": cfg.n_layers,
        "params_per_node": n_params,
        "n_nodes": n_nodes,
        "algorithm": args.algorithm,
        "fused_update": args.fused_update,
        "fused_impl": args.fused_impl if args.fused_update else None,
        "flat_planes": args.flat_planes,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "start_step": start,
        "losses": losses,
        **model_metrics,
        "lrs": lrs,
        "gossip_gaps": gaps,
        "step_times_s": step_times,
        "step_s": step_s,
        "steps_timed": len(warm),
        "tokens_per_s": tokens / step_s,
        "peak_mem_bytes": peak,
    }
    if args.track_consensus:
        result["consensus_sq"] = consensus
    if health is not None:
        result["health"] = health.states
        result["quarantined"] = _quarantined(state)
    print(f"done: {len(losses)} steps in {total:.1f}s; steady step {step_s:.4f}s, "
          f"{result['tokens_per_s']:.0f} tokens/s", flush=True)
    if serve is not None:
        result["serve"] = _drain(args, pub, engine, serve)
    if args.measure_json:
        with open(args.measure_json, "w") as f:
            json.dump({"measured_step_s": step_s, **result}, f, indent=2)
        print(f"wrote {args.measure_json}")
    if args.ckpt_dir and not saved:  # the final state, unless the last step saved it
        print(f"checkpointed -> {checkpoint(state)}", flush=True)
    return result


def _resume_ranks(grid, ckpt_dir: str, cfg, channel, layout, flat_planes: bool) -> dict:
    """:func:`resume_state` for one rank of the grid: rank 0 restores the
    latest checkpoint (elastically reshaped to the grid's node count,
    checked against the layout it was written with) and scatters it; each
    rank moves its part (its node, its model rank's shard) to its device and
    brings it into the form the run keeps, each channel leaf kept where its
    shape matches ``channel``'s, at any tp (a delay slot whole or not at
    all), and re-initialized elsewhere."""
    host, stored = None, None
    cur_layout = layout or model_plane_layout(cfg, grid.tp)
    if grid.world.rank == 0:
        host, manifest = restore_checkpoint(ckpt_dir)
        host = _channel_layout(host, manifest, "per-node")
        stored_n = tree_leaves(host["params"])[0].shape[0]
        if stored_n != grid.nodes:
            print(f"elastic reshape {stored_n} -> {grid.nodes}", flush=True)
            host = elastic_reshape(host, grid.nodes)
        stored = _stored_layout(cfg, manifest)
        check_plane_manifest(manifest, stored)
        host = {**host, "channel": _per_node_channel(host.get("channel", {}), grid.nodes)}
    tp_of = [None if stored is None else stored.tp]
    # every rank takes the same branch of the scatter
    torch.distributed.broadcast_object_list(tp_of, src=0, group=grid.world.pg)
    stored = stored or model_plane_layout(cfg, tp_of[0])
    state = _to_device(scatter_grid_state(host, grid, cur_layout, stored), grid.world.device)
    del host
    state = reconcile_plane_state(state, cur_layout, flat_planes)
    state = ensure_channel_state(state, channel, cur_layout if flat_planes else None)
    return state


def _per_node_channel(old: dict, world: int) -> dict:
    """The restored channel leaves that can be scattered, one row per node
    (leading axis ``world``); ``ensure_channel_state`` then keeps those
    whose per-rank shape matches the channel and re-initializes the rest
    (a delay slot whole or not at all)."""
    out = {}
    for k, v in old.items():
        if isinstance(v, dict):
            v = _per_node_channel(v, world)
            if v:
                out[k] = v
        elif v.ndim and v.shape[0] == world:
            out[k] = v
    return out


def _to_device(state: dict, device) -> dict:
    return {k: v if k == "step" else tree_map(lambda t: t.to(device), v)
            for k, v in state.items()}


def rank_main(world, argv, on_step=None, on_shrink=None, serve_runtime=None,
              on_serve=None) -> dict:
    """The trainer on one rank of the ``world`` group (``repro``'s shard_map
    trainer): the ranks laid out as ``(nodes x tp)`` (``--tp``), this rank's
    part of the state (its node, its model rank's shard), the global batch
    of every step (the rank trains on its node's rows), checkpoints
    gathered to and written by rank 0, the failure drill (the first half of
    the nodes go on with all their model ranks) and serving while training
    (tp = 1: rank 0 publishes its node and serves).
    Returns the run's result (the losses are the mean over nodes, the same
    on every rank).

    ``on_shrink(grid, gathered, now)``, if given, runs on every survivor of
    the drill once its state is rebuilt: ``grid`` is the new grid,
    ``gathered`` the global state before the shrink and ``now`` the
    survivors' rebuilt state gathered again, both on rank 0 (None
    elsewhere); rank 0's return value is the result's ``"on_shrink"``.
    ``serve_runtime`` and ``on_serve`` are :func:`main`'s, for rank 0's
    engine."""
    args = _parse(argv)
    device = world.device
    cfg = _model_config(args)
    tcfg = _train_config(args)
    opt = make_optimizer(tcfg.opt_config())
    tp = args.tp
    grid = init_grid(world, tp)
    group = grid.node
    layout = model_plane_layout(cfg, tp) if args.flat_planes else None
    cuda = device.type == "cuda"
    print(grid.describe() if tp > 1 else world.describe(), flush=True)
    lead = world.rank == 0
    if lead:
        print(f"mesh: {grid.nodes} nodes x {tp}-way TP ({world.world} ranks)", flush=True)

    def build(g):
        step_fn, channel = build_dist_train_step(cfg, tcfg, g)
        if args.measure_json:
            channel.timings = []
            if step_fn.tp is not None:
                step_fn.tp.timing = True
        return step_fn, channel

    step_fn, channel = build(grid)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    save_s, restore_s = [], None
    if args.resume and args.ckpt_dir:
        t = time.perf_counter()
        state = _resume_ranks(grid, args.ckpt_dir, cfg, channel, layout, args.flat_planes)
        restore_s = time.perf_counter() - t
        if lead:
            print(f"resumed from step {state['step']} in {restore_s:.1f}s", flush=True)
    else:
        state = init_train_state(cfg, opt, 1, device=device, channel=channel,
                                 plane_layout=layout, tp=tp, tp_index=grid.model.rank)
    start = state["step"]
    n_params = count_params(T.init_params(cfg, torch.Generator(), device="meta", tp=tp))
    if lead:
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
              f"params/node x {grid.nodes} nodes, one process each"
              + (f" per model rank ({tp}-way TP)" if tp > 1 else ""), flush=True)

    def data_of(n):
        return SyntheticLM(SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq_len,
            per_node_batch=args.per_node_batch, n_nodes=n, heterogeneity=args.heterogeneity,
            enc_frames=_enc_frames(cfg)))

    def checkpoint(state, grid):
        t = time.perf_counter()
        host = gather_grid_state(state, grid, layout or model_plane_layout(cfg, grid.tp))
        if host is not None:
            path = save_checkpoint(args.ckpt_dir, host,
                                   metadata={"n_nodes": grid.nodes,
                                             "algorithm": args.algorithm,
                                             "channel_layout": "per-node"},
                                   plane_layout=layout)
            save_s.append(time.perf_counter() - t)
            print(f"checkpointed -> {path}", flush=True)

    serve = None
    if args.serve_while_training:
        pub, engine, serve = _serve_demo(args, cfg, layout or model_plane_layout(cfg),
                                         channel, device, serve_runtime, on_serve, lead)

    data = data_of(grid.nodes)
    losses, lrs, gaps, consensus, step_times, card_used = [], [], [], [], [], []
    model_metrics = {k: [] for k in MODEL_METRICS}
    skipped_steps, saved, drill, shrunk = 0, False, None, None
    health = _Health(args.health_every, group.world, lead) if args.resilient else None
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(device)
        step_times.append(time.perf_counter() - ts)
        if cuda and lead:
            free, total = torch.cuda.mem_get_info(device)
            card_used.append(total - free)
        if on_step is not None:
            on_step(step, state, metrics)
        if args.max_skipped_steps and metrics["skipped_nonfinite"] > 0:
            skipped_steps += 1
            if skipped_steps > args.max_skipped_steps:
                raise RuntimeError(
                    f"aborting at step {step}: the finite guard skipped the optimizer update "
                    f"on {skipped_steps} steps, exceeding --max-skipped-steps="
                    f"{args.max_skipped_steps} — the gradients are persistently non-finite"
                )
        if health is not None:
            state = health(step, state, channel)
        if serve is not None:
            serve(step, state)
        losses.append(loss)
        lrs.append(float(metrics["lr"]))
        gaps.append(metrics["gossip_gap"])
        msg = f"step {step:5d} loss {loss:.4f} lr {lrs[-1]:.2e}" + _model_metrics(
            cfg, metrics, model_metrics)
        if args.track_consensus:
            consensus.append(float(metrics["consensus_sq"]))
            msg += f" consensus {consensus[-1]:.3e}"
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"{msg} ({step_times[-1]:.3f}s, {grid.nodes} nodes)", flush=True)
        saved = bool(args.ckpt_dir) and (step + 1) % args.ckpt_every == 0
        if saved:
            checkpoint(state, grid)
        if args.failure_drill and drill is None and step == (start + args.steps) // 2:
            new_n = max(1, group.world // 2)
            if lead:
                print(f"FAILURE DRILL: gather, shrink {group.world} -> {new_n}, re-form the "
                      "group, resume", flush=True)
            cur_layout = layout or model_plane_layout(cfg, tp)
            gathered = gather_grid_state(state, grid, cur_layout)
            del state
            host = elastic_reshape(gathered, new_n) if lead else None
            drill = {"step": step, "from": group.world, "to": new_n}
            new_grid = shrink_grid(grid, new_n)  # every rank makes the new groups
            if new_grid is None:  # this rank leaves the fleet
                return {"left_at_step": step, "rank": world.rank}
            grid = new_grid
            world, group = grid.world, grid.node
            step_fn, channel = build(grid)
            state = _to_device(scatter_grid_state(host, grid, cur_layout), device)
            del host
            state = reconcile_plane_state(state, cur_layout, args.flat_planes)
            state = ensure_channel_state(state, channel, layout)
            if on_shrink is not None:
                now = gather_grid_state(state, grid, cur_layout)
                shrunk = on_shrink(grid, gathered, now)
                del now
            del gathered
            data = data_of(group.world)
            if health is not None:
                health = _Health(args.health_every, group.world, lead)
    total = time.perf_counter() - t0

    warm = step_times[1:] or step_times
    step_s = sum(warm) / len(warm) if warm else float("nan")
    tokens = grid.nodes * args.per_node_batch * args.seq_len
    ctx = step_fn.tp
    mine = {"device": str(device),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "gossip_s": channel.timings,
            "staged_bytes": channel.staged_bytes,
            "tp": None if ctx is None else (ctx.seconds, ctx.staged_bytes, ctx.calls)}
    every = [None] * world.world
    torch.distributed.all_gather_object(every, mine, group=world.pg)
    rounds = [len(m["gossip_s"] or ()) for m in every]
    result = {
        "arch": args.arch or args.preset,
        "n_layers": cfg.n_layers,
        "params_per_node": n_params,
        "n_nodes": grid.nodes,
        "tp": tp,
        "processes": True,
        "backend": group.backend,
        "devices": [m["device"] for m in every],
        "gossip_impl": args.gossip_impl,
        "algorithm": args.algorithm,
        "fused_update": args.fused_update,
        "fused_impl": args.fused_impl if args.fused_update else None,
        "flat_planes": args.flat_planes,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "start_step": start,
        "losses": losses,
        **model_metrics,
        "lrs": lrs,
        "gossip_gaps": gaps,
        "step_times_s": step_times,
        "step_s": step_s,
        "steps_timed": len(warm),
        "tokens_per_s": tokens / step_s,
        "peak_mem_bytes": mine["peak_mem_bytes"],
        "peak_mem_bytes_by_rank": [m["peak_mem_bytes"] for m in every],
        "card_used_bytes": max(card_used) if card_used else None,
        "drill": drill,
    }
    if args.measure_json:
        # host seconds of one channel.apply between device syncs, the
        # rank's mean over the run, and the bytes it staged per round
        result["gossip_s_per_round"] = [sum(m["gossip_s"]) / max(len(m["gossip_s"]), 1)
                                        for m in every]
        result["staged_bytes_per_round"] = [m["staged_bytes"] / max(r, 1)
                                            for m, r in zip(every, rounds)]
        if tp > 1:
            # the model group's collectives per step (each waits for the card
            # first), by rank: host seconds, staged bytes and count
            n_steps = max(len(step_times), 1)
            result["tp_s_per_step"] = [m["tp"][0] / n_steps for m in every]
            result["tp_staged_bytes_per_step"] = [m["tp"][1] / n_steps for m in every]
            result["tp_calls_per_step"] = [m["tp"][2] / n_steps for m in every]
    if args.track_consensus:
        result["consensus_sq"] = consensus
    if shrunk is not None:
        result["on_shrink"] = shrunk
    if health is not None:
        result["health"] = health.states
        every_q = [None] * group.world
        torch.distributed.all_gather_object(every_q, _quarantined(state), group=group.pg)
        result["quarantined"] = [q for part in every_q for q in part]
    if lead:
        print(f"done: {len(losses)} steps in {total:.1f}s; steady step {step_s:.4f}s, "
              f"{result['tokens_per_s']:.0f} tokens/s", flush=True)
        if args.measure_json:
            with open(args.measure_json, "w") as f:
                json.dump({"measured_step_s": step_s, **result}, f, indent=2)
            print(f"wrote {args.measure_json}", flush=True)
    if serve is not None and lead:
        result["serve"] = _drain(args, pub, engine, serve)
    if args.ckpt_dir and not saved:  # the final state, unless the last step saved it
        checkpoint(state, grid)
    # host seconds on rank 0: gather + write per checkpoint; restore on rank
    # 0 + scatter + placing this rank's node on its device
    result["save_s"], result["restore_s"] = save_s, restore_s
    return result


if __name__ == "__main__":
    main()
