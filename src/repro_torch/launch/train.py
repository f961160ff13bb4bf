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
checkpoints and writes them; ``--failure-drill`` shrinks the group to n/2
halfway (rank 0 gathers the state and collapses it with
``elastic_reshape``, the upper half of the ranks leave, the survivors form
a new group and resume).  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE``
set) the same flags run this process as one rank of the launched group.

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

    # several cards, one process each (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-0.6b --steps 5 --seq-len 256 --per-node-batch 4 --fused-update \\
        --flat-planes

    # granite-moe-1b-a400m (32 experts, top-8) cut to 12 of its 24 layers, on
    # planes; the log line adds the cross entropy and the router terms
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch granite-moe-1b-a400m --depth 12 --steps 5 --seq-len 256 \\
        --per-node-batch 4 --fused-update --fused-impl triton --flat-planes

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
    gather_state,
    init_train_state,
    model_plane_layout,
    reconcile_plane_state,
    scatter_state,
)
from .mesh import init_node_group, run_ranks, subgroup
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
    p.add_argument("--tp", type=int, default=1, help="model-parallel size (only 1 is ported)")
    p.add_argument("--preset", default="tiny", choices=["tiny"])
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


def _serve_demo(args, cfg, layout, channel, device, runtime, on_serve):
    """The serving-while-training demo: a publisher over the plane layout, an
    engine (4 slots, prompts up to 32 tokens, 16 new) over it, and
    ``--serve-requests`` requests of 4..32 tokens from ``default_rng(7)``.
    Returns ``(publisher, engine, serve(step, state))``: node 0 offers its
    weights every ``--publish-every`` steps, then the engine ticks once."""
    import numpy as np

    from ..core.gossip import fleet_node_gaps
    from ..serve import Request, ServeEngine, WeightPublisher

    pub = WeightPublisher(layout, gap_threshold=args.publish_gap_threshold)
    engine = ServeEngine(cfg, slots=4, max_prompt=32, max_new=16, publisher=pub,
                         runtime=runtime, device=device)
    if on_serve is not None:
        on_serve(engine, pub)
    srng = np.random.default_rng(7)
    for i in range(args.serve_requests):
        n = int(srng.integers(4, 33))
        engine.submit(Request(rid=i, tokens=srng.integers(0, cfg.vocab_size, n)
                              .astype(np.int32), max_new_tokens=16))

    def serve(step, state):
        """One cooperative slice: maybe publish, then one engine tick."""
        if step % args.publish_every == 0:
            gaps = fleet_node_gaps(channel, state["channel"])
            # node 0's iterate: its slice of each plane (one copy per
            # bucket), or of each leaf on the per-leaf path
            if "planes" in state:
                src = {k: p[0] for k, p in state["planes"].items()}
            else:
                src = tree_map(lambda x: x[0], state["params"])
            shipped = pub.offer(src, version=step + 1, gap=int(gaps[0]))
            print(f"publish v{step + 1} gap={int(gaps[0])} -> "
                  f"{'shipped' if shipped else 'held (gate)'}", flush=True)
        engine.tick()

    return pub, engine, serve


def _channel_layout(host: dict, manifest: dict, layout: str) -> dict:
    """A restored state whose delay ring was written by the other trainer
    (``"channel_layout"`` in the manifest: ``stacked`` ring slots are
    ``(ring, n, ...)``, ``per-node`` ones ``(n, ring, ...)``) loses the ring,
    which ``ensure_channel_state`` then re-initializes."""
    stored = manifest.get("channel_layout")
    if stored is None or stored == layout or "delay" not in host.get("channel", {}):
        return host
    return {**host, "channel": {k: v for k, v in host["channel"].items() if k != "delay"}}


def resume_state(ckpt_dir: str, cfg, channel, layout, flat_planes: bool, n_nodes: int,
                 device) -> dict:
    """The latest checkpoint under ``ckpt_dir`` as a run's state on
    ``device``: elastically reshaped when it holds another node count,
    checked against the plane layout, its optimizer buckets (and parameters)
    in the form the run keeps (``flat_planes``), its channel state kept
    where it matches ``channel``."""
    host, manifest = restore_checkpoint(ckpt_dir)
    host = _channel_layout(host, manifest, "stacked")
    stored_n = tree_leaves(host["params"])[0].shape[0]
    if stored_n != n_nodes:
        print(f"elastic reshape {stored_n} -> {n_nodes}", flush=True)
        host = elastic_reshape(host, n_nodes)
    cur_layout = layout or model_plane_layout(cfg)
    check_plane_manifest(manifest, cur_layout)
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


def _model_config(args):
    cfg = get_config(args.arch, smoke=args.smoke) if args.arch else tiny_lm()
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
    ``"serve"`` stats.  With ``--resume`` the run continues from the latest
    checkpoint's step to ``--steps``, and the result's lists cover the steps
    it ran.

    With ``--simulate-nodes`` (or under torchrun) the run is
    :func:`rank_main` on every rank and the result is rank 0's; ``on_step``
    and ``on_shrink`` then run in every rank's process and must be
    picklable (module-level functions)."""
    args = _parse(argv)
    if args.tp != 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor parallelism is not ported yet (ROADMAP queue 1, item 2)")
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.simulate_nodes or launched:
        if args.serve_while_training:
            raise NotImplementedError(
                "--serve-while-training with one process per node is not ported yet "
                "(ROADMAP.md, queue 1); use the stacked trainer (--nodes)")
        resolve_device(args.device)  # no CUDA on a CUDA request raises here
        if launched:
            group = init_node_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                                    "env://", device=args.device)
            try:
                return rank_main(group, argv, on_step, on_shrink)
            finally:
                torch.distributed.destroy_process_group()
        return run_ranks(rank_main, args.simulate_nodes, argv, on_step, on_shrink,
                         device=args.device, timeout_s=args.timeout or None)[0]
    device = resolve_device(args.device)
    cfg = _model_config(args)
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
        heterogeneity=args.heterogeneity,
    ))

    def checkpoint(state):
        return save_checkpoint(args.ckpt_dir, state,
                               metadata={"n_nodes": n_nodes, "algorithm": args.algorithm,
                                         "channel_layout": "stacked"},
                               plane_layout=layout if args.flat_planes else None)

    losses, lrs, gaps, consensus, step_times = [], [], [], [], []
    model_metrics = {k: [] for k in MODEL_METRICS}
    skipped_steps, saved = 0, False
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
    print(f"done: {len(losses)} steps in {total:.1f}s; steady step {step_s:.4f}s, "
          f"{result['tokens_per_s']:.0f} tokens/s", flush=True)
    if serve is not None:
        # drain what the cooperative ticks left in flight (unless the gate
        # never cleared a single version: nothing to serve with)
        done = engine.run_until_drained() if pub.current else engine.completions
        ps, es = pub.stats(), engine.stats()
        print(f"serve: {len(done)}/{args.serve_requests} requests done, {es['swaps']} weight "
              f"swap(s); published {ps['published']}/{ps['offers']} offers (rate "
              f"{ps['publish_rate']:.2f}, threshold {ps['gap_threshold']}, final "
              f"v{ps['current_version']})", flush=True)
        result["serve"] = {"publisher": ps, "engine": es, "completed": len(done)}
    if args.measure_json:
        with open(args.measure_json, "w") as f:
            json.dump({"measured_step_s": step_s, **result}, f, indent=2)
        print(f"wrote {args.measure_json}")
    if args.ckpt_dir and not saved:  # the final state, unless the last step saved it
        print(f"checkpointed -> {checkpoint(state)}", flush=True)
    return result


def _resume_ranks(group, ckpt_dir: str, cfg, channel, layout, flat_planes: bool) -> dict:
    """:func:`resume_state` for one rank of the node group: rank 0 restores
    the latest checkpoint (elastically reshaped to the group's node count,
    checked against the plane layout) and scatters it; each rank moves its
    node to its device and brings it into the form the run keeps, its
    channel state kept where it matches ``channel``."""
    host = None
    cur_layout = layout or model_plane_layout(cfg)
    if group.rank == 0:
        host, manifest = restore_checkpoint(ckpt_dir)
        host = _channel_layout(host, manifest, "per-node")
        stored_n = tree_leaves(host["params"])[0].shape[0]
        if stored_n != group.world:
            print(f"elastic reshape {stored_n} -> {group.world}", flush=True)
            host = elastic_reshape(host, group.world)
        check_plane_manifest(manifest, cur_layout)
        host = {**host, "channel": _per_node_channel(host.get("channel", {}), group.world)}
    state = _to_device(scatter_state(host, group), group.device)
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


def rank_main(group, argv, on_step=None, on_shrink=None) -> dict:
    """The trainer on one rank of the node ``group`` (``repro``'s shard_map
    trainer at tp = 1): this rank's node of the state, the global batch of
    every step (the rank trains on its rows), checkpoints gathered to and
    written by rank 0, and the failure drill.  Returns the run's result
    (the losses are the mean over nodes, the same on every rank).

    ``on_shrink(group, gathered, state)``, if given, runs on every survivor
    of the drill once its state is rebuilt: ``gathered`` is the global state
    before the shrink on rank 0 (None elsewhere), ``group`` the new group;
    rank 0's return value is the result's ``"on_shrink"``."""
    args = _parse(argv)
    device = group.device
    cfg = _model_config(args)
    tcfg = _train_config(args)
    opt = make_optimizer(tcfg.opt_config())
    layout = model_plane_layout(cfg) if args.flat_planes else None
    cuda = device.type == "cuda"
    print(group.describe(), flush=True)
    lead = group.rank == 0

    def build(group):
        step_fn, channel = build_dist_train_step(cfg, tcfg, group)
        if args.measure_json:
            channel.timings = []
        return step_fn, channel

    step_fn, channel = build(group)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    save_s, restore_s = [], None
    if args.resume and args.ckpt_dir:
        t = time.perf_counter()
        state = _resume_ranks(group, args.ckpt_dir, cfg, channel, layout, args.flat_planes)
        restore_s = time.perf_counter() - t
        if lead:
            print(f"resumed from step {state['step']} in {restore_s:.1f}s", flush=True)
    else:
        state = init_train_state(cfg, opt, 1, device=device, channel=channel,
                                 plane_layout=layout)
    start = state["step"]
    n_params = count_params(state["params"])
    if lead:
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
              f"params/node x {group.world} nodes, one process each", flush=True)

    def data_of(n):
        return SyntheticLM(SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq_len,
            per_node_batch=args.per_node_batch, n_nodes=n, heterogeneity=args.heterogeneity))

    def checkpoint(state, group):
        t = time.perf_counter()
        host = gather_state(state, group)
        if host is not None:
            path = save_checkpoint(args.ckpt_dir, host,
                                   metadata={"n_nodes": group.world,
                                             "algorithm": args.algorithm,
                                             "channel_layout": "per-node"},
                                   plane_layout=layout)
            save_s.append(time.perf_counter() - t)
            print(f"checkpointed -> {path}", flush=True)

    data = data_of(group.world)
    losses, lrs, gaps, consensus, step_times, card_used = [], [], [], [], [], []
    model_metrics = {k: [] for k in MODEL_METRICS}
    skipped_steps, saved, drill, shrunk = 0, False, None, None
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
        losses.append(loss)
        lrs.append(float(metrics["lr"]))
        gaps.append(metrics["gossip_gap"])
        msg = f"step {step:5d} loss {loss:.4f} lr {lrs[-1]:.2e}" + _model_metrics(
            cfg, metrics, model_metrics)
        if args.track_consensus:
            consensus.append(float(metrics["consensus_sq"]))
            msg += f" consensus {consensus[-1]:.3e}"
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"{msg} ({step_times[-1]:.3f}s, {group.world} nodes)", flush=True)
        saved = bool(args.ckpt_dir) and (step + 1) % args.ckpt_every == 0
        if saved:
            checkpoint(state, group)
        if args.failure_drill and drill is None and step == (start + args.steps) // 2:
            new_n = max(1, group.world // 2)
            if lead:
                print(f"FAILURE DRILL: gather, shrink {group.world} -> {new_n}, re-form the "
                      "group, resume", flush=True)
            gathered = gather_state(state, group)
            del state
            host = elastic_reshape(gathered, new_n) if lead else None
            drill = {"step": step, "from": group.world, "to": new_n}
            sub = subgroup(group, list(range(new_n)))
            if sub is None:  # this rank leaves the fleet
                return {"left_at_step": step, "rank": group.rank}
            group = sub
            step_fn, channel = build(group)
            state = _to_device(scatter_state(host, group), device)
            del host
            state = reconcile_plane_state(state, layout or model_plane_layout(cfg),
                                          args.flat_planes)
            state = ensure_channel_state(state, channel, layout)
            if on_shrink is not None:
                shrunk = on_shrink(group, gathered, state)
            del gathered
            data = data_of(group.world)
    total = time.perf_counter() - t0

    warm = step_times[1:] or step_times
    step_s = sum(warm) / len(warm) if warm else float("nan")
    tokens = group.world * args.per_node_batch * args.seq_len
    mine = {"device": str(device),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "gossip_s": channel.timings,
            "staged_bytes": channel.staged_bytes}
    every = [None] * group.world
    torch.distributed.all_gather_object(every, mine, group=group.pg)
    rounds = [len(m["gossip_s"] or ()) for m in every]
    result = {
        "arch": args.arch or args.preset,
        "n_layers": cfg.n_layers,
        "params_per_node": n_params,
        "n_nodes": group.world,
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
    if args.track_consensus:
        result["consensus_sq"] = consensus
    if shrunk is not None:
        result["on_shrink"] = shrunk
    if lead:
        print(f"done: {len(losses)} steps in {total:.1f}s; steady step {step_s:.4f}s, "
              f"{result['tokens_per_s']:.0f} tokens/s", flush=True)
        if args.measure_json:
            with open(args.measure_json, "w") as f:
                json.dump({"measured_step_s": step_s, **result}, f, indent=2)
            print(f"wrote {args.measure_json}", flush=True)
    if args.ckpt_dir and not saved:  # the final state, unless the last step saved it
        checkpoint(state, group)
    # host seconds on rank 0: gather + write per checkpoint; restore on rank
    # 0 + scatter + placing this rank's node on its device
    result["save_s"], result["restore_s"] = save_s, restore_s
    return result


if __name__ == "__main__":
    main()
