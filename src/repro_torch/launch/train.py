"""Decentralized trainer: ``n`` nodes stacked on one device.

Runs DecentLaM (or any of the eleven algorithms) on synthetic LM data with
the node replicas stacked on one card (``--nodes N``), the ``W @`` gossip
between them, and the update tail either through the reference optimizer
step or, with ``--fused-update``, through the fused stage kernel.

Examples::

    # qwen3-0.6b at full width, 4 nodes, Triton update tail (needs a GPU)
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 \\
        --arch qwen3-0.6b --steps 5 --seq-len 256 --per-node-batch 4 \\
        --algorithm decentlam --topology exp --fused-update --fused-impl triton

    # tiny LM on the host CPU (the kernel's plain version)
    PYTHONPATH=src python -m repro_torch.launch.train --nodes 4 --preset tiny \\
        --steps 2 --seq-len 32 --per-node-batch 2 --fused-update --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..configs import get_config, tiny_lm
from ..core.optimizers import make_optimizer
from ..core.schedules import ScheduleConfig
from ..data.pipeline import prefetch_to_device
from ..data.synthetic import SyntheticLM, SyntheticLMConfig
from ..models.transformer import count_params
from ..train.step import TrainConfig, build_train_step
from ..train.train_state import init_train_state
from ..utils import resolve_device


def _parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nodes", type=int, default=4,
                   help="decentralized nodes, stacked as replicas on the one device")
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
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=128)
    p.add_argument("--per-node-batch", dest="per_node_batch", type=int, default=8)
    p.add_argument("--heterogeneity", type=float, default=0.2)
    p.add_argument("--fused-update", dest="fused_update", action="store_true")
    p.add_argument("--fused-impl", dest="fused_impl", default="triton",
                   choices=["triton", "torch"],
                   help="the stage kernel (triton) or its plain version (torch)")
    p.add_argument("--no-finite-guard", dest="finite_guard", action="store_false",
                   help="disable the non-finite-gradient skip guard")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--measure-json", dest="measure_json", default=None,
                   help="write the run's step time, tokens/s and peak memory here")
    p.add_argument("--log-every", dest="log_every", type=int, default=10)
    return p.parse_args(argv)


def main(argv=None, *, on_step=None) -> dict:
    """Run the trainer; returns ``{losses, lrs, step_s, tokens_per_s,
    peak_mem_bytes, ...}`` (losses/lrs per step).  ``on_step(step)``, if
    given, is called after each step has finished on the device (a
    profiler's ``step``, for example)."""
    args = _parse(argv)
    device = resolve_device(args.device)
    if args.arch:
        cfg = get_config(args.arch, smoke=args.smoke)
    else:
        cfg = tiny_lm()
    if args.depth:
        cfg = dataclasses.replace(cfg, n_layers=args.depth)
    n_nodes = args.nodes

    tcfg = TrainConfig(
        algorithm=args.algorithm,
        topology=args.topology,
        momentum=args.momentum,
        schedule=ScheduleConfig(
            kind="warmup_cosine", peak_lr=args.lr,
            warmup_steps=min(args.warmup, max(args.steps // 5, 1)),
            total_steps=max(args.steps, 2),
        ),
        fused_update=args.fused_update,
        fused_impl=args.fused_impl,
        finite_guard=args.finite_guard,
    )
    step_fn, channel = build_train_step(cfg, tcfg, n_nodes)
    opt = make_optimizer(tcfg.opt_config())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(cfg, opt, n_nodes, device=device, channel=channel)
    n_params = count_params(state["params"]) // n_nodes
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"params/node x {n_nodes} nodes on {device}", flush=True)

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        per_node_batch=args.per_node_batch, n_nodes=n_nodes,
        heterogeneity=args.heterogeneity,
    ))

    losses, lrs, step_times = [], [], []
    t0 = time.perf_counter()
    for step, batch in enumerate(prefetch_to_device(data.batch, device, args.steps)):
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        if cuda:
            torch.cuda.synchronize(device)
        step_times.append(time.perf_counter() - ts)
        if on_step is not None:
            on_step(step)
        losses.append(loss)
        lrs.append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} lr {lrs[-1]:.2e} "
                  f"({step_times[-1]:.3f}s)", flush=True)
    total = time.perf_counter() - t0

    # steady state excludes step 0 (kernel JIT, cuBLAS/allocator warm-up)
    warm = step_times[1:] or step_times
    step_s = sum(warm) / len(warm)
    tokens = n_nodes * args.per_node_batch * args.seq_len
    result = {
        "arch": args.arch or args.preset,
        "n_layers": cfg.n_layers,
        "params_per_node": n_params,
        "n_nodes": n_nodes,
        "algorithm": args.algorithm,
        "fused_update": args.fused_update,
        "fused_impl": args.fused_impl if args.fused_update else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "losses": losses,
        "lrs": lrs,
        "step_times_s": step_times,
        "step_s": step_s,
        "steps_timed": len(warm),
        "tokens_per_s": tokens / step_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
    }
    print(f"done: {args.steps} steps in {total:.1f}s; steady step {step_s:.4f}s, "
          f"{result['tokens_per_s']:.0f} tokens/s", flush=True)
    if args.measure_json:
        with open(args.measure_json, "w") as f:
            json.dump({"measured_step_s": step_s, **result}, f, indent=2)
        print(f"wrote {args.measure_json}")
    return result


if __name__ == "__main__":
    main()
