"""Dry run of one rank's program on the production grids, on the meta device
(the port of ``repro.launch.dryrun``).

For each (arch x shape x mesh) cell this builds one rank's real program of
the ``(nodes x tp)`` grid — the distributed train step for a train shape,
the serve prefill or decode step otherwise — on a
:func:`~repro_torch.launch.mesh.dry_grid` (no process group) with every
tensor on the meta device, runs it once at the shape's per-node batch in
bf16 under the cost model's recorder (:mod:`.costmodel`), and records:

* the live-bytes tracker's memory (proves it fits): the arguments, the
  peak of the other live storages as ``temp_bytes``, the outputs;
* the FLOPs and bytes of every op, each hand-written kernel launch as one
  unit with its kernel's work (the stage kernel in the update tail, flash
  attention in prefill: what the card runs);
* the collectives each seam issued, priced by the ring rules;
* the three roofline terms on the H100 (:mod:`.roofline`) and the dominant
  one, and MODEL_FLOPS over the counted FLOPs.

Nothing is allocated: a meta tensor has a shape and a dtype only, the kernel
entry points return empty meta outputs, and the dry group's collectives
return meta tensors.  ``pod1`` is 16 nodes x tp 16 and ``pod2`` 32 x 16,
the reference's ``make_production_mesh``; :func:`run_cell` also takes an
explicit ``(nodes, tp)``.  Every family's cells run at tp 16 but
whisper-tiny's serve cells, which stop at ``check_tp`` and record
``status: "error"`` naming the reference's own fault (its sharded serving
of the encoder-decoder fails), and deepseek-v2-lite's (beyond the
reference's registry), which stop there too: latent attention has no
tensor-parallel or serve path yet; ``long_500k`` skips where the reference
skips it.  On meta tensors the sLSTM time loop is traced as one step that
the cost model counts once per token (:func:`.costmodel.trips`).

Records land in ``experiments/dryrun_torch/<tag>/<mesh>/<arch>__<shape>.json``
(:mod:`.report` reads them).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k,decode_32k --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeSpec
from ..core.optimizers import make_optimizer
from ..core.schedules import ScheduleConfig
from ..models import transformer as T
from ..train import serve as serve_mod
from ..train.step import TrainConfig, build_dist_train_step
from ..train.train_state import init_train_state, model_plane_layout
from ..utils import shard, tree_map
from .costmodel import CostRecorder, MemoryTracker
from .mesh import dry_grid
from .roofline import F32_FLOP_PER_S, HW, model_flops, roofline_terms

__all__ = ["MESHES", "OUT", "parser", "run_cell", "main"]

# the reference's make_production_mesh: (nodes, tp)
MESHES = {"pod1": (16, 16), "pod2": (32, 16)}
OUT = os.path.join("experiments", "dryrun_torch")
_META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _batch(cfg: ModelConfig, rows: int, seq: int, dtype, targets: bool = True) -> dict:
    b = {"tokens": _meta((rows, seq), torch.int64)}
    if targets:
        b["targets"] = _meta((rows, seq), torch.int64)
    if cfg.family == "vlm":
        b["patch_embeds"] = _meta((rows, cfg.num_patches, cfg.d_model), dtype)
    if cfg.arch_kind == "encdec":
        b["enc_frames"] = _meta((rows, cfg.enc_seq, cfg.d_model), dtype)
    return b


def _runtime(args) -> T.RuntimeConfig:
    # serving runs the kernels the card runs (flash, mlstm_chunk); the train
    # step's forward takes the plain paths whatever is set, as the
    # reference's trains on its jnp paths
    return T.RuntimeConfig(dtype=args.dtype, attn_impl="cuda", mlstm_impl="cuda",
                           decode_grouped_gqa=args.decode_grouped_gqa,
                           mlstm_chunk=args.mlstm_chunk, ssm_chunk=args.ssm_chunk)


def _grad_accum(args, per_node_b: int, seq: int) -> int:
    """The reference's auto rule (``--grad-accum 0``): the largest divisor
    of the per-node batch not above ``per_node_b * seq / 16384``."""
    if args.grad_accum:
        return args.grad_accum
    want = max(1, per_node_b * seq // 16384)
    return max(c for c in range(1, per_node_b + 1) if per_node_b % c == 0 and c <= want)


def _serve_params(cfg: ModelConfig, grid, dtype) -> dict:
    """The rank's serving shard of the parameters, in ``dtype``, on meta."""
    tp = grid.tp
    full = T.init_params(cfg, torch.Generator(), device=_META, tp=tp)
    axes = T.param_shard_axes(cfg, tp, serve=True)
    return tree_map(lambda x: _meta(x.shape, dtype), shard(full, axes, tp, grid.model.rank))


def build_cell(cfg: ModelConfig, shape: ShapeSpec, grid, args):
    """``(fn, args, meta)``: one rank's program on ``grid``, its meta
    arguments, and what MODEL_FLOPS reads (``training``, ``tokens``)."""
    nodes, tp = grid.nodes, grid.tp
    dtype = getattr(torch, args.dtype)
    rt = _runtime(args)
    if shape.kind == "train":
        per_node_b = shape.global_batch // nodes
        if per_node_b < 1 or shape.global_batch % nodes:
            raise ValueError(f"{shape.name}: a global batch of {shape.global_batch} does not "
                             f"split over {nodes} nodes")
        accum = _grad_accum(args, per_node_b, shape.seq_len)
        tcfg = TrainConfig(
            algorithm=args.algorithm, topology=args.topology, gossip_impl=args.gossip_impl,
            compression=args.compression, grad_accum=accum,
            schedule=ScheduleConfig(kind="constant", peak_lr=1e-3), runtime=rt,
            fused_update=True, flat_planes=args.flat_planes,
        )
        step, channel = build_dist_train_step(cfg, tcfg, grid)
        layout = model_plane_layout(cfg, tp) if args.flat_planes else None
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), 1, device=_META,
                                 channel=channel, plane_layout=layout, tp=tp,
                                 tp_index=grid.model.rank)
        batch = _batch(cfg, shape.global_batch, shape.seq_len, dtype)
        return step, (state, batch), {"training": True,
                                      "tokens": shape.global_batch * shape.seq_len,
                                      "grad_accum": accum}

    scfg = serve_mod.ServeConfig(runtime=rt, target_len=shape.seq_len)
    params = _serve_params(cfg, grid, dtype)
    if shape.kind == "prefill":
        step = serve_mod.build_prefill_step(cfg, scfg, grid, global_batch=shape.global_batch)
        batch = _batch(cfg, shape.global_batch, shape.seq_len, dtype, targets=False)
        return step, (params, batch), {"training": False,
                                       "tokens": shape.global_batch * shape.seq_len}
    # decode: one new token against a cache of seq_len slots, the rank's
    # rows (where the batch splits over the nodes) and its sequence shard
    step = serve_mod.build_decode_step(cfg, scfg, grid, target_len=shape.seq_len,
                                       global_batch=shape.global_batch)
    rows = shape.global_batch
    if serve_mod.batch_splits(rows, nodes):
        rows //= nodes
    cache = T.init_cache(cfg, rows, shape.seq_len, rt, device=_META, tp=tp)
    tokens = _meta((shape.global_batch, 1), torch.int64)
    return step, (params, tokens, cache, shape.seq_len - 1), {"training": False,
                                                             "tokens": shape.global_batch}


def _mesh_shape(mesh) -> tuple[str, int, int]:
    if isinstance(mesh, str):
        nodes, tp = MESHES[mesh]
        return mesh, nodes, tp
    nodes, tp = mesh
    return f"{nodes}x{tp}", int(nodes), int(tp)


def run_cell(arch: str, shape, mesh, args=None) -> dict:
    """One cell's record: ``arch`` a registry id (or a :class:`ModelConfig`),
    ``shape`` a name of
    :data:`~repro_torch.configs.SHAPES` or a :class:`ShapeSpec`, ``mesh``
    ``"pod1"``/``"pod2"`` or ``(nodes, tp)``, ``args`` :func:`parser`'s
    namespace (None: its defaults).  Raises where the port refuses the
    program (:func:`main` records that as an error)."""
    args = args if args is not None else parser().parse_args([])
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name, nodes, tp = _mesh_shape(mesh)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name, "status": "skipped",
                "reason": reason}
    grid = dry_grid(nodes, tp)
    t0 = time.perf_counter()
    fn, fn_args, meta = build_cell(cfg, shape, grid, args)
    t_build = time.perf_counter() - t0
    memory = MemoryTracker(fn_args)
    rec = CostRecorder(memory=memory)
    t0 = time.perf_counter()
    with rec:
        out = fn(*fn_args)
    t_run = time.perf_counter() - t0
    mem = memory.report(out)
    costs = rec.costs

    chips = nodes * tp
    n_params = T.count_params(T.init_params(cfg, torch.Generator(), device=_META, tp=tp))
    n_active = cfg.active_param_count()
    mf = model_flops(n_active, meta["tokens"], training=meta["training"])
    hw = HW(peak_flops=F32_FLOP_PER_S) if args.dtype == "float32" else HW()
    terms = roofline_terms(flops_per_device=costs.flops,
                           bytes_per_device=costs.materialized_bytes,
                           collective_egress=costs.collective_bytes, hw=hw)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "status": "ok",
        "chips": chips,
        "grid": [nodes, tp],
        "seconds": {"build": round(t_build, 2), "run": round(t_run, 2)},
        "params": n_params,
        "active_params": n_active,
        "model_flops": mf,
        "hlo_flops_per_device": costs.flops,
        "hlo_bytes_per_device": costs.materialized_bytes,
        "raw": {
            "product_flops": costs.product_flops,
            "loop_bytes_amplification": 1.0,  # eager: every op counted as it runs
            "naive_bytes_tripped": costs.naive_bytes,
            "materialized_bytes": costs.materialized_bytes,
            "kernel_launches": costs.kernel_launches,
            "kernel_flops": costs.kernel_flops,
            "kernel_bytes": costs.kernel_bytes,
        },
        "collectives": {
            "counts": costs.collective_counts,
            "egress_bytes": costs.collective_bytes,
            "breakdown_top": dict(sorted(costs.collective_breakdown.items(),
                                         key=lambda kv: -kv[1])[:12]),
        },
        "memory": mem,
        "roofline": terms,
        "hw": {"peak_flops": hw.peak_flops, "hbm_bw": hw.hbm_bw, "link_bw": hw.link_bw},
        "model_flops_utilization": mf / (costs.flops * chips) if costs.flops > 0 else 0.0,
        "knobs": {
            "algorithm": args.algorithm,
            "topology": args.topology,
            "gossip_impl": args.gossip_impl,
            "compression": args.compression,
            "grad_accum": meta.get("grad_accum", args.grad_accum),
            "remat": False,  # the port has no remat
            "dtype": args.dtype,
            "decode_grouped_gqa": args.decode_grouped_gqa,
            "mlstm_chunk": args.mlstm_chunk,
            "ssm_chunk": args.ssm_chunk,
            "fused_update": True,  # the stage kernel, as the card runs it
            "flat_planes": args.flat_planes,
        },
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    p.add_argument("--out", default=OUT)
    p.add_argument("--tag", default="baseline")
    p.add_argument("--algorithm", default="decentlam")
    p.add_argument("--topology", default="exp")
    p.add_argument("--gossip-impl", dest="gossip_impl", default="ppermute")
    p.add_argument("--compression", default=None)
    p.add_argument("--grad-accum", dest="grad_accum", type=int, default=0,
                   help="0 = auto (cap ~16k microbatch tokens per node)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--mlstm-chunk", dest="mlstm_chunk", type=int, default=128)
    p.add_argument("--decode-grouped-gqa", dest="decode_grouped_gqa", action="store_true")
    p.add_argument("--ssm-chunk", dest="ssm_chunk", type=int, default=128)
    p.add_argument("--flat-planes", dest="flat_planes",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--skip-existing", action="store_true")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]

    failures = []
    for mesh_name in meshes:
        outdir = os.path.join(args.out, args.tag, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            for shape_name in shapes:
                path = os.path.join(outdir, f"{arch}__{shape_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {mesh_name} {arch} {shape_name}")
                    continue
                print(f"[dryrun] mesh={mesh_name} arch={arch} shape={shape_name}", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh_name, args)
                except Exception as e:  # noqa: BLE001 — report and continue
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures.append((mesh_name, arch, shape_name))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                if rec["status"] == "ok":
                    r, m = rec["roofline"], rec["memory"]
                    print("  -> compute %.3es memory %.3es collective %.3es dominant=%s; "
                          "args %.2f GiB, temp %.2f GiB; %s; %.1fs"
                          % (r["compute_s"], r["memory_s"], r["collective_s"], r["dominant"],
                             m["argument_bytes"] / 2**30, m["temp_bytes"] / 2**30,
                             rec["raw"]["kernel_launches"], rec["seconds"]["run"]),
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"  -> skipped: {rec['reason']}")
    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print("\nAll requested cells passed.")


if __name__ == "__main__":
    main()
