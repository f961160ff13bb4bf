#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero and prints no
result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. hold the Triton ``fused_update`` stage kernel against its plain version
   on the card, for every (kind, op, ctx) that ``stage_plan`` yields for the
   11 algorithms x {plain, nesterov, lars+clip+wd}, with x in float32 and in
   bfloat16, at a ragged and at a large leaf size;
3. the main path: ``repro_torch.launch.train`` on qwen3-0.6b at full width,
   4 stacked nodes, exp topology, decentlam, ``--fused-update --fused-impl
   triton``, 8 steps; finite losses and exactly 28 kernel launches per step
   (14 of each stage); the step time from the unprofiled steps 1..4, and
   where the device time goes from torch.profiler on steps 6 and 7;
4. the same run at 4 layers, 3 steps, with ``--fused-impl torch`` (the plain
   version) beside ``--fused-impl triton``: equal loss trajectories;
5. the kernel at the main path's leaf shapes: held against its plain
   version, then timed beside its bound (the larger of bytes / 3.35 TB/s and
   f32 operations / 67 TFLOP/s), the plain version's time and, where one
   PyTorch call computes the stage, that call's time;
6. the CUDA ``flash_attention`` kernel against its plain version on the
   card: causal x window {0, 100} x GQA group {1, 2, 4} x hd {64, 80, 128} x
   ragged Sq, Sk in {1, 77, 300} x {f32, bf16}, and the two main-path shapes
   (qwen3-0.6b prefill, h2o-danube-1.8b with its 4096 window);
7. the serve main path: ``repro_torch.serve.ServeEngine`` on qwen3-0.6b at
   full width (28 layers, f32, random weights from seed 0), 8 slots,
   ``max_prompt`` 2048, ``max_new`` 32, 16 requests of 256..2048 prompt
   tokens: all complete and the kernel launched exactly 28 times per
   prefill; prefill ms per wave, decode ms per step, generated tokens/s,
   peak memory, and where the device time of one prefill wave and of two
   decode steps goes;
8. the same engine at 4 layers with ``attn_impl="cuda"`` and ``"torch"``:
   token-identical, or, where they part, the plain run's top-two logit gap
   there is below the logit tolerance (a near tie);
9. the flash kernel at the main-path shape timed beside its bound, its plain
   version and ``scaled_dot_product_attention``.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Triton kernels compile at first use into
``build/triton`` inside the checkout; the CUDA kernel is built by nvcc into
``build/cuda`` while phases 2-5 run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (same sheet)
# f32 operations per element of each timed stage (a multiply-add counts 2,
# a division 1): grad_step is x - lr*g; decentlam_post is (x - mix) / lr,
# then beta*m + g~, then x - lr*m
STAGE_FLOPS = {"grad_step": 2, "decentlam_post": 6}
# kernel vs plain version, same inputs: float32 outputs differ by FMA
# contraction (about one ulp); a bfloat16 x output may then round one bf16
# ulp (2**-8) apart
F32_TOL = 2e-6
BF16_TOL = 1e-2
# loss trajectories, kernel vs plain tail, 3 steps at 4 layers
LOSS_RTOL = 1e-5
MAIN = dict(nodes=4, arch="qwen3-0.6b", steps=5, seq_len=256, per_node_batch=4)
# flash attention at the main path's shapes, (B, S, H, Hkv, hd, window), causal:
# the qwen3-0.6b prefill wave of the serve main path, and h2o-danube-1.8b
# (hd 80) at a length where its 4096 window cuts in
FA_MAIN_SHAPES = {"qwen3-0.6b prefill": (8, 2048, 16, 8, 64, 0),
                  "h2o-danube-1.8b": (1, 4608, 32, 8, 80, 4096)}
# flash attention, kernel vs plain version: the JAX package's tolerances for
# its own kernel (tests/test_kernels.py)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the serve main path: qwen3-0.6b, 8 slots, 16 requests in two admission waves
SERVE = dict(arch="qwen3-0.6b", slots=8, max_prompt=2048, max_new=32, requests=16,
             min_prompt=256)
# kernel path vs plain path: where the generated tokens part, the plain
# run's top-two logit gap there must be below this share of max |logit|
LOGIT_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def _stage_inputs(torch, kind, op, ctx, numel, x_dtype, gen):
    from repro_torch.kernels.fused_update.kernel import stage_io

    names_in, names_out = stage_io(kind, op, ctx)
    shape = (MAIN["nodes"], numel // MAIN["nodes"])
    ins = {}
    for n in names_in:
        t = torch.randn(shape, generator=gen, device="cuda")
        ins[n] = t.to(x_dtype) if n == "x" else t
    if "mix" in ins and "x" in ins:  # a gossip output lies near x
        ins["mix"] = ins["x"].float() + 0.01 * ins["mix"]
    out_dtypes = {n: (x_dtype if n == "x" else torch.float32) for n in names_out}
    return ins, out_dtypes


def _svec(torch, lr=0.01):
    return torch.tensor([lr, 0.7, 1.3, 0.6], dtype=torch.float32, device="cuda")


def phase_kernel_vs_plain(torch):
    from repro_torch.core.optimizers import ALGORITHMS, OptimizerConfig
    from repro_torch.core.update_spec import stage_plan
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, stage_plain

    feats = {
        "plain": {},
        "nesterov": {"nesterov": True},
        "lars-clip-wd": {"lars": True, "grad_clip": 1.0, "weight_decay": 1e-2},
    }
    stages = {}
    for algo in ALGORITHMS:
        for kw in feats.values():
            for kind, op, ctx in stage_plan(OptimizerConfig(algorithm=algo, **kw)):
                stages[(kind, op, ctx)] = algo
    # both sizes ragged (not a multiple of the block or of 16): one kernel
    # specialization serves both, and the masked tail is exercised
    sizes = {"ragged": 4 * 12_345, "large": 4 * 1_048_583}
    gen = torch.Generator(device="cuda").manual_seed(0)
    svec = _svec(torch)
    worst = 0.0
    t0 = time.perf_counter()
    for (kind, op, ctx) in stages:
        for x_dtype in (torch.float32, torch.bfloat16):
            for numel in sizes.values():
                ins, out_dtypes = _stage_inputs(torch, kind, op, ctx, numel, x_dtype, gen)
                want = stage_plain(kind, op, ctx, svec, ins, out_dtypes)
                got = {n: torch.empty_like(w) for n, w in want.items()}
                fused_stage_launch(kind, op, ctx, svec, ins, got)
                torch.cuda.synchronize()
                for n in want:
                    tol = BF16_TOL if got[n].dtype == torch.bfloat16 else F32_TOL
                    w, g = want[n].float(), got[n].float()
                    scale = float(w.abs().max())
                    torch.testing.assert_close(
                        g, w, rtol=tol, atol=tol * scale,
                        msg=lambda m, n=n: f"{kind}/{op} {ctx} {x_dtype} {numel} {n}: {m}",
                    )
                    if got[n].dtype == torch.float32:
                        worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
    log(f"phase 2: Triton fused_update == plain version for {len(stages)} distinct "
        f"(kind, op, ctx) stages of {len(ALGORITHMS)} algorithms x {len(feats)} feature "
        f"sets, x in f32/bf16, sizes {sorted(sizes.values())} "
        f"(f32 rtol {F32_TOL}, bf16 rtol {BF16_TOL}; worst f32 error / scale "
        f"{worst:.3g}) in {time.perf_counter() - t0:.1f}s")


def _train_argv(steps, impl, depth=0):
    argv = ["--nodes", str(MAIN["nodes"]), "--arch", MAIN["arch"], "--steps", str(steps),
            "--seq-len", str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
            "--algorithm", "decentlam", "--topology", "exp", "--fused-update",
            "--fused-impl", impl, "--log-every", "1"]
    return argv + (["--depth", str(depth)] if depth else [])


def phase_main_path(torch):
    """The main path, profiled: ``train.main`` runs MAIN["steps"] + 3 steps;
    steps 1..MAIN["steps"]-1 run unprofiled (the step time), the profiler
    warms up on the next one and records the last two (where the device
    time goes)."""
    import math

    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train

    steps, timed = MAIN["steps"] + 3, slice(1, MAIN["steps"])
    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=MAIN["steps"], warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        reset_launches()
        res = train.main(_train_argv(steps, "triton"), on_step=lambda _: prof.step())
        launches = dict(fused_stage_launch.launches_by_op)
        total = fused_stage_launch.launches
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the main path: {res['losses']}")
    if total != 28 * steps or launches != {op: 14 * steps for op in STAGE_FLOPS}:
        raise RuntimeError(f"fused_update launched {total} times ({launches}), "
                           f"want 28 x {steps}: 14 x {steps} of each of {list(STAGE_FLOPS)}")
    log(f"phase 3: qwen3-0.6b full width ({res['params_per_node']:,} params/node, "
        f"{res['n_layers']} layers) x {res['n_nodes']} nodes, {steps} steps: "
        f"losses {[round(v, 4) for v in res['losses']]}, fused_update launches {total} "
        f"(= 28 x {steps}: {launches})")
    step_ms = 1e3 * sum(res["step_times_s"][timed]) / len(res["step_times_s"][timed])
    tokens = MAIN["nodes"] * MAIN["per_node_batch"] * MAIN["seq_len"]
    log(f"main path: step {step_ms:.1f} ms (mean of the unprofiled steps "
        f"{timed.start}..{timed.stop - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    if len(traced) != 1:
        raise RuntimeError(f"the profiler delivered {len(traced)} traces, want 1")
    _profile_report(torch, traced[0], step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
    torch.cuda.empty_cache()
    return launches


def phase_plain_vs_kernel_path(torch):
    from repro_torch.launch import train

    depth, steps = 4, 3
    kern = train.main(_train_argv(steps, "triton", depth))
    plain = train.main(_train_argv(steps, "torch", depth))
    torch.cuda.empty_cache()
    a, b = kern["losses"], plain["losses"]
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if worst > LOSS_RTOL:
        raise RuntimeError(f"loss trajectories differ (rtol {LOSS_RTOL}): kernel {a}, plain {b}")
    log(f"phase 4: {depth} layers, {steps} steps: kernel losses {a} == plain losses {b} "
        f"(max rel diff {worst:.3g} <= {LOSS_RTOL}); step {kern['step_s'] * 1e3:.1f} ms "
        f"kernel vs {plain['step_s'] * 1e3:.1f} ms plain")


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "fused_stage" in n:
        return "fused_update (Triton)"
    if "flash_fwd" in n:
        return "flash_attention (CUDA)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "gemv" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "softmax / reductions"
    if "copy" in n or "cat" in n or "index" in n or "embedding" in n or "fill" in n:
        return "copies / gathers / fills"
    return "other elementwise"


def _matmul_flops_per_step(cfg, n_nodes) -> float:
    """Forward + backward matmul FLOPs of one step: the projections, MLP and
    lm_head (the embedding is a gather), plus attention's two S x S products;
    the backward is twice the forward."""
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    b, s = MAIN["per_node_batch"], MAIN["seq_len"]
    per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f
    params = cfg.n_layers * per_layer + d * cfg.vocab_size
    fwd = 2 * params * b * s + cfg.n_layers * 2 * 2 * b * h * s * s * hd
    return 3.0 * fwd * n_nodes


def _device_kernels(torch, events):
    """``({kernel name: [launches, ms]}, busy ms)`` from a profiler's events."""
    kernels: dict[str, list] = {}
    for e in events:
        # the scheduled profiler also puts its "ProfilerStep#N" range on the
        # device timeline; that is an annotation, not device work
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(
                "ProfilerStep"):
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return kernels, busy


def _profile_report(torch, events, step_ms, profiled_ms):
    """Where a main-path step's device time goes, from the profiler's events
    over 2 steps, against the unprofiled step time ``step_ms``."""
    from repro_torch.configs import get_config

    kernels, busy = _device_kernels(torch, events)
    classes: dict[str, float] = {}
    for name, (_, ms) in kernels.items():
        classes[_kernel_class(name)] = classes.get(_kernel_class(name), 0.0) + ms
    steps = 2
    busy_ms = busy / steps
    if busy_ms > profiled_ms:  # one stream: the device cannot be busier than the wall
        raise RuntimeError(f"device time {busy_ms:.1f} ms/step exceeds the profiled steps' "
                           f"{profiled_ms:.1f} ms: the events count something twice")
    log(f"profile, 2 steady steps at full width: {step_ms:.1f} ms/step unprofiled "
        f"({profiled_ms:.1f} ms/step under the profiler); device busy {busy_ms:.1f} ms/step = "
        f"{busy_ms / step_ms:.1%} of the unprofiled step (idle {1 - busy_ms / step_ms:.1%})")
    for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"  {c}: {ms / steps:.1f} ms/step ({ms / busy:.1%} of device time)")
    flops = _matmul_flops_per_step(get_config(MAIN["arch"]), MAIN["nodes"])
    gemm_ms = classes.get("matmul (cuBLAS)", 0.0) / steps
    log(f"  matmul work {flops / 1e12:.2f} TFLOP/step (fwd + bwd, from the shapes) in "
        f"{gemm_ms:.1f} ms: {flops / gemm_ms / 1e9:.1f} TFLOP/s of the 67 f32 peak")
    for name, (cnt, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {ms / steps:8.2f} ms/step  {cnt // steps:5d} launches/step  {name[:90]}")


def _time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _library(torch, op):
    """One PyTorch call that computes the stage on the same inputs, or None.
    grad_step's x - lr*g is ``addcmul`` with lr read from the device vector;
    no single call computes decentlam_post's three coupled updates."""
    if op == "grad_step":
        return lambda svec, ins, out: torch.addcmul(ins["x"], ins["g"], svec[0], value=-1.0,
                                                    out=out["payload"])
    return None


def phase_timing(torch):
    """Each stage of the main path's update tail at its real leaf shapes
    (4 stacked nodes x the 14 qwen3-0.6b leaves, f32): kernel time, plain
    time, library time, bound.  Per step = sum over leaves (28 launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.fused_update.kernel import (
        fused_stage_launch,
        stage_bytes,
        stage_plain,
    )
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_leaves, tree_paths

    cfg = get_config(MAIN["arch"])
    one = T.init_params(cfg, torch.Generator(device="cuda"))
    shapes = [(MAIN["nodes"],) + tuple(t.shape) for t in tree_leaves(one)]
    paths = tree_paths(one)
    del one
    ctx = MathCtx(beta=0.9)
    svec = _svec(torch, lr=3e-3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    per_stage = {op: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "err": 0.0,
                      "library_ms": 0.0 if _library(torch, op) else None}
                 for op in STAGE_FLOPS}
    largest = {}
    big = max(range(len(shapes)), key=lambda i: torch.Size(shapes[i]).numel())
    for i, shape in enumerate(shapes):
        numel = torch.Size(shape).numel()
        iters = 5 if numel > 2**26 else 20
        for kind, op in (("pre", "grad_step"), ("post", "decentlam_post")):
            ins, out_dtypes = _stage_inputs(torch, kind, op, ctx, numel, torch.float32, gen)
            ins = {n: t.reshape(shape) for n, t in ins.items()}
            outs = {n: torch.empty(shape, dtype=dt, device="cuda") for n, dt in out_dtypes.items()}
            want = stage_plain(kind, op, ctx, svec, ins, out_dtypes)
            fused_stage_launch(kind, op, ctx, svec, ins, outs)
            torch.cuda.synchronize()
            for n in outs:
                torch.testing.assert_close(
                    outs[n], want[n], rtol=F32_TOL, atol=F32_TOL * float(want[n].abs().max()),
                    msg=lambda m, n=n: f"{paths[i]} {op} {n}: {m}",
                )
            err = max(float((outs[n] - want[n]).abs().max()) for n in outs)
            lib = _library(torch, op)
            lib_ms = None
            if lib is not None:
                lib_out = {n: torch.empty_like(t) for n, t in outs.items()}
                lib(svec, ins, lib_out)
                torch.cuda.synchronize()
                for n in outs:
                    torch.testing.assert_close(
                        lib_out[n], want[n], rtol=F32_TOL,
                        atol=F32_TOL * float(want[n].abs().max()),
                        msg=lambda m, n=n: f"library {paths[i]} {op} {n}: {m}",
                    )
                lib_ms = _time_ms(torch, lambda: lib(svec, ins, lib_out), iters)
                del lib_out
            del want
            ms = _time_ms(torch, lambda: fused_stage_launch(kind, op, ctx, svec, ins, outs), iters)
            plain_ms = _time_ms(torch, lambda: stage_plain(kind, op, ctx, svec, ins, out_dtypes),
                                iters)
            nbytes = stage_bytes(ins, outs)
            rec = per_stage[op]
            if lib_ms is not None:
                rec["library_ms"] += lib_ms
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            rec["bytes"] += nbytes
            rec["flops"] += numel * STAGE_FLOPS[op]
            rec["err"] = max(rec["err"], err)
            if i == big:
                largest[op] = (ms, plain_ms, lib_ms, nbytes, numel * STAGE_FLOPS[op])
            del ins, outs
            torch.cuda.empty_cache()
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"
    for op, (ms, plain_ms, lib_ms, nbytes, flops) in largest.items():
        bound_ms, by = _bound(nbytes, flops)
        log(f"largest leaf {paths[big]} {shapes[big]} f32, {op}: kernel {ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms by {by} ({nbytes / 1e9:.2f} GB / 3.35 TB/s; "
            f"{flops / 1e9:.2f} GFLOP / 67 TFLOP/s = {flops / F32_FLOP_PER_S * 1e3:.3f} ms; "
            f"{bound_ms / ms:.1%} of bound), plain version {plain_ms:.3f} ms, "
            f"library {fmt(lib_ms)}")
    for op, rec in per_stage.items():
        rec["bound_ms"], rec["bound_by"] = _bound(rec["bytes"], rec["flops"])
        log(f"per step, {op} over 14 leaves x 4 nodes: kernel {rec['ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} ({rec['bytes'] / 1e9:.2f} GB, "
            f"{rec['flops'] / 1e9:.2f} GFLOP), plain version {rec['plain_ms']:.3f} ms, "
            f"library {fmt(rec['library_ms'])}, max |kernel - plain| {rec['err']:.3g}")
    total = {k: sum(r[k] for r in per_stage.values())
             for k in ("ms", "plain_ms", "bytes", "flops")}
    bound_ms, by = _bound(total["bytes"], total["flops"])
    log(f"per step, update tail (28 launches): kernel {total['ms']:.3f} ms, bound "
        f"{bound_ms:.3f} ms by {by}, plain version {total['plain_ms']:.3f} ms")
    return per_stage


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of bytes over the
    memory rate and f32 operations over the f32 peak, and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ---------------------------------------------------------------------------
# Serving: the flash-attention CUDA kernel and the engine (phases 6-9)
# ---------------------------------------------------------------------------


def _fa_inputs(torch, b, sq, sk, h, hkv, hd, dtype, gen):
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, sk, hkv, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, sk, hkv, hd, device="cuda", generator=gen).to(dtype)
    return q, k, v


def _fa_compare(torch, q, k, v, causal, window, what):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch
    from repro_torch.kernels.flash_attention.ref import reference_attention

    got = flash_attention_launch(q, k, v, causal=causal, window=window)
    want = reference_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = FA_TOL[str(q.dtype).split(".")[-1]]
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:  # also catches NaN
        raise RuntimeError(f"flash_attention kernel != plain version ({what}): max |diff| "
                           f"{err:.3g} > {tol}")
    return err


def _fa_live_pairs(b, sq, sk, h, causal, window) -> int:
    """Live (q, k) pairs of the mask, counted row by row."""
    import numpy as np

    i = np.arange(sq)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum()) * b * h


def _fa_bound(q, k, causal, window):
    """(bound ms, bound_by, flops, bytes) for one call: each of q, k, v read
    once and o written once; 4 * hd f32 operations per live pair."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 4 * hd * _fa_live_pairs(b, sq, sk, h, causal, window)
    nbytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)
    return (*_bound(nbytes, flops), flops, nbytes)


def phase_flash_vs_plain(torch, built):
    import itertools

    so, build_s = built
    log(f"phase 6: flash_attention CUDA kernel built by nvcc in {build_s:.1f}s ({so.name}); "
        "ptxas: " + "; ".join(_ptxas_summary(so)))
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    t0 = time.perf_counter()
    lengths = (1, 77, 300)
    for causal, window, group, hd, sq, sk, dt in itertools.product(
            (True, False), (0, 100), (1, 2, 4), (64, 80, 128), lengths, lengths,
            (torch.float32, torch.bfloat16)):
        q, k, v = _fa_inputs(torch, 2, sq, sk, 2 * group, 2, hd, dt, gen)
        err = _fa_compare(torch, q, k, v, causal, window,
                          f"causal={causal} window={window} group={group} hd={hd} "
                          f"Sq={sq} Sk={sk} {dt}")
        key = str(dt).split(".")[-1]
        worst[key] = max(worst[key], err)
        n += 1
    main_err = {}
    for name, (b, s_, h, hkv, hd, window) in FA_MAIN_SHAPES.items():
        q, k, v = _fa_inputs(torch, b, s_, s_, h, hkv, hd, torch.float32, gen)
        main_err[name] = _fa_compare(torch, q, k, v, True, window, name)
        del q, k, v
        torch.cuda.empty_cache()
    log(f"phase 6: flash_attention kernel == plain version on {n} cases (causal x window "
        f"{{0, 100}} x group {{1, 2, 4}} x hd {{64, 80, 128}} x Sq, Sk in {lengths} x "
        f"{{f32, bf16}}; worst max |diff| f32 {worst['float32']:.3g} (tol "
        f"{FA_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol {FA_TOL['bfloat16']})) and "
        f"at the main-path shapes {', '.join(f'{k} {v:.3g}' for k, v in main_err.items())} "
        f"in {time.perf_counter() - t0:.1f}s")


def _ptxas_summary(so):
    """Registers and spills per kernel from the build's ``-Xptxas -v`` log."""
    out, name = [], None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            sig = line.split("'")[1]
            name = sig[sig.find("flash_fwd_kernel"):].split("EEEv")[0]
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and name and not line.strip().startswith("0 bytes stack"):
            out.append(f"{name}: {line.strip()}")
    return out


def _serve_requests(vocab):
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1, SERVE["requests"])
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=SERVE["max_new"]) for i, n in enumerate(lens)]


def _engine(torch, cfg, impl, params):
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, slots=SERVE["slots"], max_prompt=SERVE["max_prompt"],
                       max_new=SERVE["max_new"], params=params,
                       runtime=RuntimeConfig(dtype="float32", attn_impl=impl))


def _timed(torch, fn, times):
    """``fn`` with each call's wall time (synchronized) appended to ``times``."""
    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    return run


def _serve_profile(torch, events, what, wall_ms, steps):
    """Device busy share and time by class of ``steps`` serve calls."""
    kernels, busy = _device_kernels(torch, events)
    if busy > wall_ms:
        raise RuntimeError(f"{what}: device time {busy:.1f} ms exceeds the wall {wall_ms:.1f}")
    classes: dict[str, float] = {}
    for name, (_, ms) in kernels.items():
        classes[_kernel_class(name)] = classes.get(_kernel_class(name), 0.0) + ms
    launches = sum(v[0] for v in kernels.values())
    log(f"profile, {what} at full width: {wall_ms / steps:.1f} ms wall per call under the "
        f"profiler, device busy {busy / steps:.1f} ms ({busy / wall_ms:.1%}, idle "
        f"{1 - busy / wall_ms:.1%}), {launches // steps} kernel launches per call")
    for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"  {c}: {ms / steps:.2f} ms ({ms / busy:.1%} of device time)")
    for name, (cnt, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {ms / steps:8.2f} ms  {cnt // steps:5d} launches  {name[:90]}")


def phase_serve_main_path(torch):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_launch,
        reset_launches,
    )
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE["arch"])
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = _engine(torch, cfg, "cuda", params)
    prefill, decode = eng.prefill_step, eng.decode_step
    prefill_s, decode_s = [], []
    eng.prefill_step = _timed(torch, prefill, prefill_s)
    eng.decode_step = _timed(torch, decode, decode_s)
    reqs = _serve_requests(cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_launch.launches
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    if sorted(c.rid for c in done) != list(range(len(reqs))):
        raise RuntimeError(f"serve: {len(done)} of {len(reqs)} requests completed")
    if any(len(c.tokens) != SERVE["max_new"] for c in done):
        raise RuntimeError("serve: a completion has the wrong length")
    if launches != cfg.n_layers * st["prefills"]:
        raise RuntimeError(f"flash_attention launched {launches} times, want "
                           f"{cfg.n_layers} x {st['prefills']} prefills")
    gen_tokens = sum(len(c.tokens) for c in done)
    prompt_tokens = sum(r.tokens.size for r in reqs)
    n_params = T.count_params(params)
    log(f"phase 7: serve qwen3-0.6b full width ({n_params:,} params, {cfg.n_layers} layers, "
        f"f32), {SERVE['slots']} slots x max_prompt {SERVE['max_prompt']} + max_new "
        f"{SERVE['max_new']}: {len(done)}/{len(reqs)} requests complete ({prompt_tokens} "
        f"prompt tokens, {gen_tokens} generated), {st['prefills']} prefill waves, "
        f"{st['decode_batches']} decode steps; flash_attention launches {launches} "
        f"(= {cfg.n_layers} x {st['prefills']})")
    dec_ms = 1e3 * sum(decode_s) / len(decode_s)
    log(f"serve main path: prefill {[round(1e3 * t, 1) for t in prefill_s]} ms per wave "
        f"({SERVE['slots']} x {SERVE['max_prompt']} tokens each), decode {dec_ms:.2f} ms per "
        f"step (mean of {len(decode_s)}; min {1e3 * min(decode_s):.2f}, max "
        f"{1e3 * max(decode_s):.2f}), {gen_tokens / wall:.1f} generated tokens/s over the "
        f"{wall:.2f}s run, peak memory {peak / 2**30:.2f} GiB")

    # where the device time of one prefill wave and of two decode steps goes
    # (after the counts are read)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE["slots"], SERVE["max_prompt"]),
                                     device="cuda", generator=torch.Generator(device="cuda")
                                     .manual_seed(3))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, cache = prefill(params, batch)
        torch.cuda.synchronize()
        wave_ms = 1e3 * (time.perf_counter() - t)
    _serve_profile(torch, prof.events(), "one prefill wave", wave_ms, 1)
    tok = batch["tokens"][:, -1:]
    tvec = torch.full((SERVE["slots"],), SERVE["max_prompt"] - 1, dtype=torch.int32)
    decode(params, tok, cache, tvec)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            decode(params, tok, cache, tvec)
        torch.cuda.synchronize()
        steps_ms = 1e3 * (time.perf_counter() - t)
    _serve_profile(torch, prof.events(), "two decode steps", steps_ms, 2)
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


def phase_serve_kernel_vs_plain(torch):
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    depth = 4
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=depth)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    reqs = _serve_requests(cfg.vocab_size)
    out, wall = {}, {}
    for impl in ("cuda", "torch"):
        eng = _engine(torch, cfg, impl, params)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        out[impl] = {c.rid: c.tokens for c in eng.run_until_drained()}
        wall[impl] = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
    parted = []
    for r in reqs:
        a, b = out["cuda"][r.rid], out["torch"][r.rid]
        if (a == b).all():
            continue
        pos = int((a != b).argmax())
        # the plain run's logits at that position: a prefill of the prompt
        # and the plain run's tokens before it
        seq = np.concatenate([r.tokens, b[:pos]])[None]
        with torch.inference_mode():
            logits, _ = T.prefill(params, {"tokens": torch.from_numpy(seq).cuda()}, cfg,
                                  T.RuntimeConfig(dtype="float32", attn_impl="torch"))
        top2 = torch.topk(logits[0].float(), 2).values
        gap = float(top2[0] - top2[1]) / float(logits.abs().max())
        log(f"  request {r.rid}: tokens part at generated position {pos} ({a[pos]} kernel vs "
            f"{b[pos]} plain); plain top-two logit gap {gap:.3g} of max |logit|")
        parted.append(gap)
        if not gap < LOGIT_RTOL:
            raise RuntimeError(f"request {r.rid}: kernel and plain paths part at position "
                               f"{pos} where the plain top-two gap {gap:.3g} is not a near tie "
                               f"(< {LOGIT_RTOL})")
    log(f"phase 8: serve at {depth} layers, {len(reqs)} requests: kernel path == plain path "
        f"token for token on {len(reqs) - len(parted)} of {len(reqs)} requests"
        + (f", the other {len(parted)} part at near ties" if parted else "")
        + f"; run {wall['cuda']:.2f}s kernel vs {wall['torch']:.2f}s plain")
    del params
    torch.cuda.empty_cache()


def phase_flash_timing(torch):
    """The kernel at the serve main path's prefill shape (and at
    h2o-danube's windowed shape): its time, bound, plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch
    from repro_torch.kernels.flash_attention.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    rec = None
    for name, (b, s_, h, hkv, hd, window) in FA_MAIN_SHAPES.items():
        q, k, v = _fa_inputs(torch, b, s_, s_, h, hkv, hd, torch.float32, gen)
        want = reference_attention(q, k, v, causal=True, window=window)
        got = flash_attention_launch(q, k, v, causal=True, window=window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window:  # SDPA takes the window as a boolean mask
            i = torch.arange(s_, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True)
        lib_out = lib().transpose(1, 2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lib_err = float((lib_out - want).abs().max())
        if not (err <= FA_TOL["float32"] and lib_err <= FA_TOL["float32"]):
            raise RuntimeError(f"{name}: kernel {err:.3g} / SDPA {lib_err:.3g} from the plain "
                               f"version (tol {FA_TOL['float32']})")
        del got, want, lib_out
        ms = _time_ms(torch, lambda: flash_attention_launch(q, k, v, causal=True,
                                                            window=window), 10)
        plain_ms = _time_ms(torch, lambda: reference_attention(q, k, v, causal=True,
                                                               window=window), 3)
        lib_ms = _time_ms(torch, lib, 10)
        bound_ms, by, flops, nbytes = _fa_bound(q, k, True, window)
        log(f"phase 9: flash_attention at {name} {tuple(q.shape)} q, {tuple(k.shape)} k/v, "
            f"causal, window {window}, f32: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s), bound {bound_ms:.3f} ms by {by} ({flops / 1e9:.1f} GFLOP / 67 TFLOP/s; "
            f"{nbytes / 1e6:.0f} MB / 3.35 TB/s = {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms; "
            f"{bound_ms / ms:.1%} of bound), plain version {plain_ms:.3f} ms, SDPA "
            f"{lib_ms:.3f} ms; max |kernel - plain| {err:.3g}")
        if rec is None:  # the first shape is the main path's
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": by, "err": err}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "build", "triton"))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention.kernel import build

    t0 = time.perf_counter()
    phases = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(torch, *args)
        phases[name] = round(time.perf_counter() - t, 1)
        return out

    def build_timed():
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    # nvcc builds the CUDA kernel while the Triton phases run
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build_timed)
        timed("1 device", phase_device)
        timed("2 fused_update vs plain", phase_kernel_vs_plain)
        launches = timed("3 train main path", phase_main_path)
        timed("4 train kernel vs plain path", phase_plain_vs_kernel_path)
        per_stage = timed("5 fused_update timing", phase_timing)
        built = built.result()
    timed("6 flash_attention vs plain", phase_flash_vs_plain, built)
    fa_launches = timed("7 serve main path", phase_serve_main_path)
    timed("8 serve kernel vs plain path", phase_serve_kernel_vs_plain)
    fa = timed("9 flash_attention timing", phase_flash_timing)
    log(f"phase times (s): {phases}; total {time.perf_counter() - t0:.1f}s")
    # one record per specialization of the Triton kernel on the training main
    # path (times per step, summed over the 14 leaves), and the flash kernel
    # at the serve main path's prefill shape (times per call)
    records = [{
        "name": f"fused_update[{op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": launches[op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in per_stage.items()]
    records.append({
        "name": "flash_attention[causal, f32, hd 64]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": fa_launches,
        "max_abs_err": fa["err"],
        "ms": fa["ms"],
        "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
    })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
