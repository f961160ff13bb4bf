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
   bfloat16, at a ragged and at a large leaf size, and count the cases where
   the two agree bit for bit;
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
6. the CUDA ``flash_attention`` kernel: per specialization, its registers,
   shared memory and spills (ptxas; a spill fails the phase) and its count of
   tensor-core instructions (HMMA, from ``cuobjdump -sass``); then against
   its plain version on the card: causal x window {0, 100} x GQA group
   {1, 2, 4} x hd {64, 80, 128} x ragged Sq, Sk in {1, 77, 300} x {f32,
   bf16}, the same for hymba's 25/5 heads at hd 64 (a GQA group of 5) and
   olmo-1b's 16/16 at hd 128, and the three main-path shapes (qwen3-0.6b
   prefill, h2o-danube-1.8b with its 4096 window, hymba-1.5b prefill with
   its 1024 window);
7. the serve main path: ``repro_torch.serve.ServeEngine`` on qwen3-0.6b at
   full width (28 layers, f32, random weights from seed 0), 8 slots,
   ``max_prompt`` 2048, ``max_new`` 32, 16 requests of 256..2048 prompt
   tokens: all complete and the kernel launched exactly 28 times per
   prefill; prefill ms per wave, decode ms per step, generated tokens/s,
   peak memory, and where the device time of one prefill wave and of two
   decode steps goes;
8. the same engine at 4 layers with ``attn_impl="cuda"`` (exactly 4
   launches per wave) and ``"torch"``: token-identical, or, where they part,
   the plain run's top-two logit gap there (read by the engine's
   ``on_logits`` hook) is below the logit tolerance (a near tie);
9. the flash kernel at the main-path shapes timed beside its bound (the
   larger of bytes / 3.35 TB/s and 3 x flops / 494.7 TFLOP/s: its products
   are 3xTF32 on the tensor cores), the f32 FFMA bound of the SIMT kernel it
   replaced (flops / 67 TFLOP/s), its plain version and
   ``scaled_dot_product_attention``;
10. the CUDA ``mlstm_chunk`` kernel's three passes (gate scan, chunk states,
    outputs): the build report of phase 6; then against its plain version on
    the card:
    (B, H) in {(1, 1), (2, 3), (8, 4)} x S in {64, 128, 512, 2048} x chunk
    {64, 128} x (dk, dv) in {(16, 16), (32, 48), (64, 64), (512, 512)} x
    {f32, bf16} x three gate regimes (the reference test's; strongly
    negative forget with large input gates, with q, k >= 0 and with signed
    q, k: there the plain version sums the prefix sums of log f in the
    kernel's order, and h's error against a float64 run is printed for the
    kernel and for three f32 orders) x two layouts (contiguous, and the
    strided views the mLSTM block passes), h, C, n and m compared, and the
    gate scan's terms and the carried C and n at every chunk boundary held
    against their plain versions (``mlstm_chunk_gates``,
    ``mlstm_chunk_states``), so that a failure names the pass at fault; and
    the main-path shape in both layouts;
11. the xlstm-350m serve main path: ``ServeEngine`` at full width (24
    layers: 20 mLSTM, 4 sLSTM; f32, random weights from seed 0), 8 slots,
    ``max_prompt`` 2048, ``max_new`` 32, the 16 requests of phase 7 with
    ``mlstm_impl="cuda"``: all complete and the kernel launched exactly 20
    times per prefill wave; prefill ms per wave, decode ms per step,
    generated tokens/s, peak memory, and where the device time of one
    prefill wave and of two decode steps goes (the sLSTM recurrence's share
    from its profiler span, the mLSTM kernel's time by pass);
12. the same engine at 6 layers (5 mLSTM, 1 sLSTM) with ``mlstm_impl``
    "cuda" and "torch": token-identical, or parting only where the plain
    run's own top-two logit gap is below the logit tolerance;
13. the mLSTM kernel at the main-path shape timed beside its bounds (as in
    phase 9, with the causal triangle's flops), the memory one call
    allocates, and its plain version (no single PyTorch call computes
    chunked mLSTM);
14. the stage kernel's plane launch (one launch per bucket, gs per node and
    the LARS ratio per plane row) against its plain version at phase 2's
    tolerances, for every op x {plain, lars + clip + coupled wd (with sg
    per node too)}, on a small stacked plane (x in f32 and bf16) and on
    qwen3-0.6b's full (4, 648000, 1024) plane; and against the per-leaf
    launches on the same inputs, bit for bit on every segment's true
    elements (a leaf that differs in any bit is printed and fails);
15. the flat-plane training main path: phase 3's run with ``--flat-planes``
    (2 stage launches per step instead of 28), profiled; the plane stages
    timed at the full plane beside their bound, plain version and library
    call; step time, device busy, peak memory beside phase 3's; at 4 layers,
    3 steps, losses equal to the per-leaf kernel path's to 1e-6 relative;
    one pmsgd-lars + grad_clip plane step held against the plain plane path;
16. serving while training: phase 15's trainer with
    ``--serve-while-training``, 8 steps, node 0 publishing every 2 steps, the
    engine on ``attn_impl="cuda"``: every offer ships, each snapshot equals
    node 0's parameter plane byte for byte, swaps only between decode
    batches, every request completes, and the requests admitted after the
    last swap get a fresh engine's tokens on that snapshot; the host-to-device
    copy of each swap;
17. the staleness main path: phase 15's run with ``--algorithm decentlam-sa
    --gossip-delay 1 --track-consensus``: 2 launches per step, gossip_gap 0
    then 1, every decentlam_sa_post launch with the per-node sg column
    (``SG_COL``) holding max(0.5**gap, 0); step time, device busy,
    consensus_sq, peak memory; one gossip round on the full plane timed
    alone (undelayed, delay 1, int8-row-ef and its encode/decode), and
    decentlam_sa_post at the full plane beside its bound and plain version;
18. compressed gossip: phase 15's run with ``--compression int8-row-ef``:
    finite losses, the egress telemetry equal to the f32 sum of wire_bytes
    per round, step time, device busy, peak memory;
19. at 4 layers, 3 steps: the kernel path against the plain path for nine
    delay / compression / decentlam-sa / da-dmsgd / grad-accum / bf16
    configurations, then three claims bit for bit on the final parameters
    and optimizer state: --gossip-delay 0 == no delay, decentlam-sa at gap 0
    == decentlam, flat planes == per leaf at delay 1;
20. checkpoint and resume at full width, 2 layers, 2 nodes, delay 1 and
    int8-row-ef on planes: a resumed run == an unbroken one bit for bit,
    channel state included; the same checkpoint resumed without
    ``--flat-planes`` equals the saved planes unpacked and trains on; GB,
    save and restore seconds (under ``build/ckpt_smoke``, removed after);
21. one process per node: phase 15's run with ``--simulate-nodes 4
    --gossip-impl ppermute``, 4 ranks sharing the card over gloo (every
    message staged through pinned host memory), 3 steps: finite losses,
    exactly 2 stage launches per rank and step (the plane stage at a node
    axis of 1), the step-0 loss equal to phase 15's to 1e-5 relative; the
    backend, step time, gossip seconds per round, staged GB/s, each rank's
    peak memory and the card's; the plane stages at one rank's (1, 648000,
    1024) beside phase 15's tail;
22. at 4 layers, 2 steps, in one spawned group of 4 ranks: the distributed
    step against the stacked step for ppermute, allgather, decentlam-sa at
    delay 1, pmsgd (the psum mean), da-dmsgd and bf16 messages (the
    reference's distributed-vs-oracle tolerances), int8-row-ef and top-k
    (finite, egress telemetry), then bit for bit on every rank: planes ==
    per leaf, ``--fused-impl triton`` == ``torch``, delay 0 == undelayed
    for every algorithm;
23. checkpoint, resume and the drill at full width, 2 layers, decentlam-sa
    at delay 1 on planes: on 2 ranks a resumed run == an unbroken one bit
    for bit on every rank, the ring included; GB, save and restore seconds;
    on 4 ranks ``--failure-drill`` 4 -> 2 with finite losses, the survivors' state ==
    ``elastic_reshape`` of the gathered state bit for bit (files under
    ``build/dist_smoke``, removed after).  Every spawned group has a
    deadline: a hung rank fails the phase;
24. the MoE training main path: one MoE layer's forward and backward with
    CUDA's sync debug mode at "error" (no host sync); granite-moe-1b-a400m
    at full width (32 experts, top-8) cut to 12 of its 24 layers, 4 stacked
    nodes, decentlam
    on flat planes through the stage kernel, profiled as phase 3: finite
    losses and router terms, exactly 2 stage launches per step; step time,
    device busy, peak memory beside its reckoning, the forward's device time
    in the router, dispatch, expert and combine spans, the plane stages at
    its plane beside their bound; at 4 layers, 3 steps: the kernel and its
    plain version, and two kernel runs, equal bit for bit (losses, router
    terms, final parameter and momentum planes: the combine is
    deterministic);
25. the hybrid serving main path: hymba-1.5b at full width and depth (32
    layers, window 1024 on 29, full attention on layers 0, 16, 31; parallel
    attention and SSM heads) behind the engine with the flash kernel, the 16
    requests of phase 7: all complete, exactly 32 launches per prefill wave;
    prefill, decode, tokens/s, peak memory, the SSM branch's share of the
    device time; at 4 layers the kernel path against the plain path as in
    phase 8;
26. the rest of the zoo at full width cut to 4 layers: 3 training steps on
    planes through the stage kernel (4 stacked nodes, 2 launches per step,
    finite losses) for olmo-1b, internvl2-2b, granite-moe-3b-a800m and
    xlstm-350m; qwen3-8b serving with the flash kernel at hd 128 against
    the plain path as in phase 8.

The line before the last is the per-kernel JSON record (the stage kernel on
the per-leaf, plane, staleness and MoE paths; flash on the qwen3-0.6b and
hymba-1.5b serve paths; mLSTM on xlstm-350m's); the last line is
``{"ok": true, "device": {...}}``.  Triton kernels compile at first use into
``build/triton`` inside the checkout; the two CUDA kernels are built by nvcc
into ``build/cuda``, one nvcc each, both started at once while phases 2-5
run.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (same sheet)
# H100 SXM dense tensor-core rates (same sheet): TF32, and bf16 with f32
# accumulation.  The flash and mLSTM kernels take an f32 product as three
# TF32 products (3xTF32); a bf16 product, exact in TF32, as one, though the
# card could take it at the bf16 rate, which therefore bounds it
TF32_FLOP_PER_S = 494.7e12
BF16_FLOP_PER_S = 989e12
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
# the qwen3-0.6b prefill wave of the serve main path, h2o-danube-1.8b (hd 80)
# at a length where its 4096 window cuts in, and the hymba-1.5b prefill wave of
# phase 25 (a GQA group of 5) on its 29 sliding-window layers
FA_MAIN_SHAPES = {"qwen3-0.6b prefill": (8, 2048, 16, 8, 64, 0),
                  "h2o-danube-1.8b": (1, 4608, 32, 8, 80, 4096),
                  "hymba-1.5b prefill": (8, 2048, 25, 5, 64, 1024)}
# the head layouts of this slice's models beyond phase 6's product, (H, Hkv,
# hd): hymba's GQA group of 5 and olmo-1b's MHA at hd 128
FA_ZOO_HEADS = ((25, 5, 64), (16, 16, 128))
# flash attention, kernel vs plain version: the JAX package's tolerances for
# its own kernel (tests/test_kernels.py)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the serve main path: qwen3-0.6b, 8 slots, 16 requests in two admission waves
SERVE = dict(arch="qwen3-0.6b", slots=8, max_prompt=2048, max_new=32, requests=16,
             min_prompt=256)
# kernel path vs plain path: where the generated tokens part, the plain
# run's top-two logit gap there must be below this share of max |logit|
LOGIT_RTOL = 1e-4
# the xlstm-350m serve main path: the requests of SERVE on another model
XSERVE_ARCH = "xlstm-350m"
# mlstm_chunk, kernel vs plain version: the JAX package's mLSTM tolerance
# (tests/test_kernels.py) in f32, 2e-2 in bf16 (one bf16 rounding of h), each
# of the output's largest |value| where that exceeds 1 (at dk 512 h reaches
# tens, and both versions sum 512-term dot products in f32 in other orders)
ML_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the mLSTM main-path shape: one prefill wave of 8 slots x 4 heads, 2048
# tokens, head dim 512, chunk 128
ML_MAIN = dict(B=8, H=4, S=2048, dk=512, dv=512, chunk=128)


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
    worst, bitwise, cases = 0.0, 0, 0
    t0 = time.perf_counter()
    for (kind, op, ctx) in stages:
        for x_dtype in (torch.float32, torch.bfloat16):
            for numel in sizes.values():
                ins, out_dtypes = _stage_inputs(torch, kind, op, ctx, numel, x_dtype, gen)
                want = stage_plain(kind, op, ctx, svec, ins, out_dtypes)
                got = {n: torch.empty_like(w) for n, w in want.items()}
                fused_stage_launch(kind, op, ctx, svec, ins, got)
                torch.cuda.synchronize()
                cases += 1
                bitwise += all(_same_bits(torch, got[n], want[n]) for n in want)
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
        f"{worst:.3g}) in {time.perf_counter() - t0:.1f}s; kernel == plain bit for bit on "
        f"{bitwise} of {cases} cases")


def _train_argv(steps, impl, depth=0, arch=MAIN["arch"]):
    argv = ["--nodes", str(MAIN["nodes"]), "--arch", arch, "--steps", str(steps),
            "--seq-len", str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
            "--algorithm", "decentlam", "--topology", "exp", "--fused-update",
            "--fused-impl", impl, "--log-every", "1"]
    return argv + (["--depth", str(depth)] if depth else [])


def _profiled_train(torch, extra=(), watch=None, arch=MAIN["arch"], depth=0):
    """``train.main`` on the main path (with the ``extra`` flags; ``arch`` cut
    to ``depth`` layers where given), profiled: MAIN["steps"] + 3 steps;
    steps 1..MAIN["steps"]-1 run unprofiled (the step time), the profiler
    warms up on the next one and records the last two (where the device
    time goes).  ``watch(step, state, metrics)``, if given, sees every step.
    Returns ``(result, launches by op, total launches, profiler events,
    unprofiled step ms)``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train

    steps, timed = MAIN["steps"] + 3, slice(1, MAIN["steps"])
    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=MAIN["steps"], warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        reset_launches()
        def on_step(*args):
            if watch is not None:
                watch(*args)
            prof.step()

        res = train.main(_train_argv(steps, "triton", depth, arch) + list(extra),
                         on_step=on_step)
        launches = dict(fused_stage_launch.launches_by_op)
        total = fused_stage_launch.launches
    if len(traced) != 1:
        raise RuntimeError(f"the profiler delivered {len(traced)} traces, want 1")
    step_ms = 1e3 * sum(res["step_times_s"][timed]) / len(res["step_times_s"][timed])
    return res, launches, total, traced[0], step_ms


def phase_main_path(torch):
    """The main path, profiled (see :func:`_profiled_train`)."""
    import math

    res, launches, total, events, step_ms = _profiled_train(torch)
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the main path: {res['losses']}")
    if total != 28 * steps or launches != {op: 14 * steps for op in STAGE_FLOPS}:
        raise RuntimeError(f"fused_update launched {total} times ({launches}), "
                           f"want 28 x {steps}: 14 x {steps} of each of {list(STAGE_FLOPS)}")
    log(f"phase 3: qwen3-0.6b full width ({res['params_per_node']:,} params/node, "
        f"{res['n_layers']} layers) x {res['n_nodes']} nodes, {steps} steps: "
        f"losses {[round(v, 4) for v in res['losses']]}, fused_update launches {total} "
        f"(= 28 x {steps}: {launches})")
    tokens = MAIN["nodes"] * MAIN["per_node_batch"] * MAIN["seq_len"]
    log(f"main path: step {step_ms:.1f} ms (mean of the unprofiled steps "
        f"1..{MAIN['steps'] - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, events, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
    torch.cuda.empty_cache()
    return {"launches": launches, "peak": res["peak_mem_bytes"], "step_ms": step_ms,
            "busy_ms": prof["busy_ms"], "kernels": prof["kernels"]}


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
    if any(k in n for k in ("mlstm_gate_scan", "mlstm_states", "mlstm_outputs")):
        return "mlstm_chunk (CUDA)"
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


# profiler ranges that also appear on the device timeline as annotations
# (the scheduled profiler's steps, the port's named spans); not device work
ANNOTATIONS = ("ProfilerStep", "slstm_recurrence", "moe_", "ssm_forward")


def _device_kernels(torch, events):
    """``({kernel name: [launches, ms]}, busy ms)`` from a profiler's events."""
    kernels: dict[str, list] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(
                ANNOTATIONS):
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return kernels, busy


def _profile_report(torch, events, step_ms, profiled_ms, flops=None):
    """Where a main-path step's device time goes, from the profiler's events
    over 2 steps, against the unprofiled step time ``step_ms``; ``flops`` is
    the step's matmul work (default: the qwen3-0.6b main path's)."""
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
    if flops is None:
        flops = _matmul_flops_per_step(get_config(MAIN["arch"]), MAIN["nodes"])
    gemm_ms = classes.get("matmul (cuBLAS)", 0.0) / steps
    log(f"  matmul work {flops / 1e12:.2f} TFLOP/step (fwd + bwd, from the shapes) in "
        f"{gemm_ms:.1f} ms: {flops / gemm_ms / 1e9:.1f} TFLOP/s of the 67 f32 peak")
    for name, (cnt, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {ms / steps:8.2f} ms/step  {cnt // steps:5d} launches/step  {name[:90]}")
    return {"busy_ms": busy_ms, "classes": {c: ms / steps for c, ms in classes.items()},
            "kernels": {k: (n / steps, ms / steps) for k, (n, ms) in kernels.items()}}


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


def _tc_bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """The least time (ms) of a kernel whose products run on the tensor
    cores: the larger of bytes over the memory rate and, for f32 inputs,
    3 x flops over the dense TF32 rate (3xTF32), for bf16 inputs flops over
    the bf16 rate; and which one it is."""
    import torch

    rate = TF32_FLOP_PER_S / 3 if dtype == torch.float32 else BF16_FLOP_PER_S
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
    """The work of one call and its bounds: each of q, k, v read once and o
    written once; 4 * hd operations per live pair.  "tc" is the tensor-core
    bound the kernel is held to (3xTF32 in f32), "ffma" the f32 FFMA bound of
    the SIMT kernel it replaced."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 4 * hd * _fa_live_pairs(b, sq, sk, h, causal, window)
    nbytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)
    return {"flops": flops, "bytes": nbytes, "tc": _tc_bound(nbytes, flops, q.dtype),
            "ffma": _bound(nbytes, flops)}


def phase_flash_vs_plain(torch, built):
    import itertools

    _report_build(6, "flash_attention", built, ("flash_fwd_kernel",))
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
    for (h, hkv, hd), causal, window, sq, sk, dt in itertools.product(
            FA_ZOO_HEADS, (True, False), (0, 100), lengths, lengths,
            (torch.float32, torch.bfloat16)):
        q, k, v = _fa_inputs(torch, 2, sq, sk, h, hkv, hd, dt, gen)
        err = _fa_compare(torch, q, k, v, causal, window,
                          f"causal={causal} window={window} H={h} Hkv={hkv} hd={hd} "
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
        f"{{f32, bf16}}, and the same for (H, Hkv, hd) in {FA_ZOO_HEADS}; worst max |diff| f32 {worst['float32']:.3g} (tol "
        f"{FA_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol {FA_TOL['bfloat16']})) and "
        f"at the main-path shapes {', '.join(f'{k} {v:.3g}' for k, v in main_err.items())} "
        f"in {time.perf_counter() - t0:.1f}s")


def _kernel_label(sig, entries):
    """A readable name for a mangled kernel signature: the entry's name and
    its template arguments (element type, head dim), or None."""
    import re

    for entry in entries:
        i = sig.find(entry)
        if i < 0:
            continue
        rest = sig[i + len(entry):]
        args = ["f32" if rest.startswith("If") else "bf16" if rest.startswith("I13__nv_bfloat16")
                else ""]
        hd = re.match(r"I(?:f|13__nv_bfloat16)Li(\d+)E", rest)
        args.append(hd.group(1) if hd else "")
        args = [a for a in args if a]
        return entry + (f"[{', '.join(args)}]" if args else "")
    return None


def _report_build(phase, what, built, entries):
    """Log, per kernel of the built library, its registers, shared memory
    and spills from the build's ``-Xptxas -v`` log and its count of
    tensor-core instructions (HMMA, HGMMA) in its SASS (``cuobjdump -sass``),
    which shows that it runs on the tensor cores; fail where ptxas spilled."""
    from repro_torch.kernels import cuda_build

    so, build_s = built
    rows, name = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = _kernel_label(line.split("'")[1], entries)
            if name:
                rows[name] = {}
        elif name and "spill stores" in line:
            parts = [x.strip() for x in line.split(",")]
            rows[name]["spill"] = "/".join(x.split()[0] for x in parts if "spill" in x) + " B"
        elif name and line.startswith("ptxas info") and "Used" in line:
            rows[name]["used"] = line.split("Used", 1)[1].strip()
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    for sec in sass.split("Function : ")[1:]:
        name = _kernel_label(sec.split("\n", 1)[0].strip(), entries)
        if name in rows:
            rows[name]["hmma"] = sum(("HMMA" in ln or "HGMMA" in ln) for ln in sec.splitlines())
    log(f"phase {phase}: {what} CUDA kernels built by nvcc in {build_s:.1f}s ({so.name}):")
    for n, r in rows.items():
        log(f"  {n}: {r.get('used', '?')}, spill stores/loads {r.get('spill', '?')}, "
            f"{r.get('hmma', 0)} HMMA")
    spilled = [n for n, r in rows.items() if r.get("spill", "0/0 B") != "0/0 B"]
    if spilled:
        raise RuntimeError(f"{what}: ptxas spilled registers in {spilled}")


def _serve_requests(vocab):
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1, SERVE["requests"])
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=SERVE["max_new"]) for i, n in enumerate(lens)]


def _engine(torch, cfg, params, on_logits=None, **runtime):
    """The engine of the serve phases over ``params``, f32, with the runtime
    options ``runtime`` (the kernel or the plain path)."""
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, slots=SERVE["slots"], max_prompt=SERVE["max_prompt"],
                       max_new=SERVE["max_new"], params=params, on_logits=on_logits,
                       runtime=RuntimeConfig(dtype="float32", **runtime))


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


def _serve_main_path(torch, cfg, phase, launch, reset, per_wave, profile_extra=None,
                     decode_extra=None, **runtime):
    """A serve main path: ``cfg`` at full width (f32, random weights from
    seed 0) behind the engine with ``runtime``, the 16 requests of SERVE.
    Checks that all complete and that the kernel wrapper ``launch`` (its
    count set to 0 by ``reset``) launched exactly ``per_wave`` times per
    prefill wave; prints prefill ms per wave, decode ms per step, generated
    tokens/s and peak memory; then profiles one prefill wave
    (``profile_extra(events)`` adds to its report) and two decode steps
    (``decode_extra(events)`` likewise).  Returns the kernel's launches in
    the engine run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = _engine(torch, cfg, params, **runtime)
    prefill, decode = eng.prefill_step, eng.decode_step
    prefill_s, decode_s = [], []
    eng.prefill_step = _timed(torch, prefill, prefill_s)
    eng.decode_step = _timed(torch, decode, decode_s)
    reqs = _serve_requests(cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    reset()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch.launches
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    if sorted(c.rid for c in done) != list(range(len(reqs))):
        raise RuntimeError(f"{cfg.name} serve: {len(done)} of {len(reqs)} requests completed")
    if any(len(c.tokens) != SERVE["max_new"] for c in done):
        raise RuntimeError(f"{cfg.name} serve: a completion has the wrong length")
    if launches != per_wave * st["prefills"]:
        raise RuntimeError(f"{launch.__name__} launched {launches} times, want {per_wave} x "
                           f"{st['prefills']} prefills")
    gen_tokens = sum(len(c.tokens) for c in done)
    prompt_tokens = sum(r.tokens.size for r in reqs)
    counts = {}
    for g in T.block_groups(cfg):
        counts[g.kind] = counts.get(g.kind, 0) + g.count
    kinds = ", ".join(f"{n} {k}" for k, n in counts.items())
    log(f"phase {phase}: serve {cfg.name} full width ({T.count_params(params):,} params, "
        f"{cfg.n_layers} layers: {kinds}; f32), {SERVE['slots']} slots x max_prompt "
        f"{SERVE['max_prompt']} + max_new {SERVE['max_new']}: {len(done)}/{len(reqs)} requests "
        f"complete ({prompt_tokens} prompt tokens, {gen_tokens} generated), {st['prefills']} "
        f"prefill waves, {st['decode_batches']} decode steps; {launch.__name__} launches "
        f"{launches} (= {per_wave} x {st['prefills']})")
    dec_ms = 1e3 * sum(decode_s) / len(decode_s)
    log(f"{cfg.name} serve main path: prefill {[round(1e3 * t, 1) for t in prefill_s]} ms per "
        f"wave ({SERVE['slots']} x {SERVE['max_prompt']} tokens each), decode {dec_ms:.2f} ms "
        f"per step (mean of {len(decode_s)}; min {1e3 * min(decode_s):.2f}, max "
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
    events = prof.events()
    _serve_profile(torch, events, f"one {cfg.name} prefill wave", wave_ms, 1)
    if profile_extra is not None:
        profile_extra(events)
    del events, prof
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
    _serve_profile(torch, prof.events(), f"two {cfg.name} decode steps", steps_ms, 2)
    if decode_extra is not None:
        decode_extra(prof.events())
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


def phase_serve_main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches

    cfg = get_config(SERVE["arch"])
    return _serve_main_path(torch, cfg, 7, flash_attention_launch, reset_launches, cfg.n_layers,
                            attn_impl="cuda")


def phase_serve_kernel_vs_plain(torch):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches

    depth = 4
    _serve_kernel_vs_plain(torch, 8, SERVE["arch"], depth, "attn_impl", flash_attention_launch,
                           reset_launches, depth, f"{depth} layers")


def phase_flash_timing(torch):
    """The kernel at the serve main paths' prefill shapes (and at
    h2o-danube's windowed shape): its time, bound, plain version and SDPA.
    Returns a record per shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch
    from repro_torch.kernels.flash_attention.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    recs = {}
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
        bd = _fa_bound(q, k, True, window)
        (bound_ms, by), (ffma_ms, _) = bd["tc"], bd["ffma"]
        flops, nbytes = bd["flops"], bd["bytes"]
        log(f"phase 9: flash_attention at {name} {tuple(q.shape)} q, {tuple(k.shape)} k/v, "
            f"causal, window {window}, f32 ({smi}): kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s); tensor-core bound {bound_ms:.3f} ms by {by} (3 x {flops / 1e9:.1f} GFLOP "
            f"/ 494.7 TFLOP/s TF32; {nbytes / 1e6:.0f} MB / 3.35 TB/s = "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms): {bound_ms / ms:.1%} of it; the f32 FFMA "
            f"bound of the SIMT design {ffma_ms:.3f} ms (/ 67 TFLOP/s), the kernel at "
            f"{ms / ffma_ms:.2f}x it; plain version "
            f"{plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms; max |kernel - plain| {err:.3g}")
        recs[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": by, "err": err}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# xlstm-350m serving: the mlstm_chunk CUDA kernel and the engine (10-13)
# ---------------------------------------------------------------------------


def _ml_inputs(torch, B, H, S, dk, dv, dtype, regime, gen, layout="contiguous"):
    """q, k, v (B, H, S, d) in ``dtype`` and f32 gates (B, H, S) on the card.
    "reference": the JAX package's test inputs (q, k, v ~ N(0, 1), input
    gate N(0, 1), forget gate 2 + N(0, 1)).  "stress": forget gate
    -4 + 3 N(0, 1) (fast forgetting) and input gate 6 N(0, 1) (the
    stabilizer m jumps with it), with q and k nonnegative (|N(0, 1)|), so
    that the normalizer den is a sum of nonnegative terms and h = num / den
    is well conditioned.  "signed stress": the same gates with signed q and
    k, where den may cancel toward 0 (see :func:`_ml_compare`).  ``layout`` "model": views of (B, S, H, d) and
    (B, S, H) tensors, strided as the mLSTM block hands them to the kernel
    (seq stride H*d and H)."""
    def randn(*tail):
        if layout == "model":
            return torch.randn(B, S, H, *tail, device="cuda", generator=gen).transpose(1, 2)
        return torch.randn(B, H, S, *tail, device="cuda", generator=gen)

    q, k, v = randn(dk), randn(dk), randn(dv)
    if regime == "stress":
        q, k = q.abs(), k.abs()
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    i, f = randn(), randn()
    if regime in ("stress", "signed stress"):
        i, f = 6.0 * i, -4.0 + 3.0 * f
    else:
        f = 2.0 + f
    return q, k, v, i, f


def _kernel_cumsum(x, dim=-1):
    """The prefix sums of ``x`` (..., L <= 128) along the last dim in the
    kernel's order of f32 additions: 32 lanes of 4 consecutive entries, each
    lane summing its own in order, then an inclusive Hillis-Steele scan of
    the lane totals (offsets 1, 2, ..., 16), each lane's entries offset by
    the exclusive total before it."""
    import torch

    if dim not in (-1, x.ndim - 1) or x.shape[-1] > 128:
        raise ValueError(f"the kernel's order sums a last dim of at most 128, got {dim}, "
                         f"{tuple(x.shape)}")
    L = x.shape[-1]
    pad = torch.zeros(*x.shape[:-1], 128, dtype=x.dtype, device=x.device)
    pad[..., :L] = x
    lanes = pad.reshape(*x.shape[:-1], 32, 4)
    run, part = torch.zeros_like(lanes[..., 0]), []
    for j in range(4):
        run = run + lanes[..., j]
        part.append(run)
    incl, off = run, 1
    while off < 32:
        shifted = torch.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = torch.where(torch.arange(32, device=x.device) >= off, incl + shifted, incl)
        off *= 2
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    return torch.stack([excl + p for p in part], dim=-1).reshape(*x.shape[:-1], 128)[..., :L]


def _f64_cumsum(x, dim=-1):
    """The prefix sums summed in float64, then rounded once to x's dtype."""
    import torch

    return torch.cumsum(x.to(torch.float64), dim).to(x.dtype)


def _ml_compare(torch, args, chunk, what, witness=None):
    """The kernel against its plain version on the same inputs; raises past
    ML_TOL (of max(1, the output's largest |value|)), naming the pass at
    fault: the gate scan's terms and the states pass's C and n at every
    chunk boundary are held against :func:`mlstm_chunk_gates` and
    :func:`mlstm_chunk_states` (b summed in the kernel's order), h against
    the plain version.  Returns (worst error over h, C, n, m relative to
    that scale, worst absolute error, worst relative error of the first two
    passes' intermediate results).

    With ``witness`` (a list; the signed-stress cases, where den = q.n +
    sum(w) may cancel toward 0 and h then amplifies the rounding of the
    prefix sums b = cumsum(log f), which stand ~100s where the chunk forgets
    fast), the plain version runs with the kernel's own order of those
    additions (:func:`_kernel_cumsum`), so that the comparison holds the
    rest of the kernel's arithmetic at ML_TOL.  It then appends (what,
    dtype, |kernel - f64|, |plain - f64|, |plain in the kernel's order - f64|,
    |plain with b rounded from f64 - f64|) of h, each of max(1, the f64 h's
    largest |value|), f64 being the plain version run in float64."""
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_gates, mlstm_chunk_states,
                                                     mlstm_chunked)

    h, st, ps = mlstm_chunk_launch(*args, chunk=chunk, passes=True)
    order = {} if witness is None else {"cumsum": _kernel_cumsum}
    hr, sr = mlstm_chunked(*args, chunk=chunk, **order)
    # the first two passes against their plain versions (b in the kernel's
    # order): the gate scan's terms, and the states entering chunks 1..NC-1
    gr = mlstm_chunk_gates(args[3], args[4], chunk=chunk, cumsum=_kernel_cumsum)
    cr = mlstm_chunk_states(*args[1:], chunk=chunk, cumsum=_kernel_cumsum)
    torch.cuda.synchronize()
    tol = ML_TOL[str(args[0].dtype).split(".")[-1]]
    rel = err_abs = pass_rel = 0.0
    checks = [("gate scan", key, ps[key], gr[key]) for key in ("b", "m_t", "inter", "k_scale",
                                                                "old")]
    checks += [("states pass", key, ps[key], cr[key][:, :, :-1]) for key in ("C", "n")]
    checks += [("outputs", "h", h, hr), ("states pass", "final C", st["C"], sr["C"]),
               ("states pass", "final n", st["n"], sr["n"]), ("gate scan", "m", st["m"], sr["m"])]
    for pass_, name, got, want in checks:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"mlstm_chunk {what}: {name} is {got.dtype} {tuple(got.shape)}, "
                               f"the plain version's {want.dtype} {tuple(want.shape)}")
        if got.numel() == 0:
            continue
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if not err <= tol * scale:  # also catches NaN
            raise RuntimeError(f"mlstm_chunk kernel != plain version ({what}): the {pass_}'s "
                               f"{name} max |diff| {err:.3g} > {tol} x {scale:.3g}")
        if name in ("h", "final C", "final n", "m"):
            rel, err_abs = max(rel, err / scale), max(err_abs, err)
        else:
            pass_rel = max(pass_rel, err / scale)
    if witness is not None:
        wide, _ = mlstm_chunked(*(a.double() for a in args), chunk=chunk)
        plain, _ = mlstm_chunked(*args, chunk=chunk)
        rounded, _ = mlstm_chunked(*args, chunk=chunk, cumsum=_f64_cumsum)
        w_scale = max(1.0, float(wide.abs().max()))
        witness.append((what, str(args[0].dtype).split(".")[-1],
                        *(float((x.double() - wide).abs().max()) / w_scale
                          for x in (h, plain, hr, rounded))))
    return rel, err_abs, pass_rel


def phase_mlstm_vs_plain(torch, built):
    import itertools

    _report_build(10, "mlstm_chunk", built, ("mlstm_gate_scan_kernel", "mlstm_states_kernel",
                                             "mlstm_outputs_kernel"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_pass = 0.0
    witness = []
    seen = set()
    t0 = time.perf_counter()
    for (B, H), S, chunk, (dk, dv), dt, regime, layout in itertools.product(
            ((1, 1), (2, 3), (8, 4)), (64, 128, 512, 2048), (64, 128),
            ((16, 16), (32, 48), (64, 64), (512, 512)), (torch.float32, torch.bfloat16),
            ("reference", "stress", "signed stress"), ("contiguous", "model")):
        case = (B, H, S, min(chunk, S), dk, dv, dt, regime, layout)
        if case in seen:  # S = 64 takes chunk 64 either way
            continue
        seen.add(case)
        args = _ml_inputs(torch, B, H, S, dk, dv, dt, regime, gen, layout)
        what = f"B={B} H={H} S={S} chunk={case[3]} dk={dk} dv={dv} {dt} {regime} {layout}"
        rel, _, prel = _ml_compare(torch, args, case[3], what,
                                   witness if regime == "signed stress" else None)
        key = str(dt).split(".")[-1]
        worst[key] = max(worst[key], rel)
        worst_pass = max(worst_pass, prel)
        del args
    torch.cuda.empty_cache()
    m = ML_MAIN
    main = {}
    for layout in ("contiguous", "model"):
        main[layout] = _ml_compare(
            torch, _ml_inputs(torch, m["B"], m["H"], m["S"], m["dk"], m["dv"], torch.float32,
                              "reference", gen, layout), m["chunk"], f"main-path shape, {layout}")
        torch.cuda.empty_cache()
    log(f"phase 10: mlstm_chunk kernel == plain version on {len(seen)} cases ((B, H) in "
        f"{{(1, 1), (2, 3), (8, 4)}} x S in {{64, 128, 512, 2048}} x chunk {{64, 128}} x "
        f"(dk, dv) in {{(16, 16), (32, 48), (64, 64), (512, 512)}} x {{f32, bf16}} x gates "
        f"{{reference, stress, signed stress}} x layout {{contiguous, model}}; worst max |diff| "
        f"/ max(1, scale) over h, C, n, m: f32 "
        f"{worst['float32']:.3g} (tol {ML_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol "
        f"{ML_TOL['bfloat16']}); the gate scan's terms and the states at every chunk "
        f"boundary against their plain versions: worst {worst_pass:.3g}) and at the main-path "
        f"shape {tuple(m.values())} f32: "
        + ", ".join(f"{lay} {r:.3g} relative, {e:.3g} absolute, passes {pr:.3g}"
                    for lay, (r, e, pr) in main.items())
        + f"; in {time.perf_counter() - t0:.1f}s")
    # the signed-stress cases against the plain version in float64: h's
    # error in the kernel and in three f32 orders of the prefix sums
    within = sum(w[2] <= max(w[3:]) for w in witness)
    ratio = max(witness, key=lambda w: w[2] / max(max(w[3:]), 1e-30))
    log(f"phase 10: signed stress, {len(witness)} cases (held above against the plain version "
        f"in the kernel's order of the prefix sums b): h's max |error| against the plain "
        f"version in float64, of max(1, scale), as kernel; plain (torch.cumsum); plain in the "
        f"kernel's order; plain with b rounded from f64. The kernel's error is at most the "
        f"largest of the three plain orders' on {within} of {len(witness)} cases (largest "
        f"ratio {ratio[2] / max(max(ratio[3:]), 1e-30):.3g}, {ratio[0]}). The five largest in "
        f"f32 (bf16's are its rounding of h):")
    f32 = [w for w in witness if w[1] == "float32"]
    for what, _, k_err, p_err, o_err, r_err in sorted(f32, key=lambda w: -w[2])[:5]:
        log(f"  {what}: {k_err:.3g}; {p_err:.3g}; {o_err:.3g}; {r_err:.3g}")


def _span_report(torch, events, span, what, steps):
    """Device time and launches of the kernels launched inside the profiler
    span ``span`` (its ops' kernels, the span's own device annotation
    left out); returns the device ms per call (None where not measured)."""
    # the span's CPU range (its copy on the device timeline is an annotation)
    spans = [e for e in events if e.name == span
             and e.device_type == torch.autograd.DeviceType.CPU]

    def walk(e):
        ks = [k for k in e.kernels if not k.name.startswith(ANNOTATIONS)]
        ms, n = sum(k.duration for k in ks) / 1e3, len(ks)
        for c in e.cpu_children:
            cms, cn = walk(c)
            ms, n = ms + cms, n + cn
        return ms, n

    ms = n = 0
    for e in spans:
        sms, sn = walk(e)
        ms, n = ms + sms, n + sn
    if not spans or ms <= 0.0:
        log(f"  {span}: not measured (the profiler attributed no device time to "
            f"{len(spans)} spans)")
        return None
    log(f"  of which inside the {len(spans) // steps} {span} spans per call ({what}): "
        f"{ms / steps:.2f} ms device time, {n // steps} launches")
    return ms / steps


def phase_xlstm_serve_main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch, reset_launches
    from repro_torch.models import transformer as T

    cfg = get_config(XSERVE_ARCH)

    def extra(events):
        # the projections: the matmul kernels with few launches (the sLSTM's
        # per-step recurrent products launch thousands of times)
        kernels, _ = _device_kernels(torch, events)
        big = {n: v for n, v in kernels.items() if _kernel_class(n) == "matmul (cuBLAS)"
               and v[0] < 1000}
        big_ms = sum(v[1] for v in big.values())
        flops = _xlstm_matmul_flops(cfg, SERVE["slots"] * SERVE["max_prompt"])
        log(f"  projection matmuls: {flops / 1e12:.2f} TFLOP per wave (from the shapes) in "
            f"{big_ms:.1f} ms of {sum(v[0] for v in big.values())} launches: "
            f"{flops / big_ms / 1e9:.1f} TFLOP/s of the 67 f32 peak")
        _span_report(torch, events, "slstm_recurrence", "the sLSTM layers' time loops", 1)
        # the mlstm_chunk call's three passes, per call
        parts = {p: [0, 0.0] for p in ("gate_scan", "states", "outputs")}
        for n, (cnt, ms) in kernels.items():
            for p, acc in parts.items():
                if f"mlstm_{p}_kernel" in n:
                    acc[0], acc[1] = acc[0] + cnt, acc[1] + ms
        log("  mlstm_chunk device ms per call by pass: " + ", ".join(
            f"{p.replace('_', ' ')} " + (f"{ms / cnt:.3f}" if cnt else "not measured")
            for p, (cnt, ms) in parts.items()))

    n_mlstm = sum(g.count for g in T.block_groups(cfg) if g.kind == "mlstm")
    return _serve_main_path(torch, cfg, 11, mlstm_chunk_launch, reset_launches, n_mlstm, extra,
                            mlstm_impl="cuda")


def _xlstm_matmul_flops(cfg, tokens) -> float:
    """Projection flops of an xLSTM prefill over ``tokens`` tokens: per mLSTM
    layer up, gate, q, k, v, the two gate projections and down; per sLSTM
    layer the input and output projections (its recurrent product runs per
    step, apart; prefill takes the logits of the last token only)."""
    d, H = cfg.d_model, cfg.n_heads
    di = int(cfg.proj_factor * d)
    mlstm = 2 * d * di + 3 * di * di + 2 * di * H + di * d
    slstm = d * 4 * d + d * d
    n_s = len(cfg.slstm_layers())
    return 2.0 * tokens * ((cfg.n_layers - n_s) * mlstm + n_s * slstm)


def _record_gaps(torch, steps):
    """An engine ``on_logits`` hook: each decode step's top-two logit gap per
    slot (a share of the row's max |logit|, left on the device) and the
    (request id, index of the generated token) of each active row, appended
    to ``steps``; :func:`_gaps` reads them after the run."""
    def hook(logits, rows):
        lg = logits.float()
        top2 = torch.topk(lg, 2, dim=-1).values
        steps.append((rows, (top2[:, 0] - top2[:, 1]) / lg.abs().amax(dim=-1)))
    return hook


def _gaps(steps):
    """{(request id, index of the generated token): top-two gap} of a run."""
    out = {}
    for rows, rel in steps:
        rel = rel.tolist()
        out.update({key: rel[i] for i, key in rows.items()})
    return out


def _serve_kernel_vs_plain(torch, phase, arch, depth, field, launch, reset, per_wave, what):
    """The serve engine on ``arch`` cut to ``depth`` layers (full width, f32,
    random weights from seed 0), the 16 requests of SERVE, once with the
    runtime option ``field`` = "cuda" (the kernel wrapper ``launch`` must run
    exactly ``per_wave`` times per prefill wave) and once = "torch" (never).
    The tokens must match, or part only where the plain run's own top-two
    logit gap is below LOGIT_RTOL (a near tie), read by the engine's
    ``on_logits`` hook behind every generated token."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    reqs = _serve_requests(cfg.vocab_size)
    out, wall, steps = {}, {}, []
    for impl in ("cuda", "torch"):
        hook = _record_gaps(torch, steps) if impl == "torch" else None
        eng = _engine(torch, cfg, params, on_logits=hook, **{field: impl})
        for r in reqs:
            eng.submit(r)
        reset()
        t0 = time.perf_counter()
        out[impl] = {c.rid: c.tokens for c in eng.run_until_drained()}
        torch.cuda.synchronize()
        wall[impl] = time.perf_counter() - t0
        want = per_wave * eng.stats()["prefills"] if impl == "cuda" else 0
        if launch.launches != want:
            raise RuntimeError(f"{field}={impl}: {launch.launches} {launch.__name__} launches, "
                               f"want {want}")
        del eng
        torch.cuda.empty_cache()
    gaps = _gaps(steps)
    parted = []
    for r in reqs:
        a, b = out["cuda"][r.rid], out["torch"][r.rid]
        if (a == b).all():
            continue
        pos = int((a != b).argmax())
        gap = gaps[(r.rid, pos)]
        log(f"  request {r.rid}: tokens part at generated position {pos} ({a[pos]} kernel vs "
            f"{b[pos]} plain); plain top-two logit gap {gap:.3g} of max |logit|")
        parted.append(gap)
        if not gap < LOGIT_RTOL:
            raise RuntimeError(f"request {r.rid}: kernel and plain paths part at position "
                               f"{pos} where the plain top-two gap {gap:.3g} is not a near tie "
                               f"(< {LOGIT_RTOL})")
    log(f"phase {phase}: {arch} serve at {what}, {len(reqs)} requests: kernel path == plain "
        f"path token for token on {len(reqs) - len(parted)} of {len(reqs)} requests"
        + (f", the other {len(parted)} part at near ties" if parted else "")
        + f" (smallest plain top-two gap {min(gaps.values()):.3g}); {launch.__name__} "
        f"launches {per_wave} per wave; run {wall['cuda']:.2f}s kernel vs {wall['torch']:.2f}s "
        "plain")
    del params
    torch.cuda.empty_cache()


def phase_xlstm_kernel_vs_plain(torch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch, reset_launches
    from repro_torch.models import transformer as T

    depth = 6  # layers 0-4 mLSTM, layer 5 sLSTM
    groups = T.block_groups(dataclasses.replace(get_config(XSERVE_ARCH), n_layers=depth))
    n_mlstm = sum(g.count for g in groups if g.kind == "mlstm")
    _serve_kernel_vs_plain(torch, 12, XSERVE_ARCH, depth, "mlstm_impl", mlstm_chunk_launch,
                           reset_launches, n_mlstm,
                           f"{depth} layers ({n_mlstm} mLSTM, {depth - n_mlstm} sLSTM)")


def _ml_bound(q, v, chunk):
    """The work of one call and its bounds.  Multiply-adds per (batch, head)
    and chunk of L rows: the causal lower triangle of the scores and of w.v,
    L(L+1)/2 * (dk + dv), + 2*L*dk*dv (q.C and the state update) + L*dk
    (q.n); each of q, k, v, h and the gates moved once, the final C, n and m
    written once.  "tc" is the tensor-core bound the kernel is held to
    (3xTF32 in f32), "ffma" the f32 FFMA bound of the SIMT kernel it
    replaced; beside them, the recurrent form's 2*S*dk*dv multiply-adds per
    (batch, head) (C updated and read once per token), the least work the
    cell can be done in."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    L = chunk
    macs = B * H * (S // L) * (L * (L + 1) // 2 * (dk + dv) + 2 * L * dk * dv + L * dk)
    nbytes = (q.element_size() * B * H * S * (2 * dk + 2 * dv) + 4 * 2 * B * H * S
              + 4 * B * H * (dk * dv + dk + 1))
    return {"flops": 2 * macs, "bytes": nbytes, "rec_flops": 2 * 2 * B * H * S * dk * dv,
            "tc": _tc_bound(nbytes, 2 * macs, q.dtype), "ffma": _bound(nbytes, 2 * macs)}


def phase_mlstm_timing(torch):
    """The kernel at the serve main path's shape: its time, both bounds, the
    memory one call takes above its inputs, and its plain version (phase 11
    splits its device time by pass).  No single PyTorch call computes
    chunked mLSTM, so there is no library time."""
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunked

    m = ML_MAIN
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = _ml_inputs(torch, m["B"], m["H"], m["S"], m["dk"], m["dv"], torch.float32,
                      "reference", gen)
    _, err, _ = _ml_compare(torch, args, m["chunk"], "timing inputs")
    run = lambda: mlstm_chunk_launch(*args, chunk=m["chunk"])
    ms = _time_ms(torch, run, 10)
    plain_ms = _time_ms(torch, lambda: mlstm_chunked(*args, chunk=m["chunk"]), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    call_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    del out
    b = _ml_bound(args[0], args[2], m["chunk"])
    (tc_ms, by), (ffma_ms, _) = b["tc"], b["ffma"]
    flops = b["flops"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    log(f"phase 13: mlstm_chunk at the main-path shape q/k/v {tuple(args[0].shape)}, chunk "
        f"{m['chunk']}, f32 ({smi}): kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
        f"tensor-core bound {tc_ms:.3f} ms by {by} (3 x {flops / 1e9:.2f} GFLOP, the causal "
        f"triangle, / 494.7 TFLOP/s TF32; {b['bytes'] / 1e9:.3f} GB / 3.35 TB/s = "
        f"{b['bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms): {tc_ms / ms:.1%} of it; the f32 FFMA "
        f"bound of the SIMT design {ffma_ms:.3f} ms (/ 67 TFLOP/s), the kernel at "
        f"{ms / ffma_ms:.2f}x it; the recurrent form's "
        f"{b['rec_flops'] / 1e9:.2f} GFLOP would take "
        f"{b['rec_flops'] * 3 / TF32_FLOP_PER_S * 1e3:.3f} ms in 3xTF32); plain version {plain_ms:.3f} ms, library: none (no single PyTorch "
        f"call computes chunked mLSTM); max |kernel - plain| {err:.3g}")
    log(f"  memory one call allocates above its inputs {call_gib:.3f} GiB (outputs and the "
        "scratch of the gate scan and the carried states)")
    del args
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": tc_ms,
            "bound_by": by, "err": err}


# ---------------------------------------------------------------------------
# Flat parameter planes and serving while training (phases 14-16)
# ---------------------------------------------------------------------------

# the stage kernel's cases on planes: every op x {plain, lars + clip +
# coupled weight decay}; with the latter, gs per node and r per plane row
PLANE_CTXS = {"plain": dict(beta=0.9),
              "lars-clip-wd": dict(beta=0.9, wd=1e-2, coupled_wd=True, clip=True, lars=True)}
# a small stacked plane: five leaves of 1, 3, 69, 128 and 26 rows (227 rows,
# padded to 256) in one bucket
PLANE_SMALL_LEAVES = {"a": (5, 7), "b": (3000,), "c": (70001,), "d": (128, 1024), "e": (333, 77)}


def _plane_operands(torch, layout, names, x_dtype, gen, pool=None):
    """Random stacked planes for the operand ``names``: x in ``x_dtype``, the
    rest f32, mix near x; at full size (``pool`` of three f32 planes) the
    operands share the pool's buffers (each input is only read)."""
    from repro_torch.core.planes import LANES

    (key,) = layout.buckets
    shape = (MAIN["nodes"], layout.rows[key], LANES)
    ins = {}
    for i, n in enumerate(names):
        if pool is not None:
            ins[n] = pool[i % len(pool)]
            continue
        t = torch.randn(shape, generator=gen, device="cuda")
        ins[n] = t.to(x_dtype) if n == "x" else t
    if pool is None and "mix" in ins and "x" in ins:
        ins["mix"] = ins["x"].float() + 0.01 * ins["mix"]
    return {n: {key: t} for n, t in ins.items()}


def _plane_scalars(torch, layout, lars, gen):
    """Stage scalars: lr and sg, and with ``lars`` a per-node clip scale and
    staleness damping and per-leaf per-node LARS ratios (scattered to row
    columns)."""
    from repro_torch.utils import tree_unflatten

    n = MAIN["nodes"]
    s = {"lr": torch.tensor(0.01, device="cuda"), "sg": 0.6}
    if lars:
        # the staleness damping per node, as a delayed channel's gaps give it
        s["sg"] = torch.pow(0.5, torch.randint(0, 4, (n,), generator=gen, device="cuda")
                            .float())
        s["gs"] = 0.5 + torch.rand(n, generator=gen, device="cuda")
        r = [0.5 + torch.rand(n, generator=gen, device="cuda") for _ in range(layout.n_leaves)]
        s["r_leaves"] = tree_unflatten(layout.template, r)
        s["r"] = layout.row_scalars(s["r_leaves"])
    return s


def _same_bits(torch, a, b) -> bool:
    """Same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _plane_case(torch, layout, kind, op, ctx, x_dtype, gen, pool=None):
    """One plane launch held against its plain version (node by node: a
    whole-plane plain pass would not fit beside a full-size plane) and, bit
    for bit on every segment's true elements, against the per-leaf launches
    on the same inputs.  Returns ``(worst f32 error / scale, the leaves whose
    outputs differ in any bit)``."""
    from repro_torch.kernels.fused_update import make_plane_stage, make_stage
    from repro_torch.kernels.fused_update.kernel import stage_io, stage_plain
    from repro_torch.utils import tree_leaves, tree_paths

    names_in, names_out = stage_io(kind, op, ctx)
    ops = _plane_operands(torch, layout, names_in, x_dtype, gen, pool)
    (key,) = layout.buckets
    like = ops.get("x", {key: torch.empty(0, dtype=x_dtype)})
    s = _plane_scalars(torch, layout, ctx.lars, gen)
    scal = {k: v for k, v in s.items() if k != "r_leaves"}
    got = make_plane_stage("triton")(kind, op, ctx, ops, scal, like)
    torch.cuda.synchronize()

    worst = 0.0
    one = torch.tensor(1.0, device="cuda")
    svec = torch.stack([s["lr"], one, one, one if ctx.lars else torch.tensor(s["sg"],
                                                                           device="cuda")])
    out_dtypes = {n: got[n][key].dtype for n in names_out}
    for i in range(MAIN["nodes"]):
        ins = {n: ops[n][key][i] for n in names_in}
        cols = ({"gs": s["gs"][i], "r": s["r"][key][i], "sg": s["sg"][i]} if ctx.lars
                else None)
        want = stage_plain(kind, op, ctx, svec, ins, out_dtypes, cols)
        for n in names_out:
            w, g = want[n].float(), got[n][key][i].float()
            tol = BF16_TOL if out_dtypes[n] == torch.bfloat16 else F32_TOL
            scale = float(w.abs().max())
            torch.testing.assert_close(
                g, w, rtol=tol, atol=tol * scale,
                msg=lambda m, n=n: f"plane {kind}/{op} {ctx} {x_dtype} node {i} {n}: {m}")
            if out_dtypes[n] == torch.float32:
                worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
        del want, ins

    # the per-leaf launches on contiguous copies of each leaf's operands,
    # one leaf at a time
    views = {n: tree_leaves(layout.view_unpack(ops[n], leading=1)) for n in names_in}
    got_views = {n: tree_leaves(layout.view_unpack(got[n], leading=1)) for n in names_out}
    r_leaves = tree_leaves(s["r_leaves"]) if ctx.lars else None
    paths = tree_paths(layout.template)
    differ = []
    for j in range(layout.n_leaves):
        ins = {n: {"w": views[n][j].contiguous()} for n in names_in}
        sj = dict(scal, r={"w": r_leaves[j]}) if ctx.lars else scal
        like_j = ins["x"] if "x" in ins else {"w": torch.empty(0, dtype=x_dtype)}
        res = make_stage("triton")(kind, op, ctx, ins, sj, like_j)
        differ += [f"{paths[j]}/{n} (max |diff| "
                   f"{float((res[n]['w'].float() - got_views[n][j].float()).abs().max()):.3g})"
                   for n in names_out if not _same_bits(torch, res[n]["w"], got_views[n][j])]
        del ins, res
    del ops, got, views, got_views
    torch.cuda.empty_cache()
    return worst, differ


def phase_plane_kernel_vs_plain(torch):
    """The plane launch of the stage kernel == its plain version (phase 2's
    tolerances) and == the per-leaf launches bit for bit, for every op x
    {plain, lars-clip-wd}: on a small stacked plane with x in f32 and bf16,
    and on qwen3-0.6b's full (4, 648000, 1024) f32 plane (its operands drawn
    from two shared f32 planes, so that the largest case fits the card)."""
    from repro_torch.configs import get_config
    from repro_torch.core.planes import PlaneLayout
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.fused_update.kernel import OPS
    from repro_torch.train.train_state import model_plane_layout

    gen = torch.Generator(device="cuda").manual_seed(14)
    t0 = time.perf_counter()
    worst, cases, differ = 0.0, 0, {}
    for x_dtype in (torch.float32, torch.bfloat16):
        small = PlaneLayout.build({k: torch.empty(sh, dtype=x_dtype, device="meta")
                                   for k, sh in PLANE_SMALL_LEAVES.items()})
        for (kind, op) in OPS:
            for cname, kw in PLANE_CTXS.items():
                w, bad = _plane_case(torch, small, kind, op, MathCtx(**kw), x_dtype, gen)
                worst, cases = max(worst, w), cases + 1
                if bad:
                    differ[f"small x {x_dtype} {op} {cname}"] = bad
    small_s = time.perf_counter() - t0
    (skey,) = small.buckets
    full = model_plane_layout(get_config(MAIN["arch"]))
    (key,) = full.buckets
    shape = (MAIN["nodes"], full.rows[key], 1024)
    pool = [torch.randn(shape, generator=gen, device="cuda") for _ in range(2)]
    t1 = time.perf_counter()
    for (kind, op) in OPS:
        for cname, kw in PLANE_CTXS.items():
            w, bad = _plane_case(torch, full, kind, op, MathCtx(**kw), torch.float32, gen, pool)
            worst, cases = max(worst, w), cases + 1
            if bad:
                differ[f"full {op} {cname}"] = bad
    del pool
    torch.cuda.empty_cache()
    for case, bad in differ.items():
        log(f"  plane != per-leaf launches in some bit: {case}: {bad}")
    if differ:
        raise RuntimeError(f"the plane launch and the per-leaf launches differ in some bit on "
                           f"{len(differ)} of {cases} cases: {sorted(differ)}")
    log(f"phase 14: plane stage kernel == plain version on {cases} cases (every op x "
        f"{list(PLANE_CTXS)}, gs and sg per node and r per row under lars-clip-wd; small plane "
        f"({MAIN['nodes']}, {small.rows[skey]}, 1024) of {len(PLANE_SMALL_LEAVES)} leaves, x "
        f"f32/bf16, {small_s:.1f}s; full {shape} f32, {full.n_leaves} leaves, "
        f"{time.perf_counter() - t1:.1f}s; worst f32 error / scale {worst:.3g}, f32 rtol "
        f"{F32_TOL}, bf16 rtol {BF16_TOL}); plane == per-leaf launches bit for bit on every "
        f"segment's true elements in {cases - len(differ)} of {cases} cases")



def phase_plane_timing(torch, nodes=MAIN["nodes"], cfg=None):
    """The flat-plane path's two stages at qwen3-0.6b's full stacked plane
    (4, 648000, 1024) f32 — or ``(nodes, 648000, 1024)``: one rank's plane
    is (1, ...); or at the plane of ``cfg`` — one launch each per step:
    kernel time, bound, the plain version (node by node: its temporaries
    over the whole plane would not fit) and, for grad_step,
    ``torch.addcmul``."""
    from repro_torch.configs import get_config
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.fused_update.kernel import (
        fused_stage_launch,
        stage_bytes,
        stage_io,
        stage_plain,
    )
    from repro_torch.train.train_state import model_plane_layout

    full = model_plane_layout(cfg if cfg is not None else get_config(MAIN["arch"]))
    (key,) = full.buckets
    shape = (nodes, full.rows[key], 1024)
    ctx = MathCtx(beta=0.9)
    svec = _svec(torch, lr=3e-3)
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for kind, op in (("pre", "grad_step"), ("post", "decentlam_post")):
        names_in, names_out = stage_io(kind, op, ctx)
        ins = {n: torch.randn(shape, generator=gen, device="cuda") for n in names_in}
        if "mix" in ins:
            ins["mix"].mul_(0.01).add_(ins["x"])
        outs = {n: torch.empty(shape, device="cuda") for n in names_out}
        fused_stage_launch(kind, op, ctx, svec, ins, outs)
        torch.cuda.synchronize()
        f32 = {n: torch.float32 for n in names_out}

        def plain():
            for i in range(nodes):
                stage_plain(kind, op, ctx, svec, {n: t[i] for n, t in ins.items()}, f32)

        err = 0.0
        for i in range(nodes):
            want = stage_plain(kind, op, ctx, svec, {n: t[i] for n, t in ins.items()}, f32)
            for n in names_out:
                torch.testing.assert_close(outs[n][i], want[n], rtol=F32_TOL,
                                           atol=F32_TOL * float(want[n].abs().max()))
                err = max(err, float((outs[n][i] - want[n]).abs().max()))
            del want
        ms = _time_ms(torch, lambda: fused_stage_launch(kind, op, ctx, svec, ins, outs), 5)
        plain_ms = _time_ms(torch, plain, 2)
        lib = _library(torch, op)
        lib_ms = _time_ms(torch, lambda: lib(svec, ins, outs), 5) if lib else None
        numel = outs[names_out[0]].numel()
        nbytes = stage_bytes(ins, outs)
        bound_ms, by = _bound(nbytes, numel * STAGE_FLOPS[op])
        out[op] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": by, "err": err, "bytes": nbytes, "shape": shape}
        del ins, outs
        torch.cuda.empty_cache()
    return out


def phase_flat_planes_main_path(torch, leaf, per_stage):
    """The flat-plane training main path (phase 3's run with
    ``--flat-planes``): 2 stage launches per step, the tail's time beside its
    bound and beside phase 5's per-leaf tail, step time, device busy share,
    peak memory beside phase 3's; then at 4 layers, 3 steps, its losses
    against the per-leaf kernel path's, and one pmsgd-lars + grad_clip
    plane step against the plain plane path."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train
    from repro_torch.train.step import TrainConfig, build_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout
    from repro_torch.utils import tree_leaves

    res, launches, total, events, step_ms = _profiled_train(torch, ["--flat-planes"])
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the flat-plane path: {res['losses']}")
    if total != 2 * steps or launches != {op: steps for op in STAGE_FLOPS}:
        raise RuntimeError(f"flat planes: fused_update launched {total} times ({launches}), "
                           f"want 2 x {steps}: one per bucket and stage")
    plane = phase_plane_timing(torch)
    tail = {k: sum(p[k] for p in plane.values()) for k in ("ms", "plain_ms", "bound_ms")}
    leaf_tail = sum(r["ms"] for r in per_stage.values())
    peak = res["peak_mem_bytes"] / 2**30
    log(f"phase 15: flat planes, qwen3-0.6b full width x {res['n_nodes']} nodes, {steps} "
        f"steps: losses {[round(v, 4) for v in res['losses']]}; fused_update launches "
        f"{total} = 2 per step ({launches}; the per-leaf path: 28 per step)")
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"
    for op, p in plane.items():
        log(f"  plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms by {p['bound_by']} ({p['bytes'] / 1e9:.2f} GB; "
            f"{p['bound_ms'] / p['ms']:.1%} of it), plain version {p['plain_ms']:.3f} ms, "
            f"library {fmt(p['library_ms'])}, max |kernel - plain| {p['err']:.3g}")
    log(f"  tail {tail['ms']:.3f} ms/step (2 launches) against its bound {tail['bound_ms']:.3f} "
        f"ms ({tail['bound_ms'] / tail['ms']:.1%}) and the per-leaf tail of phase 5, "
        f"{leaf_tail:.3f} ms (28 launches); plain version {tail['plain_ms']:.3f} ms")
    tokens = MAIN["nodes"] * MAIN["per_node_batch"] * MAIN["seq_len"]
    log(f"  step {step_ms:.1f} ms (phase 3, per leaf: {leaf['step_ms']:.1f}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB (phase 3, per "
        f"leaf: {leaf['peak'] / 2**30:.2f} GiB), step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, events, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
    log(f"  device busy {prof['busy_ms']:.1f} ms/step (phase 3: {leaf['busy_ms']:.1f}); "
        f"fused_update {prof['classes'].get('fused_update (Triton)', 0.0):.3f} ms/step in the "
        "profile; the kernels whose device time moved most against phase 3's profile "
        "(launches and ms per step, per leaf -> planes):")
    names = set(prof["kernels"]) | set(leaf["kernels"])
    moved = sorted(names, key=lambda k: -abs(prof["kernels"].get(k, (0, 0.0))[1]
                                             - leaf["kernels"].get(k, (0, 0.0))[1]))
    for k in moved[:6]:
        (n0, t0), (n1, t1) = leaf["kernels"].get(k, (0, 0.0)), prof["kernels"].get(k, (0, 0.0))
        log(f"    {n0:g} / {t0:.2f} -> {n1:g} / {t1:.2f}  {k[:100]}")
    torch.cuda.empty_cache()

    depth, n3 = 4, 3
    flat = train.main(_train_argv(n3, "triton", depth) + ["--flat-planes"])
    per_leaf = train.main(_train_argv(n3, "triton", depth))
    a, b = flat["losses"], per_leaf["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if not rel <= 1e-6:
        raise RuntimeError(f"flat-plane losses {a} != per-leaf kernel losses {b} (rtol 1e-6)")
    log(f"  {depth} layers, {n3} steps: plane losses {a} vs per-leaf {b}: max rel diff "
        f"{rel:.3g} (<= 1e-6), bitwise equal: {a == b}")

    # one pmsgd-lars + grad_clip plane step: kernel against the plain plane path
    import dataclasses

    cfg = dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                         per_node_batch=MAIN["per_node_batch"],
                                         n_nodes=MAIN["nodes"]))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    after = {}
    for impl in ("triton", "torch"):
        tcfg = TrainConfig(algorithm="pmsgd-lars", grad_clip=1.0, weight_decay=1e-2,
                           schedule=ScheduleConfig(kind="constant", peak_lr=0.1,
                                                   total_steps=2),
                           fused_update=True, fused_impl=impl, flat_planes=True)
        step_fn, channel = build_train_step(cfg, tcfg, MAIN["nodes"])
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), MAIN["nodes"],
                                 device=torch.device("cuda"), channel=channel,
                                 plane_layout=model_plane_layout(cfg))
        reset_launches()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        after[impl] = (state["planes"], state["opt"]["m"], fused_stage_launch.launches)
    (px, pm, n_k), (qx, qm, _) = after["triton"], after["torch"]
    errs = []
    for got, want in ((px, qx), (pm, qm)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL * float(w.abs().max()))
            errs.append(float((g - w).abs().max()))
    log(f"  pmsgd-lars + grad_clip 1.0 + weight_decay 1e-2, one plane step at {depth} layers: "
        f"kernel ({n_k} launches) == plain plane path, max |diff| {max(errs):.3g} (rtol "
        f"{F32_TOL})")
    del after, px, pm, qx, qm, state
    torch.cuda.empty_cache()
    return {"launches": launches, "plane": plane, "step_ms": step_ms,
            "peak": res["peak_mem_bytes"], "busy_ms": prof["busy_ms"], "losses": res["losses"]}



SWT = dict(steps=8, publish_every=2)  # phase 16: serving while training


def phase_serve_while_training(torch):
    """Phase 15's trainer with ``--serve-while-training`` at full width: node
    0 publishes every 2 steps through the WeightPublisher, the engine (4
    slots, ``attn_impl="cuda"``) ticks once per step and drains after.
    Gates: every offer ships (the stacked channel has no staleness); each
    snapshot equals node 0's parameter plane byte for byte; the engine's
    parameters never change inside a decode call; every request completes;
    flash_attention launched once per layer per prefill wave; the requests
    admitted after the last swap get the tokens of a fresh engine on that
    snapshot."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches
    from repro_torch.launch import train
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.serve import ServeEngine

    rt = RuntimeConfig(dtype="float32", attn_impl="cuda")
    seen = {"checked": 0, "offer_ms": [], "swap_ms": [], "swap_at": [], "requests": [],
            "inside": 0}

    def hook(engine, pub):
        seen["engine"], seen["pub"] = engine, pub
        offer, swap, decode, submit = pub.offer, engine._maybe_swap, engine.decode_step, \
            engine.submit

        def checked_offer(src, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            shipped = offer(src, **kw)
            seen["offer_ms"].append(1e3 * (time.perf_counter() - t))
            if shipped:
                for k, plane in src.items():
                    if not _same_bits(torch, pub.current.planes[k].to(plane.device), plane):
                        raise RuntimeError(f"snapshot v{kw['version']} != node 0's {k} plane")
                seen["checked"] += 1
            return shipped

        def timed_swap():
            before = engine.version
            torch.cuda.synchronize()
            t = time.perf_counter()
            swap()
            if engine.version != before:
                seen["swap_ms"].append(1e3 * (time.perf_counter() - t))
                seen["swap_at"].append(time.perf_counter())

        def watched_decode(params, *args):
            version, ident = engine.version, id(engine._params)
            out = decode(params, *args)
            if engine.version != version or id(engine._params) != ident:
                seen["inside"] += 1
            return out

        def recorded_submit(req):
            seen["requests"].append(req)
            submit(req)

        pub.offer, engine._maybe_swap, engine.decode_step = checked_offer, timed_swap, \
            watched_decode
        engine.submit = recorded_submit

    reset_launches()
    res = train.main(_train_argv(SWT["steps"], "triton") + [
        "--flat-planes", "--serve-while-training", "--publish-every", str(SWT["publish_every"])],
        serve_runtime=rt, on_serve=hook)
    flash = flash_attention_launch.launches
    eng, pub = seen["engine"], seen["pub"]
    ps, es = res["serve"]["publisher"], res["serve"]["engine"]
    want_pub = -(-SWT["steps"] // SWT["publish_every"])
    if ps["offers"] != want_pub or ps["published"] != want_pub or seen["checked"] != want_pub:
        raise RuntimeError(f"publisher {ps}, {seen['checked']} snapshots checked; want "
                           f"{want_pub} offers, all shipped and checked")
    if seen["inside"] or es["swaps"] != want_pub - 1:
        raise RuntimeError(f"engine {es}: {seen['inside']} parameter changes inside a decode "
                           f"call; want none and {want_pub - 1} swaps")
    done = {c.rid: c for c in eng.completions}
    reqs = seen["requests"]
    if sorted(done) != [r.rid for r in reqs]:
        raise RuntimeError(f"{len(done)} of {len(reqs)} requests completed")
    n_layers = get_config(MAIN["arch"]).n_layers
    if flash != n_layers * es["prefills"]:
        raise RuntimeError(f"flash_attention launched {flash} times, want {n_layers} x "
                           f"{es['prefills']} prefill waves")
    after = [r for r in reqs if done[r.rid].admitted_s > seen["swap_at"][-1]]
    if not after:
        raise RuntimeError("no request was admitted after the last swap")
    fresh = ServeEngine(get_config(MAIN["arch"]), slots=4, max_prompt=32, max_new=16,
                        params=pub.current.params, runtime=rt)
    for r in after:
        fresh.submit(r)
    ref = {c.rid: c.tokens for c in fresh.run_until_drained()}
    parted = [r.rid for r in after if not (ref[r.rid] == done[r.rid].tokens).all()]
    if parted:
        raise RuntimeError(f"requests {parted}: tokens after the last swap differ from a fresh "
                           f"engine on snapshot v{pub.current.version}")
    log(f"phase 16: serving while training, qwen3-0.6b full width, flat planes, "
        f"{SWT['steps']} steps: published {ps['published']}/{ps['offers']} offers (every "
        f"{SWT['publish_every']} steps, gap 0), each snapshot == node 0's parameter plane byte "
        f"for byte; {es['swaps']} swaps, all between decode batches; {len(done)}/{len(reqs)} "
        f"requests complete in {es['decode_batches']} decode batches, {es['prefills']} prefill "
        f"waves, flash_attention launches {flash} (= {n_layers} x {es['prefills']}); the "
        f"{len(after)} requests admitted after the last swap == a fresh engine on v"
        f"{pub.current.version}, token for token")
    gb = sum(v.numel() * v.element_size() for v in pub.current.planes.values()) / 1e9
    log(f"  per publish, node 0's plane to the pinned host buffer ({gb:.2f} GB, one copy per "
        f"bucket): {[round(v, 1) for v in seen['offer_ms']]} ms; per swap, host to device: "
        f"{[round(v, 1) for v in seen['swap_ms']]} ms (the first is the initial load); train "
        f"step {res['step_s'] * 1e3:.1f} ms, losses {[round(v, 4) for v in res['losses']]}")
    del fresh, eng, pub, seen
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Stale and compressed gossip, checkpoint and resume (phases 17-20)
# ---------------------------------------------------------------------------

# phase 17: the staleness main path (on phase 3's run)
STALE = ["--flat-planes", "--algorithm", "decentlam-sa", "--gossip-delay", "1",
         "--track-consensus"]
# phase 18: compressed gossip at full width and depth
COMPRESSED = ["--flat-planes", "--compression", "int8-row-ef"]
# f32 operations per element of decentlam_sa_post: (x - mix) / lr (2), the
# momentum beta*m + (sg*drift + (1 - sg)*g) (5), x - lr*(sg*(beta*m) + drift) (4)
SA_FLOPS = 11
# reckoned peaks (GiB; one f32 plane copy is 9.89 GiB): x, m, g, the two
# ring slots (the payload written into one of them) and the mix; x, m, g,
# the payload, the residual, the decoded payload and the mix
PEAK_GIB = {"delay 1": 59.3, "int8-row-ef": 69.2}


def _watch_sg(torch):
    """Wrap the fused engine's launcher so that every decentlam_sa_post
    launch records the per-node sg column it was given (None without one).
    Returns ``(records, undo)``; the launch and its counts are the
    launcher's own."""
    from repro_torch.kernels.fused_update import ops

    launch, seen = ops.fused_stage_launch, []

    def recorded(kind, op, ctx, svec, ins, outs, **kw):
        if op == "decentlam_sa_post":
            seen.append((kw.get("per_node") or {}).get("sg"))
        return launch(kind, op, ctx, svec, ins, outs, **kw)

    ops.fused_stage_launch = recorded
    return seen, lambda: setattr(ops, "fused_stage_launch", launch)


def _sa_post_timing(torch):
    """decentlam_sa_post at qwen3-0.6b's full stacked plane (4, 648000, 1024)
    f32 with sg per node (the SG_COL launch): kernel time beside its bound,
    the plain version node by node (checked against the kernel first); no
    single PyTorch call computes the stage."""
    from repro_torch.configs import get_config
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.fused_update.kernel import (
        fused_stage_launch,
        stage_bytes,
        stage_io,
        stage_plain,
    )
    from repro_torch.train.train_state import model_plane_layout

    full = model_plane_layout(get_config(MAIN["arch"]))
    (key,) = full.buckets
    n = MAIN["nodes"]
    shape = (n, full.rows[key], 1024)
    ctx, op = MathCtx(beta=0.9), "decentlam_sa_post"
    svec = _svec(torch, lr=3e-3)
    sg = torch.tensor([1.0, 0.5, 0.5, 0.25], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    names_in, names_out = stage_io("post", op, ctx)
    ins = {nm: torch.randn(shape, generator=gen, device="cuda") for nm in names_in}
    ins["mix"].mul_(0.01).add_(ins["x"])
    outs = {nm: torch.empty(shape, device="cuda") for nm in names_out}
    launch = lambda: fused_stage_launch("post", op, ctx, svec, ins, outs, nodes=n,
                                        per_node={"sg": sg})
    launch()
    torch.cuda.synchronize()
    f32 = {nm: torch.float32 for nm in names_out}
    one = lambda i: {nm: t[i] for nm, t in ins.items()}
    err, bitwise = 0.0, True
    for i in range(n):
        want = stage_plain("post", op, ctx, svec, one(i), f32, {"sg": sg[i]})
        for nm in names_out:
            torch.testing.assert_close(outs[nm][i], want[nm], rtol=F32_TOL,
                                       atol=F32_TOL * float(want[nm].abs().max()))
            err = max(err, float((outs[nm][i] - want[nm]).abs().max()))
            bitwise = bitwise and _same_bits(torch, outs[nm][i], want[nm])
        del want

    def plain():
        for i in range(n):
            stage_plain("post", op, ctx, svec, one(i), f32, {"sg": sg[i]})

    ms = _time_ms(torch, launch, 5)
    plain_ms = _time_ms(torch, plain, 2)
    numel = outs["x"].numel()
    nbytes = stage_bytes(ins, outs)
    bound_ms, by = _bound(nbytes, numel * SA_FLOPS)
    del ins, outs
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": by, "err": err, "bytes": nbytes, "shape": shape, "bitwise": bitwise}


def _gossip_timing(torch):
    """One gossip round on qwen3-0.6b's full stacked plane (4, 648000, 1024)
    f32, timed with CUDA events after a warm-up round: the undelayed mix,
    the mix at delay 1 (ring write and two delay groups), and int8-row-ef
    (the encode/decode of each node's payload alone, and the whole round).
    Beside each, the bytes it must move over 3.35 TB/s: a mix reads the n
    payloads and writes the n mixed ones; the delayed one also writes the
    ring slot and reads the stale slot; the compressed one also reads and
    writes the residual and writes and reads the decoded payloads (the
    encode/decode alone: the payload and the residual read, the residual
    and the decoded payload written)."""
    from repro_torch.configs import get_config
    from repro_torch.core.gossip import DelayedStackedChannel, StackedChannel
    from repro_torch.core.topology import build_topology
    from repro_torch.train.train_state import model_plane_layout

    full = model_plane_layout(get_config(MAIN["arch"]))
    (key,) = full.buckets
    topo = build_topology("exp", MAIN["nodes"])
    gen = torch.Generator(device="cuda").manual_seed(18)
    payload = {key: torch.randn((MAIN["nodes"], full.rows[key], 1024), generator=gen,
                                device="cuda")}
    plane = payload[key].numel() * 4
    out = {}
    cases = {"undelayed": (StackedChannel(topo), 2 * plane),
             "delay 1": (DelayedStackedChannel(topo, 1), 5 * plane),
             "int8-row-ef": (StackedChannel(topo, compression="int8-row-ef"), 7 * plane)}
    for name, (ch, nbytes) in cases.items():
        box = {"state": ch.init(payload), "step": 0}

        def round_():
            box["state"], mixed = ch.apply(box["state"], payload, box["step"])
            box["step"] += 1
            del mixed

        ms = _time_ms(torch, round_, 3)
        out[name] = (ms, nbytes / HBM_BYTES_PER_S * 1e3)
        if name == "int8-row-ef":
            dest = torch.empty_like(payload[key])
            enc_ms = _time_ms(torch, lambda: ch._encode_decode(payload[key],
                                                                box["state"]["comp"][key], dest), 3)
            out["int8-row-ef encode + decode"] = (enc_ms, 4 * plane / HBM_BYTES_PER_S * 1e3)
            del dest
        del box
        torch.cuda.empty_cache()
    del payload
    torch.cuda.empty_cache()
    for name, (ms, bound) in out.items():
        log(f"  gossip round on the full plane, {name}: {ms:.2f} ms (its bytes over 3.35 TB/s: "
            f"{bound:.2f} ms, {bound / ms:.1%})")
    return out


def phase_staleness_main_path(torch, flat):
    """Phase 15's run with ``--algorithm decentlam-sa --gossip-delay 1
    --track-consensus``: 2 stage launches per step, gossip_gap 0 at step 0
    and 1 after, every decentlam_sa_post launch in the SG_COL mode with sg
    per node == max(0.5**gap, 0), profiled; then the stage timed at the full
    plane beside its bound."""
    import math

    from repro_torch.core.gossip import DelayedStackedChannel, fleet_node_gaps
    from repro_torch.core.topology import build_topology
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch

    gaps_seen = []
    ring = DelayedStackedChannel(build_topology("exp", MAIN["nodes"]), 1)  # reads the counts
    watch = lambda step, state, metrics: gaps_seen.append(
        fleet_node_gaps(ring, state["channel"]).tolist())
    seen, undo = _watch_sg(torch)
    try:
        res, launches, total, events, step_ms = _profiled_train(torch, STALE, watch)
    finally:
        undo()
    by_col = dict(fused_stage_launch.launches_by_col)
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the staleness path: {res['losses']}")
    want = {"grad_step": steps, "decentlam_sa_post": steps}
    if total != 2 * steps or launches != want:
        raise RuntimeError(f"fused_update launched {total} times ({launches}), want {want}")
    if res["gossip_gaps"] != [0.0] + [1.0] * (steps - 1):
        raise RuntimeError(f"gossip_gap per step {res['gossip_gaps']}, want 0 then 1")
    if len(seen) != steps or any(c is None for c in seen) or \
            by_col.get(("decentlam_sa_post", "sg")) != steps:
        raise RuntimeError(f"decentlam_sa_post took the per-node sg column on "
                           f"{by_col.get(('decentlam_sa_post', 'sg'))} of {steps} launches")
    sgs = [c.tolist() for c in seen]
    want_sg = [[max(0.5 ** g, 0.0) for g in gaps] for gaps in gaps_seen]
    if sgs != want_sg:
        raise RuntimeError(f"sg per node {sgs} != max(0.5**gap, 0) {want_sg}")
    peak = res["peak_mem_bytes"] / 2**30
    log(f"phase 17: decentlam-sa, --gossip-delay 1, flat planes, qwen3-0.6b full width x "
        f"{res['n_nodes']} nodes, {steps} steps: losses {[round(v, 4) for v in res['losses']]}; "
        f"fused_update launches {total} = 2 per step ({launches}), every decentlam_sa_post "
        f"launch with the per-node sg column ({by_col[('decentlam_sa_post', 'sg')]}); "
        f"gossip_gap per step {res['gossip_gaps']}")
    log(f"  node gaps per step {gaps_seen}; sg per node, as the kernel read it, {sgs} "
        f"(== max(0.5**gap, 0))")
    log(f"  consensus_sq per step {res['consensus_sq']}")
    log(f"  step {step_ms:.1f} ms (phase 15, flat planes without delay: {flat['step_ms']:.1f}), "
        f"peak memory {peak:.2f} GiB (reckoned {PEAK_GIB['delay 1']} GiB; phase 15: "
        f"{flat['peak'] / 2**30:.2f} GiB), step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, events, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
    log(f"  device busy {prof['busy_ms']:.1f} ms/step (phase 15: {flat['busy_ms']:.1f})")
    torch.cuda.empty_cache()
    gossip = _gossip_timing(torch)
    sa = _sa_post_timing(torch)
    grad_bound = flat["plane"]["grad_step"]["bound_ms"]
    log(f"  plane decentlam_sa_post on {sa['shape']} f32, sg per node: kernel {sa['ms']:.3f} ms, "
        f"bound {sa['bound_ms']:.3f} ms by {sa['bound_by']} ({sa['bytes'] / 1e9:.2f} GB / "
        f"3.35 TB/s; {sa['bound_ms'] / sa['ms']:.1%} of it), plain version "
        f"{sa['plain_ms']:.3f} ms, library null, max |kernel - plain| {sa['err']:.3g} "
        f"(bitwise equal: {sa['bitwise']})")
    tail = flat["plane"]["grad_step"]["ms"] + sa["ms"]
    log(f"  tail {tail:.3f} ms/step (grad_step {flat['plane']['grad_step']['ms']:.3f} + "
        f"decentlam_sa_post {sa['ms']:.3f}) against its bound {grad_bound + sa['bound_ms']:.3f} "
        f"ms ({grad_bound:.3f} + {sa['bound_ms']:.3f})")
    return {"launches": launches, "sa": sa, "step_ms": step_ms, "peak": res["peak_mem_bytes"],
            "gossip": gossip}


def phase_compressed_main_path(torch, flat):
    """Phase 15's run with ``--compression int8-row-ef``: finite losses, the
    telemetry's egress bytes == the f32 running sum of wire_bytes x edge
    classes per round, as the reference's telemetry accumulates them; step
    time, the encode/decode and mix device time, peak memory."""
    import math

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.compression import wire_bytes
    from repro_torch.core.topology import build_topology
    from repro_torch.train.train_state import model_plane_layout

    tele = []
    watch = lambda step, state, metrics: tele.append(
        (float(state["channel"]["t"]["bytes"]), int(state["channel"]["t"]["rounds"])))
    res, launches, total, events, step_ms = _profiled_train(torch, COMPRESSED, watch)
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss with int8-row-ef gossip: {res['losses']}")
    layout = model_plane_layout(get_config(MAIN["arch"]))
    (key,) = layout.buckets
    per_node = 4.0 * layout.rows[key] * 1024
    classes = len(build_topology("exp", MAIN["nodes"]).edge_classes(0))
    per_round = np.float32(classes * wire_bytes(per_node, "int8-row-ef"))
    want, expect = np.float32(0.0), []
    for _ in range(steps):
        want = np.float32(want + per_round)
        expect.append((float(want), len(expect) + 1))
    if tele != expect:
        raise RuntimeError(f"telemetry (bytes, rounds) per step {tele}, want {expect}")
    peak = res["peak_mem_bytes"] / 2**30
    log(f"phase 18: decentlam, --compression int8-row-ef, flat planes, qwen3-0.6b full width x "
        f"{res['n_nodes']} nodes, {steps} steps: losses {[round(v, 4) for v in res['losses']]}; "
        f"fused_update launches {total} ({launches}); egress bytes per node "
        f"{tele[-1][0]:.6g} after {tele[-1][1]} rounds == the f32 sum of {classes} edge classes "
        f"x wire_bytes({per_node:.0f}) = {float(per_round):.6g} per round")
    log(f"  step {step_ms:.1f} ms (phase 15: {flat['step_ms']:.1f}), peak memory {peak:.2f} GiB "
        f"(reckoned {PEAK_GIB['int8-row-ef']} GiB), step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, events, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
    log(f"  device busy {prof['busy_ms']:.1f} ms/step (phase 15: {flat['busy_ms']:.1f}); the "
        f"gossip rounds alone at the full plane: phase 17")
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "peak": res["peak_mem_bytes"]}


# phase 19: each configuration at 4 layers, 3 steps, kernel path vs plain path
KERNEL_VS_PLAIN = {
    "decentlam-sa, delay 1, planes": ["--algorithm", "decentlam-sa", "--gossip-delay", "1",
                                      "--flat-planes"],
    "decentlam-sa, delay 2, per leaf": ["--algorithm", "decentlam-sa", "--gossip-delay", "2"],
    "decentlam-sa, delay 1, int8-row-ef, planes": ["--algorithm", "decentlam-sa",
                                                   "--gossip-delay", "1", "--compression",
                                                   "int8-row-ef", "--flat-planes"],
    "decentlam, bf16": ["--compression", "bf16"],
    "decentlam, int8": ["--compression", "int8"],
    "decentlam, topk:0.01": ["--compression", "topk:0.01"],
    "da-dmsgd, delay 1": ["--algorithm", "da-dmsgd", "--gossip-delay", "1"],
    "decentlam, grad-accum 2": ["--grad-accum", "2"],
    "decentlam, dtype bfloat16": ["--dtype", "bfloat16"],
}


def _last_state(holder):
    """An ``on_step`` hook keeping a reference to the latest step's state
    (the run's final state once ``train.main`` returns)."""

    def hook(step, state, metrics):
        holder["state"] = state

    return hook


def _state_leaves(state, layout):
    """Parameters, then optimizer state, in leaf order; a plane-form state's
    optimizer buckets as views of their leaves, so that they compare like a
    per-leaf state's tensors."""
    from repro_torch.utils import tree_leaves

    opt = state["opt"]
    if "planes" in state:
        opt = {k: layout.view_unpack(v, leading=1) for k, v in opt.items()}
    return tree_leaves(state["params"]) + tree_leaves(opt)


def phase_gossip_kernel_vs_plain(torch):
    """At 4 layers, 3 steps: the kernel path against the plain path for each
    configuration of KERNEL_VS_PLAIN (losses to LOSS_RTOL); then on the
    kernel path, bit for bit: --gossip-delay 0 == no delay, decentlam-sa on an
    undelayed channel (gap 0) == decentlam, and flat planes == per leaf for
    decentlam-sa at delay 1."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train.train_state import model_plane_layout

    depth, steps = 4, 3
    layout = model_plane_layout(dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth))
    rows = []
    for name, extra in KERNEL_VS_PLAIN.items():
        kern = train.main(_train_argv(steps, "triton", depth) + extra)
        plain = train.main(_train_argv(steps, "torch", depth) + extra)
        a, b = kern["losses"], plain["losses"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        if not all(map(math.isfinite, a)) or not rel <= LOSS_RTOL:
            raise RuntimeError(f"{name}: kernel losses {a} vs plain {b} (rtol {LOSS_RTOL})")
        rows.append(f"{name}: max rel diff {rel:.3g}{' (bitwise)' if a == b else ''}")
    torch.cuda.empty_cache()
    log(f"phase 19: {depth} layers, {steps} steps, kernel path == plain path (loss rtol "
        f"{LOSS_RTOL}) in {len(rows)} configurations:")
    for r in rows:
        log(f"  {r}")

    pairs = {
        "--gossip-delay 0 == no delay": (["--gossip-delay", "0"], []),
        "decentlam-sa at gap 0 == decentlam (planes)": (
            ["--algorithm", "decentlam-sa", "--flat-planes"], ["--flat-planes"]),
        "flat planes == per leaf, decentlam-sa at delay 1": (
            ["--algorithm", "decentlam-sa", "--gossip-delay", "1", "--flat-planes"],
            ["--algorithm", "decentlam-sa", "--gossip-delay", "1"]),
    }
    for name, (one, other) in pairs.items():
        ha, hb = {}, {}
        ra = train.main(_train_argv(steps, "triton", depth) + one, on_step=_last_state(ha))
        rb = train.main(_train_argv(steps, "triton", depth) + other, on_step=_last_state(hb))
        sa = _state_leaves(ha.pop("state"), layout)
        sb = _state_leaves(hb.pop("state"), layout)
        same = (ra["losses"] == rb["losses"] and len(sa) == len(sb)
                and all(_same_bits(torch, x, y) for x, y in zip(sa, sb)))
        if not same:
            raise RuntimeError(f"{name}: not bit for bit (losses {ra['losses']} vs "
                               f"{rb['losses']})")
        log(f"  {name}: losses and the final parameters and optimizer state bit for bit "
            f"({len(sa)} tensors)")
        del sa, sb
        torch.cuda.empty_cache()


# phase 20: checkpoint and resume at full width, 2 layers, 2 nodes
CKPT = ["--nodes", "2", "--arch", "qwen3-0.6b", "--depth", "2", "--seq-len",
        str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
        "--algorithm", "decentlam-sa", "--gossip-delay", "1", "--compression", "int8-row-ef",
        "--fused-update", "--fused-impl", "triton", "--log-every", "1", "--steps", "4"]


def _host_copy(state) -> dict:
    """Leaf path -> host copy of a state's parameters, optimizer and
    channel state."""
    from repro_torch.utils import tree_leaves, tree_paths

    tree = {k: state[k] for k in ("params", "opt", "channel")}
    return {p: t.detach().cpu().clone() for p, t in zip(tree_paths(tree), tree_leaves(tree))}


def phase_checkpoint_resume(torch):
    """Phase 17's algorithm with delay 1 and int8-row-ef on planes, qwen3-0.6b
    at full width, 2 layers, 2 nodes: 4 steps unbroken (saving at step 2;
    its final checkpoint, which nothing reads, is not written) against 2 steps, a state restored with --resume from the step-2
    checkpoint in a fresh directory, and 2 more: losses, parameters,
    optimizer and the whole channel state bit for bit.  Then the resumed
    run's checkpoint restored without --flat-planes: parameters and
    momentum equal the saved planes unpacked, the channel state starts
    afresh, and 2 more steps have finite losses."""
    import dataclasses
    import shutil

    import repro_torch.launch.train as train
    from repro_torch.configs import get_config
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.step import TrainConfig, build_train_step
    from repro_torch.train.train_state import model_plane_layout
    from repro_torch.utils import tree_leaves, tree_paths

    root = os.path.join(HERE, "build", "ckpt_smoke")
    a, b = os.path.join(root, "unbroken"), os.path.join(root, "resumed")
    free = shutil.disk_usage(HERE).free
    log(f"phase 20: {free / 1e9:.1f} GB free on the checkout's disk")
    save, restore = train.save_checkpoint, train.restore_checkpoint
    times = {"save": [], "restore": []}

    def timed(kind, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            times[kind].append(time.perf_counter() - t)
            return out
        return wrapped

    timed_save = timed("save", save)

    def save_but_unbroken_final(directory, state, **kw):
        if directory == a and int(state["step"]) == 4:
            return os.path.join(directory, "step_00000004 (not written)")
        return timed_save(directory, state, **kw)

    train.save_checkpoint = save_but_unbroken_final
    train.restore_checkpoint = timed("restore", restore)
    try:
        ha, hb = {}, {}
        ra = train.main(CKPT + ["--flat-planes", "--ckpt-dir", a, "--ckpt-every", "2"],
                        on_step=_last_state(ha))
        straight = _host_copy(ha.pop("state"))
        torch.cuda.empty_cache()
        gb = os.path.getsize(os.path.join(a, "step_00000002", "state.npz")) / 1e9
        os.makedirs(b)
        os.replace(os.path.join(a, "step_00000002"), os.path.join(b, "step_00000002"))
        shutil.rmtree(a)
        rb = train.main(CKPT + ["--flat-planes", "--ckpt-dir", b, "--resume"],
                        on_step=_last_state(hb))
        resumed = _host_copy(hb.pop("state"))
        torch.cuda.empty_cache()
        if rb["start_step"] != 2 or rb["losses"] != ra["losses"][2:]:
            raise RuntimeError(f"resumed losses {rb['losses']} from step {rb['start_step']}, "
                               f"unbroken {ra['losses']}")
        differ = [k for k in straight if not _same_bits(torch, straight[k], resumed[k])]
        if sorted(straight) != sorted(resumed) or differ:
            raise RuntimeError(f"resumed state != unbroken state: {differ or 'keys differ'}")
        chan = [k for k in straight if k.startswith("channel/")]
        log(f"  unbroken {ra['losses']} == 2 steps, save, --resume, 2 steps {rb['losses']}; "
            f"the final state bit for bit in all {len(straight)} tensors "
            f"({len(chan)} of the channel: {chan})")
        shutil.rmtree(os.path.join(b, "step_00000002"))

        # the same checkpoint into the per-leaf form, then 2 steps on it
        cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
        layout = model_plane_layout(cfg)
        tcfg = TrainConfig(algorithm="decentlam-sa", gossip_delay=1, compression="int8-row-ef",
                           fused_update=True, fused_impl="triton",
                           schedule=ScheduleConfig(kind="warmup_cosine", peak_lr=3e-3,
                                                   warmup_steps=1, total_steps=6))
        step_fn, channel = build_train_step(cfg, tcfg, 2)
        state = train.resume_state(b, cfg, channel, None, False, 2, torch.device("cuda"))
        saved_m = {"float32": resumed["opt/m/float32"]}
        m_tree = layout.unpack(saved_m, dtype=torch.float32, leading=1)
        got = dict(zip(tree_paths(state["params"]), tree_leaves(state["params"])))
        want_m = dict(zip(tree_paths(m_tree), tree_leaves(m_tree)))
        got_m = dict(zip(tree_paths(state["opt"]["m"]), tree_leaves(state["opt"]["m"])))
        bad = [p for p, t in got.items() if not _same_bits(torch, t.cpu(), resumed[f"params/{p}"])]
        bad += [p for p, t in got_m.items() if not _same_bits(torch, t.cpu(), want_m[p])]
        # the residual and the ring start afresh; the telemetry carries on
        fresh = all(not t.any() for k, v in state["channel"].items() if k != "t"
                    for t in tree_leaves(v))
        fresh = fresh and all(_same_bits(torch, state["channel"]["t"][k].cpu(),
                                         resumed[f"channel/t/{k}"]) for k in ("bytes", "rounds"))
        if bad or sorted(got_m) != sorted(want_m) or not fresh:
            raise RuntimeError(f"per-leaf resume: {bad} differ from the saved planes, channel "
                               f"re-initialized: {fresh}")
        n_leaves = len(got)
        del got, got_m, m_tree
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                             per_node_batch=MAIN["per_node_batch"], n_nodes=2))
        losses = []
        for k in (4, 5):
            state, metrics = step_fn(state, {n: torch.from_numpy(v).cuda()
                                             for n, v in data.batch(k).items()})
            losses.append(float(metrics["loss"]))
        if state["step"] != 6 or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"per-leaf resume: losses {losses} to step {state['step']}")
        del state
        torch.cuda.empty_cache()
        log(f"  the resumed run's step-4 checkpoint without --flat-planes: {n_leaves} parameter "
            f"leaves and every momentum leaf == the saved planes unpacked, the channel state "
            f"re-initialized (zeros) but for the telemetry; 2 more steps, losses {losses}")
        log(f"  {gb:.2f} GB per checkpoint; save {[round(t, 1) for t in times['save']]} s, "
            f"restore {[round(t, 1) for t in times['restore']]} s")
    finally:
        train.save_checkpoint, train.restore_checkpoint = save, restore
        shutil.rmtree(root, ignore_errors=True)

# ---------------------------------------------------------------------------
# One process per node over torch.distributed (phases 21-23)
# ---------------------------------------------------------------------------

# phase 21: the distributed main path, phase 15's flags on 4 ranks sharing the
# card (gloo, messages staged through pinned host memory)
DIST = ["--simulate-nodes", str(MAIN["nodes"]), "--gossip-impl", "ppermute", "--arch",
        MAIN["arch"], "--topology", "exp", "--algorithm", "decentlam", "--seq-len",
        str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]), "--flat-planes",
        "--fused-update", "--fused-impl", "triton", "--log-every", "1"]
DIST_STEPS = 3
# a deadline for every spawned group: a hung rank fails the phase
DIST_TIMEOUT_S = 600
# reckoned device memory per rank at its gossip (GiB): x, m, g, the payload
# and the mix (2.47 GiB per f32 plane copy at full width), the forward's
# activations and a CUDA context
DIST_RANK_GIB = 13.0
DIST_DIR = os.path.join(HERE, "build", "dist_smoke")


def _dist_record(tag, step, state, metrics):
    """``on_step`` hook of the spawned ranks: each rank appends its stage
    launch counts after the step (cumulative, from its own fresh process,
    whose counts start at 0) to ``DIST_DIR/<tag>.<rank>``."""
    import torch.distributed as dist

    from repro_torch.kernels.fused_update.kernel import fused_stage_launch

    rec = {"step": step, "launches": fused_stage_launch.launches,
           "by_op": dict(fused_stage_launch.launches_by_op), "loss": float(metrics["loss"])}
    with open(os.path.join(DIST_DIR, f"{tag}.{dist.get_rank()}"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _dist_records(tag, world):
    out = []
    for r in range(world):
        with open(os.path.join(DIST_DIR, f"{tag}.{r}")) as f:
            out.append([json.loads(line) for line in f])
    return out


def phase_dist_main_path(torch, flat):
    """Phase 15's run as 4 processes, one node each (``--simulate-nodes 4
    --gossip-impl ppermute``), 3 steps: finite losses, exactly 2 stage
    launches per step on every rank (the plane stage at a node axis of 1),
    the step-0 loss equal to phase 15's to 1e-5 relative (both depend only
    on the init and the data); the backend, step time, gossip seconds per
    round and the staged GB/s, each rank's peak memory and the card's; the
    stage kernel at one rank's (1, 648000, 1024) plane beside phase 15's
    plane tail."""
    import functools
    import shutil

    from repro_torch.launch import train

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = MAIN["nodes"] * DIST_RANK_GIB * 2**30
    log(f"phase 21: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free before the spawn, "
        f"{need / 2**30:.1f} GiB reckoned for {MAIN['nodes']} ranks")
    if free < need:
        raise RuntimeError(f"{free / 2**30:.2f} GiB free, {need / 2**30:.1f} GiB reckoned")
    measure = os.path.join(DIST_DIR, "measure.json")
    res = train.main(DIST + ["--steps", str(DIST_STEPS), "--measure-json", measure,
                             "--timeout", str(DIST_TIMEOUT_S)],
                     on_step=functools.partial(_dist_record, "main"))
    steps = len(res["losses"])
    if steps != DIST_STEPS or not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"distributed losses {res['losses']}")
    recs = _dist_records("main", MAIN["nodes"])
    counts = [[r["launches"] for r in rank] for rank in recs]
    want = [[2 * (k + 1) for k in range(steps)]] * MAIN["nodes"]
    by_op = [rank[-1]["by_op"] for rank in recs]
    if counts != want or any(b != {op: steps for op in STAGE_FLOPS} for b in by_op):
        raise RuntimeError(f"stage launches per rank after each step {counts} ({by_op}), "
                           f"want {want[0]}: one per stage and step")
    loss0, ref0 = res["losses"][0], flat["losses"][0]
    if not abs(loss0 - ref0) <= 1e-5 * abs(ref0):
        raise RuntimeError(f"step-0 loss {loss0} != phase 15's {ref0} (rtol 1e-5)")
    gossip_s = res["gossip_s_per_round"]
    staged = res["staged_bytes_per_round"]
    step_ms = 1e3 * res["step_s"]
    log(f"phase 21: qwen3-0.6b full width, {MAIN['nodes']} processes x 1 node ({res['backend']} "
        f"on {sorted(set(res['devices']))}), {steps} steps: losses "
        f"{[round(v, 4) for v in res['losses']]}; step 0 {loss0!r} == phase 15's {ref0!r} "
        f"(rel {abs(loss0 - ref0) / abs(ref0):.2g}); fused_update launches per rank {counts} "
        f"= 2 per step ({by_op[0]})")
    log(f"  step {step_ms:.1f} ms (mean of steps 1..{steps - 1}; phase 15, stacked: "
        f"{flat['step_ms']:.1f}), step times {[round(t, 3) for t in res['step_times_s']]}")
    log(f"  gossip (channel.apply between device syncs, host clock) per rank and round: "
        f"{[round(t, 3) for t in gossip_s]} s; staged through host memory per round "
        f"{[round(b / 1e9, 3) for b in staged]} GB (device -> host and back), "
        f"{[round(b / t / 1e9, 3) for b, t in zip(staged, gossip_s)]} GB/s")
    peaks = [p / 2**30 for p in res["peak_mem_bytes_by_rank"]]
    log(f"  peak memory per rank {[round(p, 2) for p in peaks]} GiB (reckoned "
        f"{DIST_RANK_GIB}), card in use at most {res['card_used_bytes'] / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f} (phase 15, stacked: {flat['peak'] / 2**30:.2f} GiB)")
    one = phase_plane_timing(torch, nodes=1)
    tail = sum(p["ms"] for p in one.values())
    full = sum(p["ms"] for p in flat["plane"].values())
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"
    for op, p in one.items():
        log(f"  per rank: plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms ({p['bound_ms'] / p['ms']:.1%} of it), plain version "
            f"{p['plain_ms']:.3f} ms, library {fmt(p['library_ms'])}, max |kernel - plain| "
            f"{p['err']:.3g}")
    log(f"  per rank tail {tail:.3f} ms/step (2 launches at n = 1) beside phase 15's stacked "
        f"tail {full:.3f} ms (n = 4; {full / MAIN['nodes']:.3f} per node)")
    return {"res": res, "one": one}


# phase 22: each configuration at 4 layers, 2 steps (3 until PR 18: the
# script's time limit), in one spawned group
# (name, TrainConfig fields, what it is held to: the reference's
# distributed-vs-oracle tolerance on the final parameters against the
# stacked run, that tolerance over lr on the optimizer state; "finite"; or
# None, a run kept for the bitwise pairs below)
DIST_VS_STACKED = [
    ("ppermute, per leaf", {}, 2e-5),
    ("ppermute, planes", {"flat_planes": True}, None),
    ("ppermute, planes, plain stage", {"flat_planes": True, "fused_impl": "torch"}, None),
    ("allgather, planes", {"flat_planes": True, "gossip_impl": "allgather"}, 2e-5),
    ("decentlam-sa, delay 1, planes", {"flat_planes": True, "algorithm": "decentlam-sa",
                                       "gossip_delay": 1}, 2e-5),
    ("pmsgd, planes", {"flat_planes": True, "algorithm": "pmsgd"}, 2e-5),
    ("da-dmsgd, planes", {"flat_planes": True, "algorithm": "da-dmsgd"}, 2e-5),
    ("bf16, planes", {"flat_planes": True, "compression": "bf16"}, 5e-2),
    ("int8-row-ef, planes", {"flat_planes": True, "compression": "int8-row-ef"}, "finite"),
    ("topk:0.01, per leaf", {"compression": "topk:0.01"}, "finite"),
]
# pairs that must agree bit for bit within the distributed path
DIST_LR = 3e-3  # peak lr of phase 22's runs
DIST_BITWISE = [("planes == per leaf", "ppermute, planes", "ppermute, per leaf"),
                ("--fused-impl triton == torch", "ppermute, planes",
                 "ppermute, planes, plain stage")]


def _dist_tcfg(depth, fields):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.train.step import TrainConfig

    cfg = dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth)
    tcfg = TrainConfig(**{"fused_update": True, "fused_impl": "triton",
                          "schedule": ScheduleConfig(kind="warmup_cosine", peak_lr=DIST_LR,
                                                     warmup_steps=1, total_steps=3),
                          **fields})
    return cfg, tcfg


def _comparable(state, layout):
    """Leaf path -> tensor of a state's parameters and optimizer state, a
    plane-form state's optimizer buckets as their leaves (``layout``), so
    that a plane run and a per-leaf run compare leaf by leaf."""
    from repro_torch.utils import tree_leaves, tree_paths

    opt = state.get("opt", {})
    if layout is not None:
        opt = {k: layout.view_unpack(v, leading=1) for k, v in opt.items()}
    tree = {"params": state["params"], "opt": opt}
    return dict(zip(tree_paths(tree), tree_leaves(tree)))


def _dist_vs_stacked_rank(group, depth, steps):
    """The body of phase 22 on one rank (see :func:`phase_dist_vs_stacked`).
    Rank 0 returns the report lines; any failed check raises.  Only the
    configurations held against the stacked run gather their parameters and
    optimizer state to rank 0 (compared there on the card); the finite and
    bitwise checks run on each rank's own node, their verdicts gathered."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.compression import wire_bytes
    from repro_torch.core.gossip import DelayedPpermuteChannel, PpermuteChannel, make_psum_mean
    from repro_torch.core.optimizers import ALGORITHMS, OptimizerConfig, make_optimizer
    from repro_torch.core.topology import build_topology
    from repro_torch.core.update_spec import run_update, update_spec
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.step import build_dist_train_step, build_train_step
    from repro_torch.train.train_state import gather_state, init_train_state, model_plane_layout

    lead = group.rank == 0
    dev = group.device
    lines, kept = [], {}

    def every(value):
        out = [None] * group.world
        dist.all_gather_object(out, value, group=group.pg)
        return out

    def run(build, n, cfg, tcfg, layout):
        step_fn, channel = build()
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), n, device=dev,
                                 channel=channel, plane_layout=layout)
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                             per_node_batch=MAIN["per_node_batch"],
                                             n_nodes=group.world))
        losses = []
        for k in range(steps):
            batch = {key: torch.from_numpy(v).to(dev) for key, v in data.batch(k).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        return state, losses

    for name, fields, tol in DIST_VS_STACKED:
        cfg, tcfg = _dist_tcfg(depth, fields)
        layout = model_plane_layout(cfg) if tcfg.flat_planes else None
        t0 = time.perf_counter()
        state, losses = run(lambda: build_dist_train_step(cfg, tcfg, group), 1, cfg, tcfg,
                            layout)
        dist_s = time.perf_counter() - t0
        mine = _comparable(state, layout)
        line = f"{name}: losses {[round(v, 4) for v in losses]} ({dist_s:.1f} s)"
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"{name}: distributed losses {losses}")
        if any(name in pair[1:] for pair in DIST_BITWISE):
            kept[name] = {k: v.detach().cpu() for k, v in mine.items()}
        if tol == "finite":
            # one node's f32 payload: the plane (pads included) or the leaves
            per_node = (4.0 * 1024 * sum(layout.rows.values()) if layout is not None
                        else 4.0 * sum(v[0].numel() for k, v in mine.items()
                                       if k.startswith("params/")))
            classes = len(build_topology(tcfg.topology, group.world).edge_classes(0))
            per_round = np.float32(classes * wire_bytes(per_node, tcfg.compression))
            want = np.float32(0.0)
            for _ in range(steps):
                want = np.float32(want + per_round)
            t = state["channel"]["t"]
            ok = (all(bool(torch.isfinite(v).all()) for v in mine.values())
                  and (float(t["bytes"][0]), int(t["rounds"][0])) == (float(want), steps))
            if not all(every(ok)):
                raise RuntimeError(f"{name}: non-finite state or telemetry {t} != "
                                   f"({float(want)}, {steps}) on some rank")
            line += (f"; every parameter and optimizer tensor finite on every rank; egress "
                     f"telemetry {float(want):.6g} B after {steps} rounds == the f32 sum of "
                     f"wire_bytes")
        elif tol is not None:
            host = gather_state({"step": steps, "params": state["params"], "opt": state["opt"]},
                                group)
            del state, mine
            torch.cuda.empty_cache()
            if lead:
                got = _comparable(host, layout)
                sstate, slosses = run(lambda: build_train_step(cfg, tcfg, group.world),
                                      group.world, cfg, tcfg, layout)
                want = _comparable(sstate, layout)
                if sorted(want) != sorted(got):
                    raise RuntimeError(f"{name}: leaves differ from the stacked run's")
                errs = {part: max(float((got[k].to(dev) - want[k]).abs().max()) for k in want
                                  if k.startswith(part)) for part in ("params", "opt")}
                del sstate, want, got
                # the momentum is the mix's difference over lr: the parameter
                # tolerance carries over to it divided by the peak lr
                tols = {"params": tol, "opt": tol / DIST_LR}
                if not all(errs[p] < tols[p] for p in errs):
                    raise RuntimeError(f"{name}: max |distributed - stacked| {errs} (tol {tols})")
                line += (f"; stacked {[round(v, 4) for v in slosses]}; max |distributed - "
                         f"stacked| {errs['params']:.3g} over the final parameters (< {tol}), "
                         f"{errs['opt']:.3g} over the optimizer state (< {tol} / lr)")
            del host
        lines.append(line)
        state = mine = None
        torch.cuda.empty_cache()
        dist.barrier(group=group.pg)

    for what, a, b in DIST_BITWISE:
        fa, fb = kept[a], kept[b]
        ok = sorted(fa) == sorted(fb) and all(_same_bits(torch, fa[k], fb[k]) for k in fa)
        if not all(every(ok)):
            raise RuntimeError(f"{what}: not bit for bit on some rank")
        lines.append(f"{what}: every rank's final parameters and optimizer state bit for bit "
                     f"({len(fa)} tensors)")
    kept.clear()

    # --gossip-delay 0 == the undelayed channel: DelayedPpermuteChannel at
    # delay 0 against PpermuteChannel, two updates of each algorithm on
    # seeded payloads (the reference's claim, tests/test_distributed.py)
    topo = build_topology("exp", group.world)
    rng = np.random.default_rng(22 + group.rank)
    shapes = {"a": (1, 300, 77), "b": (1, 4096)}
    for algo in ALGORITHMS:
        ocfg = OptimizerConfig(algorithm=algo, momentum=0.9)
        opt = make_optimizer(ocfg)
        x = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
             for k, s in shapes.items()}
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
             for k, s in shapes.items()}
        outs = []
        for ch in (PpermuteChannel(topo, group, telemetry=True),
                   DelayedPpermuteChannel(topo, group, 0, calls_per_step=opt.gossips_per_step,
                                          telemetry=True)):
            xs, st, cs = {k: v.clone() for k, v in x.items()}, opt.init(x), ch.init(x)
            for step in range(2):
                xs, st, cs = run_update(update_spec(ocfg), ocfg, x=xs, g=g, state=st, lr=0.05,
                                        step_idx=step, gossip=ch,
                                        mean=make_psum_mean(group, group.world), comp_state=cs)
            outs.append(xs)
        if not all(every(all(_same_bits(torch, outs[0][k], outs[1][k]) for k in x))):
            raise RuntimeError(f"{algo}: delay 0 != undelayed on some rank")
    lines.append(f"--gossip-delay 0 == undelayed: DelayedPpermuteChannel(delay=0) == "
                 f"PpermuteChannel bit for bit, 2 updates of each of {len(ALGORITHMS)} "
                 f"algorithms on every rank")
    return lines if lead else None


def phase_dist_vs_stacked(torch):
    """At 4 layers, 2 steps, in one spawned group of 4 ranks through the
    library: each configuration of DIST_VS_STACKED on the distributed step,
    its final parameters and optimizer state gathered to rank 0 and held
    against the stacked step's (rank 0 runs it) at the reference's
    distributed-vs-oracle tolerances (2e-5; 5e-2 with bf16 messages;
    int8-row-ef and top-k finite, with the egress telemetry); then bit for
    bit within the distributed path: planes == per leaf, the stage kernel
    == its plain version, and delay 0 == undelayed for every algorithm."""
    from repro_torch.launch.mesh import run_ranks

    depth, steps = 4, 2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = run_ranks(_dist_vs_stacked_rank, MAIN["nodes"], depth, steps,
                      timeout_s=DIST_TIMEOUT_S)[0]
    held = sum(isinstance(tol, float) for _, _, tol in DIST_VS_STACKED)
    log(f"phase 22: {depth} layers, {steps} steps, {MAIN['nodes']} ranks on the card, "
        f"distributed == stacked in {held} configurations, the finite ones, and the "
        f"bitwise claims ({time.perf_counter() - t0:.1f} s):")
    for line in lines:
        log(f"  {line}")


# phase 23: checkpoint and resume at full width, 2 layers, on 2 ranks (4
# until PR 18: the script's time limit; the checkpoint's I/O and the loopback
# gossip scale with the ranks), and the drill on 4 ranks (4 -> 2)
DIST_CKPT_RANKS = 2
DIST_CKPT = ["--simulate-nodes", str(MAIN["nodes"]), "--arch", MAIN["arch"], "--depth", "2",
             "--seq-len", str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
             "--algorithm", "decentlam-sa", "--gossip-delay", "1", "--flat-planes",
             "--fused-update", "--fused-impl", "triton", "--log-every", "1", "--timeout",
             str(DIST_TIMEOUT_S)]


def _check_shrink(group, gathered, state):
    """``on_shrink`` hook of phase 23: gather the survivors' rebuilt state
    to rank 0 and hold it against ``elastic_reshape`` of the state gathered
    before the shrink, bit for bit (every parameter and optimizer tensor; the
    channel state starts afresh).  Rank 0 returns ``(tensors, differing)``."""
    import torch

    from repro_torch.train.checkpoint import elastic_reshape
    from repro_torch.train.train_state import gather_state
    from repro_torch.utils import tree_leaves, tree_paths

    now = gather_state(state, group)
    if now is None:
        return None
    want = elastic_reshape(gathered, group.world)
    tree_a = {k: now[k] for k in ("params", "opt")}
    tree_b = {k: want[k] for k in ("params", "opt")}
    pa = dict(zip(tree_paths(tree_a), tree_leaves(tree_a)))
    pb = dict(zip(tree_paths(tree_b), tree_leaves(tree_b)))
    differ = [k for k in pb if k not in pa or not _same_bits(torch, pa[k], pb[k])]
    fresh = all(not bool(t.any()) for k, t in zip(tree_paths(now.get("channel", {})),
                                                   tree_leaves(now.get("channel", {}))))
    return len(pb), differ, fresh


def _dist_resume_rank(group, root, argv):
    """The checkpoint half of phase 23 on one rank, through the trainer's
    own pieces: 4 steps unbroken, with a checkpoint after step 2 (the state
    gathered to rank 0, which writes it); then the trainer's resume path
    (``_resume_ranks``: read on rank 0, scatter, reconcile) on a fresh
    channel and steps 2 and 3 again.  Each rank holds its final state
    against the unbroken one bit for bit; rank 0 returns the report."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.step import build_dist_train_step
    from repro_torch.train.train_state import gather_state, init_train_state, model_plane_layout
    from repro_torch.utils import tree_leaves, tree_paths

    args = train._parse(argv)
    cfg, tcfg = train._model_config(args), train._train_config(args)
    layout = model_plane_layout(cfg)
    dev, lead = group.device, group.rank == 0
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                         per_node_batch=args.per_node_batch,
                                         n_nodes=group.world))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def batch(k):
        return {key: torch.from_numpy(v).to(dev) for key, v in data.batch(k).items()}

    def host_copy(state):
        tree = {k: state[k] for k in ("params", "opt", "channel")}
        return {p: t.detach().cpu().clone() for p, t in zip(tree_paths(tree), tree_leaves(tree))}

    step_fn, channel = build_dist_train_step(cfg, tcfg, group)
    state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), 1, device=dev,
                             channel=channel, plane_layout=layout)
    losses_a, save_s = [], None
    for k in range(4):
        state, metrics = step_fn(state, batch(k))
        losses_a.append(float(metrics["loss"]))
        if k == 1:
            sync()
            t = time.perf_counter()
            host = gather_state(state, group)
            if lead:
                save_checkpoint(root, host, metadata={"n_nodes": group.world,
                                                      "channel_layout": "per-node"},
                                plane_layout=layout)
            del host
            save_s = time.perf_counter() - t
            dist.barrier(group=group.pg)
    straight = host_copy(state)
    del state
    torch.cuda.empty_cache()

    step_fn, channel = build_dist_train_step(cfg, tcfg, group)
    t = time.perf_counter()
    state = train._resume_ranks(group, root, cfg, channel, layout, True)
    sync()
    restore_s = time.perf_counter() - t
    losses_b = []
    for k in (2, 3):
        state, metrics = step_fn(state, batch(k))
        losses_b.append(float(metrics["loss"]))
    resumed = host_copy(state)
    del state
    torch.cuda.empty_cache()
    differ = sorted(set(straight) ^ set(resumed)) + [
        k for k in straight if k in resumed and not _same_bits(torch, straight[k], resumed[k])]
    verdicts = [None] * group.world
    dist.all_gather_object(verdicts, differ, group=group.pg)
    if not lead:
        return None
    return {"losses_a": losses_a, "losses_b": losses_b, "save_s": save_s,
            "restore_s": restore_s, "differ": verdicts, "tensors": sorted(straight),
            "gb": os.path.getsize(os.path.join(root, "step_00000002", "state.npz")) / 1e9}


def phase_dist_checkpoint_resume(torch):
    """Phase 17's algorithm at delay 1 on planes, qwen3-0.6b at full width, 2
    layers, 2 processes: 4 steps unbroken against 2 steps, a checkpoint
    (gathered to rank 0 and written), the trainer's resume (read on rank 0
    and scattered) and 2 more: losses, and every rank's parameters,
    optimizer and channel state (the ring and its count included) bit for
    bit; GB, save and restore seconds.  Then, on 4 processes,
    --failure-drill 4 -> 2 over 3 steps: finite losses, and the survivors' state after the shrink ==
    elastic_reshape of the gathered state bit for bit."""
    import shutil

    import repro_torch.launch.train as train
    from repro_torch.launch.mesh import run_ranks

    root = os.path.join(DIST_DIR, "ckpt")
    os.makedirs(DIST_DIR, exist_ok=True)
    free = shutil.disk_usage(HERE).free
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        rep = run_ranks(_dist_resume_rank, DIST_CKPT_RANKS, root, DIST_CKPT + ["--steps", "4"],
                        timeout_s=DIST_TIMEOUT_S)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if rep["losses_b"] != rep["losses_a"][2:] or any(rep["differ"]):
        raise RuntimeError(f"resumed losses {rep['losses_b']}, unbroken {rep['losses_a']}; "
                           f"tensors that differ per rank {rep['differ']}")
    chan = [k for k in rep["tensors"] if k.startswith("channel/")]
    log(f"phase 23: 2 layers, {DIST_CKPT_RANKS} processes, decentlam-sa at delay 1 on planes: "
        f"unbroken {rep['losses_a']} == 2 steps, save, resume, 2 steps {rep['losses_b']}; "
        f"every rank's final state bit for bit in all {len(rep['tensors'])} tensors "
        f"({len(chan)} of the channel: {chan}); {time.perf_counter() - t:.1f} s")
    log(f"  {rep['gb']:.2f} GB per checkpoint ({free / 1e9:.1f} GB free on the disk); save "
        f"(gather to rank 0, write) {rep['save_s']:.1f} s, restore (read on rank 0, scatter, "
        f"to the device) {rep['restore_s']:.1f} s")

    t = time.perf_counter()
    rc = train.main(DIST_CKPT + ["--steps", "3", "--failure-drill"], on_shrink=_check_shrink)
    n_tensors, differ, fresh = rc["on_shrink"]
    if (not all(map(math.isfinite, rc["losses"])) or rc["n_nodes"] != MAIN["nodes"] // 2
            or differ or not fresh):
        raise RuntimeError(f"drill: losses {rc['losses']} on {rc['n_nodes']} nodes, "
                           f"{differ[:5]} differ from elastic_reshape, channel fresh {fresh}")
    log(f"  --failure-drill {rc['drill']}: losses {rc['losses']} (finite), the survivors' "
        f"state == elastic_reshape of the gathered state bit for bit in {n_tensors} tensors, "
        f"the channel state re-initialized; {time.perf_counter() - t:.1f} s")
    shutil.rmtree(DIST_DIR, ignore_errors=True)

# ---------------------------------------------------------------------------
# The rest of the decoder zoo: MoE training, hybrid serving, the others (24-26)
# ---------------------------------------------------------------------------

# phase 24: granite-moe-1b-a400m at full width, cut to 12 of its 24 layers so
# that 4 stacked nodes fit on the card
MOE = dict(arch="granite-moe-1b-a400m", depth=12)
# its reckoned peak: phase 3 held 4 x 663,548,416 parameter-nodes in 49.50 GiB
# (~20 B each); 4 x 742,816,768 of them take ~55 GiB, plus the MoE activations
MOE_PEAK_GIB = 55.4
MOE_SPANS = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")
# phase 25: hymba-1.5b serving at full width and depth
HYBRID_ARCH = "hymba-1.5b"
# phase 26: the rest of the zoo at full width, cut to 4 layers
ZOO_TRAIN = ("olmo-1b", "internvl2-2b", "granite-moe-3b-a800m", "xlstm-350m")
ZOO_SERVE = "qwen3-8b"
ZOO_DEPTH = 4


def _moe_matmul_flops_per_step(cfg, n_nodes) -> float:
    """Forward + backward matmul FLOPs of one MoE step: the attention
    projections, the router, the expert products over every capacity slot
    (E x C rows, empty ones included, as they run), the lm_head, and
    attention's two S x S products; the backward is twice the forward."""
    from repro_torch.models.moe import moe_capacity

    d, hd, h, kv, f, E = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_experts
    b, s = MAIN["per_node_batch"], MAIN["seq_len"]
    T = b * s
    C = moe_capacity(cfg, T)
    mult = 3 if cfg.gated_mlp else 2
    per_layer = (2 * T * (d * h * hd * 2 + d * kv * hd * 2 + d * E) + 2 * E * C * mult * d * f
                 + 2 * 2 * b * h * s * s * hd)
    fwd = cfg.n_layers * per_layer + 2 * T * d * cfg.vocab_size
    return 3.0 * fwd * n_nodes


def _finite_run(res, what, moe=False):
    import math

    keys = ("losses", "xent", "moe_load_balance", "moe_router_z") if moe else ("losses",)
    for k in keys:
        if not all(math.isfinite(v) for v in res[k]):
            raise RuntimeError(f"{what}: non-finite {k} {res[k]}")


def _moe_layer_no_sync(torch, cfg):
    """One MoE layer's forward and backward at the main path's shape (one
    node's 4 x 256 tokens) with CUDA's sync debug mode at "error": the
    routing, dispatch and combine never wait on the host, so the step's
    launches queue ahead of the device."""
    from repro_torch.models.layers import Initializer
    from repro_torch.models.moe import moe_forward, moe_init

    gen = torch.Generator(device="cuda").manual_seed(24)
    params = {k: v.requires_grad_() for k, v in moe_init(Initializer(gen), cfg).items()}
    x = torch.randn(MAIN["per_node_batch"], MAIN["seq_len"], cfg.d_model, device="cuda",
                    generator=gen, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_forward(x, params, cfg)
        loss = out.square().mean() + aux["moe_load_balance"] + aux["moe_router_z"]
        torch.autograd.grad(loss, [x, *params.values()])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"phase 24: one {cfg.name} MoE layer forward + backward at {tuple(x.shape)} ran "
        "with no host sync (CUDA sync debug mode \"error\")")


def phase_moe_main_path(torch):
    """The MoE training main path: first one MoE layer with no host sync
    (:func:`_moe_layer_no_sync`); then granite-moe-1b-a400m at full width, 12
    of its 24 layers, 4 stacked nodes, decentlam on flat planes through the
    stage kernel, profiled as phase 3: finite losses and router terms,
    exactly 2 stage launches per step; step time, device busy, peak memory
    against the reckoning, the forward's time in the MoE layer's spans, and
    the two plane stages at its plane beside their bound.  Then at 4 layers,
    3 steps: the kernel (``--fused-impl triton``) and its plain version
    (``torch``) give the same losses and final state bit for bit, and so do
    two identical kernel runs (the combine is deterministic)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config(MOE["arch"]), n_layers=MOE["depth"])
    _moe_layer_no_sync(torch, cfg)
    res, launches, total, events, step_ms = _profiled_train(
        torch, ["--flat-planes"], arch=MOE["arch"], depth=MOE["depth"])
    steps = len(res["losses"])
    _finite_run(res, "the MoE main path", moe=True)
    if total != 2 * steps or launches != {op: steps for op in STAGE_FLOPS}:
        raise RuntimeError(f"MoE main path: fused_update launched {total} times ({launches}), "
                           f"want 2 x {steps}: one per bucket and stage")
    peak = res["peak_mem_bytes"] / 2**30
    tokens = MAIN["nodes"] * MAIN["per_node_batch"] * MAIN["seq_len"]
    log(f"phase 24: {MOE['arch']} full width, {cfg.n_layers} of 24 layers "
        f"({res['params_per_node']:,} params/node; {cfg.n_experts} experts, top-{cfg.top_k}) "
        f"x {res['n_nodes']} nodes, flat planes, {steps} steps: losses "
        f"{[round(v, 4) for v in res['losses']]}, xent {[round(v, 4) for v in res['xent']]}, "
        f"load balance {[round(v, 4) for v in res['moe_load_balance']]}, router z "
        f"{[round(v, 3) for v in res['moe_router_z']]}; fused_update launches {total} "
        f"(= 2 x {steps}: {launches})")
    log(f"  step {step_ms:.1f} ms (mean of the unprofiled steps 1..{MAIN['steps'] - 1}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB (reckoned "
        f"~{MOE_PEAK_GIB} GiB), step times {[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, events, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2,
                           flops=_moe_matmul_flops_per_step(cfg, MAIN["nodes"]))
    for span in MOE_SPANS:
        ms = _span_report(torch, events, span, "the forward, per step", 2)
        if ms is not None:
            log(f"    {span}: {ms / prof['busy_ms']:.1%} of the step's device time")
    del events
    torch.cuda.empty_cache()
    plane = phase_plane_timing(torch, cfg=cfg)
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"
    for op, p in plane.items():
        log(f"  plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms by {p['bound_by']} ({p['bytes'] / 1e9:.2f} GB; "
            f"{p['bound_ms'] / p['ms']:.1%} of it), plain version {p['plain_ms']:.3f} ms, "
            f"library {fmt(p['library_ms'])}, max |kernel - plain| {p['err']:.3g}")

    depth, n3 = 4, 3
    runs = {}
    for tag, impl in (("triton", "triton"), ("triton, again", "triton"), ("torch", "torch")):
        holder: dict = {}
        r = train.main(_train_argv(n3, impl, depth, MOE["arch"]) + ["--flat-planes"],
                       on_step=_last_state(holder))
        _finite_run(r, f"{MOE['arch']} at {depth} layers, {tag}", moe=True)
        st = holder.pop("state")
        runs[tag] = ({k: r[k] for k in ("losses", "xent", "moe_load_balance", "moe_router_z")},
                     {**{f"x/{k}": p for k, p in st["planes"].items()},
                      **{f"m/{k}": p for k, p in st["opt"]["m"].items()}})
        del st, holder
        torch.cuda.empty_cache()
    (base_metrics, base_state) = runs["triton"]
    for tag in ("triton, again", "torch"):
        metrics, state = runs[tag]
        same = metrics == base_metrics and sorted(state) == sorted(base_state) and all(
            _same_bits(torch, state[k], base_state[k]) for k in state)
        if not same:
            raise RuntimeError(f"{MOE['arch']} at {depth} layers: the {tag} run differs from "
                               f"the kernel run: {metrics} vs {base_metrics}")
    log(f"  {depth} layers, {n3} steps on planes: losses {base_metrics['losses']}; the plain "
        f"stage (--fused-impl torch) and a second kernel run equal the kernel run bit for bit "
        f"(losses, xent, router terms, final parameter and momentum planes)")
    del runs, base_state
    torch.cuda.empty_cache()
    return {"launches": launches, "plane": plane, "step_ms": step_ms, "peak": peak,
            "busy_ms": prof["busy_ms"]}


def phase_hybrid_serve_main_path(torch):
    """The hybrid serving main path: hymba-1.5b at full width and depth (32
    layers: sliding window 1024 on 29, full attention on layers 0, 16 and
    31) behind the engine with the flash kernel, the 16 requests of SERVE:
    every request completes, exactly 32 launches per prefill wave; prefill,
    decode, tokens/s, peak memory and the SSM branch's share of the device
    time.  Then at 4 layers (global layers cut to those below 4: layer 0),
    the kernel path against the plain path as in phase 8."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches

    cfg = get_config(HYBRID_ARCH)
    windows = [cfg.window_for_layer(i) for i in range(cfg.n_layers)]
    log(f"phase 25: {HYBRID_ARCH}: {cfg.n_heads}/{cfg.n_kv_heads} heads at hd {cfg.hd}, "
        f"window {cfg.sliding_window} on {sum(w > 0 for w in windows)} layers, full attention "
        f"on layers {[i for i, w in enumerate(windows) if w == 0]}; SSM d_inner {cfg.d_ssm}, "
        f"state {cfg.ssm_state}")

    def share(events, steps, what):
        _, busy = _device_kernels(torch, events)
        ms = _span_report(torch, events, "ssm_forward", what, steps)
        if ms is not None:
            log(f"    the SSM branch: {ms * steps / busy:.1%} of the device time")

    launches = _serve_main_path(
        torch, cfg, 25, flash_attention_launch, reset_launches, cfg.n_layers,
        lambda ev: share(ev, 1, "the SSM branch of every layer, one prefill wave"),
        lambda ev: share(ev, 2, "the SSM branch of every layer, per decode step"),
        attn_impl="cuda")
    _serve_kernel_vs_plain(torch, 25, HYBRID_ARCH, 4, "attn_impl", flash_attention_launch,
                           reset_launches, 4, "full width, 4 layers (global layers cut to "
                           "layer 0)")
    return launches


def phase_zoo(torch):
    """The rest of the zoo at full width, cut to 4 layers: 3 training steps of
    4 stacked nodes on planes through the stage kernel for olmo-1b,
    internvl2-2b, granite-moe-3b-a800m and xlstm-350m (finite losses, 2
    launches per step); qwen3-8b serving with the flash kernel at hd 128
    against the plain path, as in phase 8."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_flash
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train

    n3 = 3
    for arch in ZOO_TRAIN:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = train.main(_train_argv(n3, "triton", ZOO_DEPTH, arch) + ["--flat-planes"])
        wall = time.perf_counter() - t0
        moe = "moe" in arch
        _finite_run(res, f"{arch} at {ZOO_DEPTH} layers", moe=moe)
        total = fused_stage_launch.launches
        if total != 2 * n3:
            raise RuntimeError(f"{arch}: fused_update launched {total} times, want 2 x {n3}")
        log(f"phase 26: {arch} full width, {ZOO_DEPTH} layers ({res['params_per_node']:,} "
            f"params/node) x {res['n_nodes']} nodes, flat planes, {n3} steps: losses "
            f"{[round(v, 4) for v in res['losses']]}"
            + (f", load balance {[round(v, 4) for v in res['moe_load_balance']]}" if moe
               else "")
            + f"; fused_update launches {total}; step {res['step_s'] * 1e3:.1f} ms, peak "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; {wall:.1f}s")
        del res
        torch.cuda.empty_cache()
    _serve_kernel_vs_plain(torch, 26, ZOO_SERVE, ZOO_DEPTH, "attn_impl", flash_attention_launch,
                           reset_flash, ZOO_DEPTH, f"full width, {ZOO_DEPTH} layers (hd 128)")


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
    from repro_torch.kernels.flash_attention.kernel import build as build_flash
    from repro_torch.kernels.mlstm_chunk.kernel import build as build_mlstm

    t0 = time.perf_counter()
    phases = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(torch, *args)
        phases[name] = round(time.perf_counter() - t, 1)
        return out

    def build_timed(build):
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    # nvcc builds the two CUDA kernels, one process each, while the Triton
    # phases run
    with ThreadPoolExecutor(2) as pool:
        fa_built = pool.submit(build_timed, build_flash)
        ml_built = pool.submit(build_timed, build_mlstm)
        timed("1 device", phase_device)
        timed("2 fused_update vs plain", phase_kernel_vs_plain)
        main_path = timed("3 train main path", phase_main_path)
        timed("4 train kernel vs plain path", phase_plain_vs_kernel_path)
        per_stage = timed("5 fused_update timing", phase_timing)
        fa_built, ml_built = fa_built.result(), ml_built.result()
    timed("6 flash_attention vs plain", phase_flash_vs_plain, fa_built)
    fa_launches = timed("7 serve main path", phase_serve_main_path)
    timed("8 serve kernel vs plain path", phase_serve_kernel_vs_plain)
    fa = timed("9 flash_attention timing", phase_flash_timing)
    timed("10 mlstm_chunk vs plain", phase_mlstm_vs_plain, ml_built)
    ml_launches = timed("11 xlstm serve main path", phase_xlstm_serve_main_path)
    timed("12 xlstm kernel vs plain path", phase_xlstm_kernel_vs_plain)
    ml = timed("13 mlstm_chunk timing", phase_mlstm_timing)
    timed("14 plane fused_update vs plain", phase_plane_kernel_vs_plain)
    flat = timed("15 flat-plane train main path", phase_flat_planes_main_path, main_path,
                 per_stage)
    timed("16 serve while training", phase_serve_while_training)
    stale = timed("17 staleness train main path", phase_staleness_main_path, flat)
    timed("18 compressed gossip train main path", phase_compressed_main_path, flat)
    timed("19 gossip kernel vs plain path", phase_gossip_kernel_vs_plain)
    timed("20 checkpoint and resume", phase_checkpoint_resume)
    timed("21 distributed train main path", phase_dist_main_path, flat)
    timed("22 distributed vs stacked", phase_dist_vs_stacked)
    timed("23 distributed checkpoint, resume, drill", phase_dist_checkpoint_resume)
    moe = timed("24 MoE train main path", phase_moe_main_path)
    hy_launches = timed("25 hybrid serve main path", phase_hybrid_serve_main_path)
    timed("26 the rest of the zoo", phase_zoo)
    log(f"phase times (s): {phases}; total {time.perf_counter() - t0:.1f}s")
    # one record per specialization of the Triton kernel on the training main
    # path (times per step, summed over the 14 leaves), and the flash and
    # mLSTM kernels at their serve main paths' prefill shapes (times per call)
    records = [{
        "name": f"fused_update[{op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": main_path["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in per_stage.items()]
    # the flat-plane path: one launch per stage and step over the whole
    # (4, 648000, 1024) plane (phase 15)
    records += [{
        "name": f"fused_update[plane {op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": flat["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in flat["plane"].items()]
    # the staleness path's post stage with sg per node (SG_COL), phase 17
    sa = stale["sa"]
    records.append({
        "name": "fused_update[plane decentlam_sa_post, sg per node]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": stale["launches"]["decentlam_sa_post"],
        "max_abs_err": sa["err"],
        "ms": sa["ms"],
        "plain_ms": sa["plain_ms"],
        "bound_ms": sa["bound_ms"],
        "bound_by": sa["bound_by"],
        "library_ms": sa["library_ms"],
    })
    # the MoE main path's plane stages (phase 24): granite-moe-1b-a400m, 12
    # layers, 4 nodes
    records += [{
        "name": f"fused_update[{MOE['arch']} plane {op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": moe["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in moe["plane"].items()]
    fa, hy = fa["qwen3-0.6b prefill"], fa["hymba-1.5b prefill"]
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
    records.append({
        "name": "mlstm_chunk[f32, dk = dv = 512, chunk 128]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:99",
        "launches": ml_launches,
        "max_abs_err": ml["err"],
        "ms": ml["ms"],
        "plain_ms": ml["plain_ms"],
        "bound_ms": ml["bound_ms"],
        "bound_by": ml["bound_by"],
        "library_ms": ml["library_ms"],
    })
    # the hybrid serve main path (phase 25): every layer's launch counts; the
    # time is at its sliding-window layers' prefill shape (phase 9)
    records.append({
        "name": "flash_attention[hymba-1.5b prefill: causal, window 1024, f32, hd 64, 25/5 heads]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": hy_launches,
        "max_abs_err": hy["err"],
        "ms": hy["ms"],
        "plain_ms": hy["plain_ms"],
        "bound_ms": hy["bound_ms"],
        "bound_by": hy["bound_by"],
        "library_ms": hy["library_ms"],
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
