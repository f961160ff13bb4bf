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
   {1, 2, 4} x hd {32, 64, 80, 128} x ragged Sq, Sk in {1, 77, 300} x {f32,
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
20. checkpoint and resume at full width with the vocabulary cut to
    ``CHECK_VOCAB`` (as in phases 22, 23 and 32), 2
    layers, 2 nodes, delay 1 and
    int8-row-ef on planes: a resumed run == an unbroken one bit for bit,
    channel state included; the step-2 checkpoint resumed without
    ``--flat-planes`` equals the saved planes unpacked and trains on; GB,
    save and restore seconds (under ``build/ckpt_smoke``, removed after);
21. one process per node: phase 15's run with ``--simulate-nodes 4
    --gossip-impl ppermute``, 4 ranks sharing the card over gloo (every
    message staged through pinned host memory), 2 steps: finite losses,
    exactly 2 stage launches per rank and step (the plane stage at a node
    axis of 1), the step-0 loss equal to phase 15's to 1e-5 relative; the
    backend, step time, gossip seconds per round, staged GB/s, each rank's
    peak memory and the card's; the plane stages at one rank's (1, 648000,
    1024) beside phase 15's tail;
22. at 4 layers (the vocabulary cut), 2 steps, in one spawned group of 4
    ranks: the distributed
    step against the stacked step for ppermute, allgather, decentlam-sa at
    delay 1, pmsgd (the psum mean), da-dmsgd and bf16 messages (the
    reference's distributed-vs-oracle tolerances), int8-row-ef and top-k
    (finite, egress telemetry), then bit for bit on every rank: planes ==
    per leaf, ``--fused-impl triton`` == ``torch``, delay 0 == undelayed
    for every algorithm;
23. checkpoint, resume and the drill, 2 layers, decentlam-sa at delay 1 on
    planes: on 2 ranks (the vocabulary cut) a resumed run == an unbroken one bit
    for bit on every rank, the ring included; GB, save and restore seconds;
    on 4 ranks at full width (the vocabulary cut too) through the CLI's rank
    body with ``--failure-drill`` 4 -> 2: finite losses, the survivors'
    state == ``elastic_reshape`` of the gathered state bit for bit (files under
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
    the plain path as in phase 8;
27. whisper-tiny (the encoder-decoder) at full width and depth (4 + 4
    layers, d 384, 1500 encoder frames; its engine refuses it, as the
    reference's does, so it runs through the train-step API and prefill +
    decode_step; phase 40 trains it through the CLI): 3 training steps of 4 stacked nodes on flat planes with
    seeded ``enc_frames``, exactly 2 stage launches per step, the plain
    stage == the kernel bit for bit; 8 requests of 224 prompt tokens and 32
    new with the flash kernel, exactly 12 launches per prefill wave (the
    encoder's 4 non-causal, the decoder's 4 causal and 4 cross-attention at
    Sk 1500), token for token against the plain path; the stage kernel at
    its plane beside its bound;
28. ResNet-20 through ``run_stacked``: 4 nodes of DecentLaM, 128 seeded
    images each, 20 steps: the loss falls, the run equals its repeat bit
    for bit (deterministic cuDNN, TF32 off);
29. the paper's bias experiments on the card (App. G.2 linear regression,
    the reference tests' bounds for Fig. 2, Props. 1-3 and the gamma^2
    scaling) and the simulator's bitwise claims (event engine ==
    run_stacked for every algorithm; vectorized == per-node on
    straggler_1slow; with ``SimSpec(sparse=exact|delta)``: every row
    touched == dense gossip in both engines, and vectorized == per-node
    under gradients that touch a third of the rows);
30. row-sparse gossip, one process per node: 4 ranks sharing the card over
    gloo, qwen3-0.6b at full width cut to 2 layers, decentlam on exp,
    planes, through ``build_dist_train_step``: exact mode and delta mode;
    per step and rank the dirty fraction, ``vol``'s sparse and dense bytes,
    the bytes sent and staged, gossip seconds, step time, peak memory; one
    dense round on exact mode's trained planes beside them; exact mode's
    clean rows at their initial bits on every rank, the plain stage == the
    kernel (planes, momentum, mask) and every row dirty == the dense
    channel, bit for bit; 2 stage launches per rank and step; the stage kernel at
    one rank's plane beside its bound;
31. the fault-tolerant runtime on phase 15's run (full width and depth, 4
    stacked nodes, planes): an empty ChaosSchedule and ``--resilient``
    without faults == the unwrapped run bit for bit over 3 steps; one
    gossip round alone with and without the resilient layer; 16 steps of
    node 1 silenced for steps 2..13 under the resilient layer and the host
    health loop (the monitor's states per step, node 1 distrusted while
    SUSPECT or DEAD, one round's healed mix on a slice == healed_W @ x in
    float64, node 1 rejoining from a materialized snapshot of node 0:
    plane == snapshot, momentum zero, losses finite after), and in the same
    run a NaN round from node 2 quarantined with every parameter finite; 2
    launches per step; at 4 layers the plain stage == the kernel under
    faults;
32. chaos and the resilient layer on 4 ranks over gloo, 2 layers (the
    vocabulary cut), 4 steps,
    with the CLI's schedule parser and health loop: the gathered sender
    gaps and the monitor's states == the stacked run's, the final
    parameters and optimizer state within the reference's
    distributed-vs-oracle tolerance of it (in phase 30's spawned group,
    which runs before phase 31);
33. tensor-parallel serving: qwen3-0.6b at full width and depth behind the
    engine on a (1 x 2) grid, 2 ranks sharing the card over gloo (every
    model-group collective staged through host memory), f32, the flash
    kernel at each rank's local heads; 8 slots, 8 requests of 256..2048
    prompt tokens, 16 new: the first wave's logits and the first 4 decode
    steps' against the tp = 1 engine on the same weights at 5e-4 relative,
    both ranks' tokens equal, 28 flash launches per wave on each rank;
    prefill and decode ms, the collectives' seconds and staged bytes per
    decode step, peak memory per rank and the card's;
34. tensor-parallel training: qwen3-0.6b at full width and depth, 2 nodes x
    tp 2 = 4 ranks over gloo, planes, decentlam on exp, 2 steps through the
    CLI's rank body: grad_step and decentlam_post each launched once per
    rank and step (counted by op after every step), each rank's shard
    of its node's final parameters against the tp = 1 one-process-per-node
    run on 2 ranks (same spawned group, read through CUDA IPC) within 1e-5
    of scale; step time, gossip seconds per round, the collectives' seconds
    and staged bytes per step, peak memory;
35. ``--simulate-nodes 2 --serve-while-training`` at 4 layers (the
    vocabulary cut): every shipped snapshot == node 0's parameters bit for
    bit, every request served;
36. the cost stack (``repro_torch.launch``, ``repro_torch.sim.wallclock``):
    the cost model over one of phase 15's steps (product FLOPs within 2 % of
    the shapes' formula, stage units == the launch counter's 2, the roofline
    terms at the f32 peak, MODEL_FLOPS' share of it in phase 15's step) and
    over one prefill wave of phase 7's engine (28 flash units == 28
    launches, their FLOPs == ``work``'s); the meta dry run of qwen3-0.6b
    train_4k on pod1 and decode_32k on pod2; a 1 x 1 grid at phase 15's
    per-node shape, its tracked peak within [0.5, 2] of one real step's
    ``max_memory_allocated``; phase 29's straggler run on the wall clock,
    calibrated by phase 15's step (exactly sim_time x the step);
37. tensor-parallel MoE training: one granite-moe-1b-a400m MoE layer at a
    tp 2 rank's shard (16 of 32 experts) forward and backward with no host
    sync between its collectives; then 2 nodes x tp 2 at full width, 12 of
    24 layers, through the CLI's rank body with phase 34's gates against
    the tp 1 run on 2 ranks;
38-40. tensor parallelism for the rest of the zoo, on 2 ranks sharing the
    card over gloo, each against tp 1 on the same weights: xlstm-350m (38)
    and hymba-1.5b (39) at full width and depth behind the engine at tp 2
    (the first wave's logits and 4 decode steps at 5e-4 relative, the same
    tokens on both ranks, 20 mlstm_chunk / 32 flash launches a wave and
    rank; the mLSTM kernel at a rank's dv 256 against its plain version and
    timed); internvl2-2b's prefill with 256 patch embeddings and 4 decode
    steps at tp 2 (5e-4; one flash launch a layer) and whisper-tiny trained
    at 1 node x tp 2 through the CLI with phase 34's gates (40);
41. the tensor-parallel checkpoint and drill: phase 23's arguments at
    ``--tp 2`` on a 2 x 2 grid of 4 ranks through the CLI's rank body: 4
    steps unbroken against 2 steps, save, ``--resume``, 2 steps (the losses
    and every rank's tensors bit for bit, the channel's ring and ``count``
    included), then ``--failure-drill`` 2 x 2 -> 1 x 2 (finite losses, the
    survivors' state == ``elastic_reshape`` of the gathered state bit for
    bit, the channel re-initialized, the leaving ranks' records);
42. the five examples of the port (``examples/torch_*.py``) through their
    ``main`` on the card: bias_demo (the reference tests' bounds),
    sim_cluster (the H100 projection), quickstart (DecentLaM's consensus
    distance below DmSGD's), train_lm (8 ranks, the drill 8 -> 4) and
    serve_lm (a 4 x 2 grid of 8 ranks: every request, the same tokens on
    every rank, flash launched on every rank).

Phases 6 and 9 also run flash at whisper-tiny's two non-causal shapes
(the encoder's 1500 x 1500, the cross-attention's 224 x 1500), and phase 9
at the tp 2 rank shapes of phases 33, 39, 40 and 42 (hd 32).  The line before the last
is the per-kernel JSON record (the stage kernel on the per-leaf, plane,
staleness, MoE, whisper and row-sparse paths and on tp 2 rank planes of
qwen3-0.6b, granite-moe and whisper; flash on the qwen3-0.6b, hymba-1.5b
and whisper-tiny serve paths and at tp 2 ranks of qwen3-0.6b, hymba-1.5b,
internvl2-2b and the serve_lm example; mLSTM on xlstm-350m's, whole and at
a tp 2 rank's dv);
the last
line is
``{"ok": true, "device": {...}}``.  Triton kernels compile at first use into
``build/triton`` inside the checkout; the two CUDA kernels are built by nvcc
into ``build/cuda``, one nvcc each, both started at once while phases 2-5
run.  The profiles are read from the profiler's raw events (``_Trace``),
held against torch's own parse on every serve path's two decode steps.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
# The H100's rates (repro_torch.launch.roofline), the kernels' work (each
# kernel module's ``work``, the stage kernel's ``STAGE_FLOPS``) and their
# bounds (``roofline.kernel_bound``) come from the package.  The main path's
# update tail runs two stages, grad_step and decentlam_post
TAIL_OPS = ("grad_step", "decentlam_post")
# kernel vs plain version, same inputs: float32 outputs differ by FMA
# contraction (about one ulp); a bfloat16 x output may then round one bf16
# ulp (2**-8) apart
F32_TOL = 2e-6
BF16_TOL = 1e-2
# loss trajectories, kernel vs plain tail, 3 steps at 4 layers
LOSS_RTOL = 1e-5
MAIN = dict(nodes=4, arch="qwen3-0.6b", steps=5, seq_len=256, per_node_batch=4)
# flash attention at the main path's shapes, (B, Sq, Sk, H, Hkv, hd, window,
# causal): the qwen3-0.6b prefill wave of the serve main path, h2o-danube-1.8b
# (hd 80) at a length where its 4096 window cuts in, the hymba-1.5b prefill
# wave of phase 25 (a GQA group of 5) on its 29 sliding-window layers, and
# whisper-tiny's prefill wave of phase 27: its encoder, non-causal over 1500
# frames (no multiple of any tile), and its decoder's cross-attention,
# non-causal, the prompt's 224 queries against the 1500 encoder keys
WHISPER = dict(arch="whisper-tiny", nodes=4, per_node_batch=4, seq_len=256, steps=3,
               slots=8, prompt=224, new=32)
FA_MAIN_SHAPES = {"qwen3-0.6b prefill": (8, 2048, 2048, 16, 8, 64, 0, True),
                  "h2o-danube-1.8b": (1, 4608, 4608, 32, 8, 80, 4096, True),
                  "hymba-1.5b prefill": (8, 2048, 2048, 25, 5, 64, 1024, True),
                  "whisper-tiny encoder": (8, 1500, 1500, 6, 6, 64, 0, False),
                  "whisper-tiny cross": (8, WHISPER["prompt"], 1500, 6, 6, 64, 0, False),
                  # one rank of phase 33's tp 2: its 8 q heads over its 4 kv heads
                  "qwen3-0.6b prefill, a tp 2 rank": (8, 2048, 2048, 8, 4, 64, 0, True),
                  # a rank of phase 39: 13 of hymba's 26 padded q heads, the
                  # replicated kv expanded per head (local_kv), window 1024
                  "hymba-1.5b prefill, a tp 2 rank": (8, 2048, 2048, 13, 13, 64, 1024, True),
                  # a rank of phase 40: 8 of internvl2's 16 q heads over 4 kv
                  # heads, hd 128, the 512-token prompt
                  "internvl2-2b prefill, a tp 2 rank": (8, 512, 512, 8, 4, 128, 0, True),
                  # a rank of phase 42's torch_serve_lm: its node's 2 of the 8
                  # slots, 2 of the 4 q heads over 1 of 2 kv heads, hd 32, the
                  # 24-token prompts
                  "serve_lm example, a (4 x 2) rank": (2, 24, 24, 2, 1, 32, 0, True)}
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


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def phase_device(torch):
    smi = _smi()
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
    Returns ``(result, launches by op, total launches, the profiled steps'
    :class:`_Trace`, unprofiled step ms)``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train

    steps, timed = MAIN["steps"] + 3, slice(1, MAIN["steps"])
    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=MAIN["steps"], warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: traced.append(_Trace(torch, p))) as prof:
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

    res, launches, total, trace, step_ms = _profiled_train(torch)
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the main path: {res['losses']}")
    if total != 28 * steps or launches != {op: 14 * steps for op in TAIL_OPS}:
        raise RuntimeError(f"fused_update launched {total} times ({launches}), "
                           f"want 28 x {steps}: 14 x {steps} of each of {list(TAIL_OPS)}")
    log(f"phase 3: qwen3-0.6b full width ({res['params_per_node']:,} params/node, "
        f"{res['n_layers']} layers) x {res['n_nodes']} nodes, {steps} steps: "
        f"losses {[round(v, 4) for v in res['losses']]}, fused_update launches {total} "
        f"(= 28 x {steps}: {launches})")
    tokens = MAIN["nodes"] * MAIN["per_node_batch"] * MAIN["seq_len"]
    log(f"main path: step {step_ms:.1f} ms (mean of the unprofiled steps "
        f"1..{MAIN['steps'] - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, step times "
        f"{[round(t, 4) for t in res['step_times_s']]}")
    prof = _profile_report(torch, trace, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
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
# the model's profiler spans (models/xlstm.py, ssm.py, moe.py)
TRACE_SPANS = ("slstm_recurrence", "ssm_forward", "moe_router", "moe_dispatch", "moe_experts",
               "moe_combine")


class _Trace:
    """One profiler window, read from the profiler's raw (Kineto) events:
    every device event, and the start and thread of each synchronous CPU
    op, by correlation id.  ``prof.events()`` builds a tree of Python
    objects over every event first: tens of seconds a window on a prefill
    wave or two training steps (10^5 launches), where this takes a few.
    Names are demangled as ``prof.events()`` demangles them."""

    def __init__(self, torch, prof):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        names: dict[str, str] = {}

        def name(e):
            raw = e.name()
            if raw not in names:
                names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
            return names[raw]

        self.device = []  # (name, ms, linked correlation id)
        self.ops = {}     # correlation id -> (thread, start ns)
        self.cpu = []     # (name, thread, start ns, end ns)
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            kind = e.device_type()
            if kind == cuda:
                self.device.append((name(e), (e.end_ns() - e.start_ns()) / 1e6,
                                    e.linked_correlation_id()))
            elif kind == cpu and not e.is_async() and e.start_thread_id() == e.end_thread_id():
                thread, start = e.start_thread_id(), e.start_ns()
                if e.linked_correlation_id() == 0:
                    self.ops[e.correlation_id()] = (thread, start)
                self.cpu.append((name(e), thread, start, e.end_ns()))


def _device_kernels(torch, trace):
    """``({kernel name: [launches, ms]}, busy ms)`` from a :class:`_Trace`."""
    kernels: dict[str, list] = {}
    for name, ms, _ in trace.device:
        if not name.startswith(ANNOTATIONS):
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += ms
    busy = sum(v[1] for v in kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return kernels, busy


def _parsed_kernels(torch, events):
    """:func:`_device_kernels` from ``prof.events()`` (torch's own parse):
    what :func:`_check_trace` holds the raw reading against."""
    kernels: dict[str, list] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(
                ANNOTATIONS):
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    return kernels


def _profile_report(torch, trace, step_ms, profiled_ms, flops=None):
    """Where a main-path step's device time goes, from the profiler's
    :class:`_Trace` of 2 steps, against the unprofiled step time ``step_ms``; ``flops`` is
    the step's matmul work (default: the qwen3-0.6b main path's)."""
    from repro_torch.configs import get_config

    kernels, busy = _device_kernels(torch, trace)
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
        STAGE_FLOPS,
        fused_stage_launch,
        stage_bytes,
        stage_plain,
    )
    from repro_torch.launch.roofline import F32_FLOP_PER_S, kernel_bound
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
                 for op in TAIL_OPS}
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
        bound_ms, by = kernel_bound(nbytes, flops)
        log(f"largest leaf {paths[big]} {shapes[big]} f32, {op}: kernel {ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms by {by} ({nbytes / 1e9:.2f} GB / 3.35 TB/s; "
            f"{flops / 1e9:.2f} GFLOP / 67 TFLOP/s = {flops / F32_FLOP_PER_S * 1e3:.3f} ms; "
            f"{bound_ms / ms:.1%} of bound), plain version {plain_ms:.3f} ms, "
            f"library {fmt(lib_ms)}")
    for op, rec in per_stage.items():
        rec["bound_ms"], rec["bound_by"] = kernel_bound(rec["bytes"], rec["flops"])
        log(f"per step, {op} over 14 leaves x 4 nodes: kernel {rec['ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} ({rec['bytes'] / 1e9:.2f} GB, "
            f"{rec['flops'] / 1e9:.2f} GFLOP), plain version {rec['plain_ms']:.3f} ms, "
            f"library {fmt(rec['library_ms'])}, max |kernel - plain| {rec['err']:.3g}")
    total = {k: sum(r[k] for r in per_stage.values())
             for k in ("ms", "plain_ms", "bytes", "flops")}
    bound_ms, by = kernel_bound(total["bytes"], total["flops"])
    log(f"per step, update tail (28 launches): kernel {total['ms']:.3f} ms, bound "
        f"{bound_ms:.3f} ms by {by}, plain version {total['plain_ms']:.3f} ms")
    return per_stage


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


def _fa_bound(q, k, causal, window):
    """The work of one call (:func:`~repro_torch.kernels.flash_attention.kernel.work`)
    and its bounds: "tc" the tensor-core bound the kernel is held to
    (3xTF32 in f32), "ffma" the f32 FFMA bound of the SIMT kernel it
    replaced."""
    from repro_torch.kernels.flash_attention.kernel import work
    from repro_torch.launch.roofline import kernel_bound

    flops, nbytes = work(q.shape, k.shape, q.dtype, causal, window)
    return {"flops": flops, "bytes": nbytes,
            "tc": kernel_bound(nbytes, flops, q.dtype, tensor_cores=True),
            "ffma": kernel_bound(nbytes, flops)}


def phase_flash_vs_plain(torch, built):
    import itertools

    _report_build(6, "flash_attention", built, ("flash_fwd_kernel",))
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    t0 = time.perf_counter()
    lengths = (1, 77, 300)
    for causal, window, group, hd, sq, sk, dt in itertools.product(
            (True, False), (0, 100), (1, 2, 4), (32, 64, 80, 128), lengths, lengths,
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
    for name, (b, sq, sk, h, hkv, hd, window, causal) in FA_MAIN_SHAPES.items():
        q, k, v = _fa_inputs(torch, b, sq, sk, h, hkv, hd, torch.float32, gen)
        main_err[name] = _fa_compare(torch, q, k, v, causal, window, name)
        del q, k, v
        torch.cuda.empty_cache()
    log(f"phase 6: flash_attention kernel == plain version on {n} cases (causal x window "
        f"{{0, 100}} x group {{1, 2, 4}} x hd {{32, 64, 80, 128}} x Sq, Sk in {lengths} x "
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


def _serve_profile(torch, trace, what, wall_ms, steps):
    """Device busy share and time by class of ``steps`` serve calls."""
    kernels, busy = _device_kernels(torch, trace)
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
    (``profile_extra(trace)`` adds to its report, a :class:`_Trace`) and two
    decode steps (``decode_extra(trace)`` likewise; their raw reading held
    against ``prof.events()``, :func:`_check_trace`).  Returns the kernel's launches in
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
    trace = _Trace(torch, prof)
    _serve_profile(torch, trace, f"one {cfg.name} prefill wave", wave_ms, 1)
    if profile_extra is not None:
        profile_extra(trace)
    del trace, prof
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
    trace = _Trace(torch, prof)
    _serve_profile(torch, trace, f"two {cfg.name} decode steps", steps_ms, 2)
    _check_trace(torch, prof, trace, f"two {cfg.name} decode steps")
    if decode_extra is not None:
        decode_extra(trace)
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
    h2o-danube's windowed shape; whisper-tiny's two non-causal ones): its
    time, bound, plain version and SDPA.  Returns a record per shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.launch.roofline import HBM_BYTES_PER_S

    gen = torch.Generator(device="cuda").manual_seed(4)
    smi = _smi()
    recs = {}
    for name, (b, sq, sk, h, hkv, hd, window, causal) in FA_MAIN_SHAPES.items():
        q, k, v = _fa_inputs(torch, b, sq, sk, h, hkv, hd, torch.float32, gen)
        want = reference_attention(q, k, v, causal=causal, window=window)
        got = flash_attention_launch(q, k, v, causal=causal, window=window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window:  # SDPA takes the window as a boolean mask (Sq == Sk here)
            i = torch.arange(sq, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                         enable_gqa=True)
        lib_out = lib().transpose(1, 2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lib_err = float((lib_out - want).abs().max())
        if not (err <= FA_TOL["float32"] and lib_err <= FA_TOL["float32"]):
            raise RuntimeError(f"{name}: kernel {err:.3g} / SDPA {lib_err:.3g} from the plain "
                               f"version (tol {FA_TOL['float32']})")
        del got, want, lib_out
        ms = _time_ms(torch, lambda: flash_attention_launch(q, k, v, causal=causal,
                                                            window=window), 10)
        plain_ms = _time_ms(torch, lambda: reference_attention(q, k, v, causal=causal,
                                                               window=window), 3)
        lib_ms = _time_ms(torch, lib, 10)
        bd = _fa_bound(q, k, causal, window)
        (bound_ms, by), (ffma_ms, _) = bd["tc"], bd["ffma"]
        flops, nbytes = bd["flops"], bd["bytes"]
        log(f"phase 9: flash_attention at {name} {tuple(q.shape)} q, {tuple(k.shape)} k/v, "
            f"{'causal' if causal else 'non-causal'}, window {window}, f32 ({smi}): kernel "
            f"{ms:.3f} ms ({flops / ms / 1e9:.1f} "
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


def _span_totals(trace, span):
    """``(spans, device ms, launches)`` of the kernels launched inside the
    profiler span ``span``: those whose launching op started within one of
    the span's CPU ranges, on its thread (the span's own device annotation
    left out)."""
    import bisect

    ranges: dict[int, list] = {}
    for name, thread, start, end in trace.cpu:
        if name == span:
            ranges.setdefault(thread, []).append((start, end))
    for r in ranges.values():
        r.sort()
    starts = {t: [s for s, _ in r] for t, r in ranges.items()}
    ms = n = 0
    for name, kms, corr in trace.device:
        op = trace.ops.get(corr)
        if op is None or op[0] not in ranges or name.startswith(ANNOTATIONS):
            continue
        i = bisect.bisect_right(starts[op[0]], op[1]) - 1
        if i >= 0 and op[1] <= ranges[op[0]][i][1]:
            ms, n = ms + kms, n + 1
    return sum(map(len, ranges.values())), ms, n


def _parsed_span_totals(torch, events, span):
    """:func:`_span_totals` from ``prof.events()``'s tree of CPU ops."""
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
    return len(spans), ms, n


def _check_trace(torch, prof, trace, what):
    """The raw reading against torch's own parse of the same (small)
    window: every device kernel's launches and time, and each span's."""
    events = prof.events()

    def close(a, b):  # counts exactly, milliseconds to 1e-6
        return len(a) == len(b) and all(
            abs(x - y) <= 1e-6 * (1.0 + abs(x)) if isinstance(x, float) else x == y
            for x, y in zip(a, b))

    want, (got, _) = _parsed_kernels(torch, events), _device_kernels(torch, trace)
    bad = sorted(k for k in set(want) | set(got)
                 if k not in want or k not in got or not close(want[k], got[k]))
    spans = sorted({e.name for e in events if e.name in TRACE_SPANS})
    bad += [s for s in spans
            if not close(_parsed_span_totals(torch, events, s), _span_totals(trace, s))]
    if bad:
        raise RuntimeError(f"{what}: the raw profiler reading differs from prof.events() on "
                           f"{bad[:5]}")
    log(f"  ({what}: the raw profiler reading == prof.events() on {len(want)} kernels and "
        f"the spans {spans})")


def _span_report(torch, trace, span, what, steps):
    """Device time and launches of the kernels launched inside the profiler
    span ``span`` (:func:`_span_totals`); returns the device ms per call
    (None where not measured)."""
    spans, ms, n = _span_totals(trace, span)
    if not spans or ms <= 0.0:
        log(f"  {span}: not measured (the profiler attributed no device time to "
            f"{spans} spans)")
        return None
    log(f"  of which inside the {spans // steps} {span} spans per call ({what}): "
        f"{ms / steps:.2f} ms device time, {n // steps} launches")
    return ms / steps


def phase_xlstm_serve_main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch, reset_launches
    from repro_torch.models import transformer as T

    cfg = get_config(XSERVE_ARCH)

    def extra(trace):
        # the projections: the matmul kernels with few launches (the sLSTM's
        # per-step recurrent products launch thousands of times)
        kernels, _ = _device_kernels(torch, trace)
        big = {n: v for n, v in kernels.items() if _kernel_class(n) == "matmul (cuBLAS)"
               and v[0] < 1000}
        big_ms = sum(v[1] for v in big.values())
        flops = _xlstm_matmul_flops(cfg, SERVE["slots"] * SERVE["max_prompt"])
        log(f"  projection matmuls: {flops / 1e12:.2f} TFLOP per wave (from the shapes) in "
            f"{big_ms:.1f} ms of {sum(v[0] for v in big.values())} launches: "
            f"{flops / big_ms / 1e9:.1f} TFLOP/s of the 67 f32 peak")
        _span_report(torch, trace, "slstm_recurrence", "the sLSTM layers' time loops", 1)
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
    """The work of one call (:func:`~repro_torch.kernels.mlstm_chunk.kernel.work`:
    the causal triangle of the scores and of w.v per chunk) and its bounds:
    "tc" the tensor-core bound the kernel is held to (3xTF32 in f32), "ffma"
    the f32 FFMA bound of the SIMT kernel it replaced; beside them the
    recurrent form's operations, the least work the cell can be done in."""
    from repro_torch.kernels.mlstm_chunk.kernel import recurrent_flops, work
    from repro_torch.launch.roofline import kernel_bound

    flops, nbytes = work(q.shape, v.shape, q.dtype, chunk)
    return {"flops": flops, "bytes": nbytes, "rec_flops": recurrent_flops(q.shape, v.shape),
            "tc": kernel_bound(nbytes, flops, q.dtype, tensor_cores=True),
            "ffma": kernel_bound(nbytes, flops)}


def phase_mlstm_timing(torch, m=None, what="the main-path shape", phase=13):
    """The kernel at the serve main path's shape (or ``m``): its time, both
    bounds, the memory one call takes above its inputs, and its plain
    version (phase 11 splits its device time by pass).  No single PyTorch
    call computes chunked mLSTM, so there is no library time."""
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunked
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, TF32_FLOP_PER_S

    m = m or ML_MAIN
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = _ml_inputs(torch, m["B"], m["H"], m["S"], m["dk"], m["dv"], torch.float32,
                      "reference", gen)
    _, err, _ = _ml_compare(torch, args, m["chunk"], f"timing inputs, {what}")
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
    smi = _smi()
    log(f"phase {phase}: mlstm_chunk at {what}, q/k {tuple(args[0].shape)}, v "
        f"{tuple(args[2].shape)}, chunk "
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



def phase_plane_timing(torch, nodes=MAIN["nodes"], cfg=None, tp=1):
    """The flat-plane path's two stages at qwen3-0.6b's full stacked plane
    (4, 648000, 1024) f32 — or ``(nodes, 648000, 1024)``: one rank's plane
    is (1, ...); or at the plane of ``cfg``; at ``tp > 1`` a model rank's
    local plane — one launch each per step:
    kernel time, bound, the plain version (node by node: its temporaries
    over the whole plane would not fit) and, for grad_step,
    ``torch.addcmul``."""
    from repro_torch.configs import get_config
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.fused_update.kernel import (
        STAGE_FLOPS,
        fused_stage_launch,
        stage_bytes,
        stage_io,
        stage_plain,
    )
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.train.train_state import model_plane_layout

    full = model_plane_layout(cfg if cfg is not None else get_config(MAIN["arch"]), tp)
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
        bound_ms, by = kernel_bound(nbytes, numel * STAGE_FLOPS[op])
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

    res, launches, total, trace, step_ms = _profiled_train(torch, ["--flat-planes"])
    steps = len(res["losses"])
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"non-finite loss on the flat-plane path: {res['losses']}")
    if total != 2 * steps or launches != {op: steps for op in TAIL_OPS}:
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
    prof = _profile_report(torch, trace, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
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
        STAGE_FLOPS,
        fused_stage_launch,
        stage_bytes,
        stage_io,
        stage_plain,
    )
    from repro_torch.launch.roofline import kernel_bound
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
    bound_ms, by = kernel_bound(nbytes, numel * STAGE_FLOPS[op])
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
    from repro_torch.launch.roofline import HBM_BYTES_PER_S
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
        res, launches, total, trace, step_ms = _profiled_train(torch, STALE, watch)
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
    prof = _profile_report(torch, trace, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
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
    res, launches, total, trace, step_ms = _profiled_train(torch, COMPRESSED, watch)
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
    prof = _profile_report(torch, trace, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2)
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


# the vocabulary of the runs that only check a path (phases 20, 22, 23's
# checkpoint half and 32): qwen3-0.6b's 151,936-row embedding and head are 86 %
# of a 4-layer node's parameters and set the bytes that the loopback gossip and
# the checkpoints move; every layer keeps its full width
CHECK_VOCAB = 16384


def _check_config(cfg):
    import dataclasses

    return dataclasses.replace(cfg, vocab_size=CHECK_VOCAB)


# phase 20: checkpoint and resume at full width (the vocabulary cut to
# CHECK_VOCAB), 2 layers, 2 nodes
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
    at full width with the vocabulary cut to CHECK_VOCAB (through the CLI's
    ``_model_config``), 2 layers, 2 nodes: 4 steps unbroken (saving at step 2)
    against 2 steps, a state restored with --resume from the step-2
    checkpoint in a fresh directory, and 2 more: losses, parameters,
    optimizer and the whole channel state bit for bit.  Then the same
    step-2 checkpoint restored without --flat-planes: parameters and
    momentum equal the planes it saved (copied to the host as it was
    written), the channel state starts afresh, and 2 more steps have finite
    losses.  The runs' final checkpoints, which nothing reads, are not
    written."""
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
    log(f"phase 20: vocabulary {CHECK_VOCAB:,}; {free / 1e9:.1f} GB free on the checkout's "
        "disk")
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

    saved = {}

    def save_but_finals(directory, state, **kw):
        if int(state["step"]) == 4:  # the runs' final checkpoints: nothing reads them
            return os.path.join(directory, "step_00000004 (not written)")
        saved.update(_host_copy(state))  # what the step-2 checkpoint holds
        return timed_save(directory, state, **kw)

    model_config = train._model_config
    train._model_config = lambda args: _check_config(model_config(args))
    train.save_checkpoint = save_but_finals
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

        # the step-2 checkpoint into the per-leaf form, then 2 steps on it
        cfg = _check_config(dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2))
        layout = model_plane_layout(cfg)
        tcfg = TrainConfig(algorithm="decentlam-sa", gossip_delay=1, compression="int8-row-ef",
                           fused_update=True, fused_impl="triton",
                           schedule=ScheduleConfig(kind="warmup_cosine", peak_lr=3e-3,
                                                   warmup_steps=1, total_steps=4))
        step_fn, channel = build_train_step(cfg, tcfg, 2)
        state = train.resume_state(b, cfg, channel, None, False, 2, torch.device("cuda"))
        saved_m = {"float32": saved["opt/m/float32"]}
        m_tree = layout.unpack(saved_m, dtype=torch.float32, leading=1)
        got = dict(zip(tree_paths(state["params"]), tree_leaves(state["params"])))
        want_m = dict(zip(tree_paths(m_tree), tree_leaves(m_tree)))
        got_m = dict(zip(tree_paths(state["opt"]["m"]), tree_leaves(state["opt"]["m"])))
        bad = [p for p, t in got.items() if not _same_bits(torch, t.cpu(), saved[f"params/{p}"])]
        bad += [p for p, t in got_m.items() if not _same_bits(torch, t.cpu(), want_m[p])]
        # the residual and the ring start afresh; the telemetry carries on
        fresh = all(not t.any() for k, v in state["channel"].items() if k != "t"
                    for t in tree_leaves(v))
        fresh = fresh and all(_same_bits(torch, state["channel"]["t"][k].cpu(),
                                         saved[f"channel/t/{k}"]) for k in ("bytes", "rounds"))
        if bad or sorted(got_m) != sorted(want_m) or not fresh:
            raise RuntimeError(f"per-leaf resume: {bad} differ from the saved planes, channel "
                               f"re-initialized: {fresh}")
        n_leaves = len(got)
        del got, got_m, m_tree
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                             per_node_batch=MAIN["per_node_batch"], n_nodes=2))
        losses = []
        for k in (2, 3):
            state, metrics = step_fn(state, {n: torch.from_numpy(v).cuda()
                                             for n, v in data.batch(k).items()})
            losses.append(float(metrics["loss"]))
        if state["step"] != 4 or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"per-leaf resume: losses {losses} to step {state['step']}")
        del state, saved
        torch.cuda.empty_cache()
        log(f"  the step-2 checkpoint without --flat-planes: {n_leaves} parameter "
            f"leaves and every momentum leaf == the saved planes unpacked, the channel state "
            f"re-initialized (zeros) but for the telemetry; 2 more steps, losses {losses}")
        log(f"  {gb:.2f} GB per checkpoint; save {[round(t, 1) for t in times['save']]} s, "
            f"restore {[round(t, 1) for t in times['restore']]} s")
    finally:
        train.save_checkpoint, train.restore_checkpoint = save, restore
        train._model_config = model_config
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
DIST_STEPS = 2  # 3 before: the script's time limit
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
    --gossip-impl ppermute``), 2 steps: finite losses, exactly 2 stage
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
    if counts != want or any(b != {op: steps for op in TAIL_OPS} for b in by_op):
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

    cfg = _check_config(dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth))
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


def _share_nodes(group, tree):
    """Each rank's node of rank 0's stacked ``tree`` (leaf path -> ``(n,
    ...)`` tensor on the card; None on the other ranks): leaf path -> a
    ``(1, ...)`` view of rank 0's memory.  The ranks share the card, so a
    CUDA IPC handle passes each node without a copy (a gather over gloo
    moved ~11 GB per comparison).  Every rank calls it; rank 0 keeps
    ``tree`` alive until every rank has dropped its views (a collective
    after the comparison), then calls ``torch.cuda.ipc_collect()``."""
    import io
    import pickle
    from multiprocessing.reduction import ForkingPickler

    import torch.distributed as dist
    import torch.multiprocessing  # noqa: F401  (registers the CUDA tensor reductions)

    blobs = [None]
    if group.rank == 0:
        blobs = [[]]
        for r in range(1, group.world):
            buf = io.BytesIO()
            ForkingPickler(buf, pickle.HIGHEST_PROTOCOL).dump(
                {k: v.detach()[r:r + 1] for k, v in tree.items()})
            blobs[0].append(buf.getvalue())
    dist.broadcast_object_list(blobs, src=0, group=group.pg)
    if group.rank == 0:
        return {k: v.detach()[:1] for k, v in tree.items()}
    return pickle.loads(blobs[0][group.rank - 1])


def _node_errors(group, mine, tree):
    """max |mine - rank 0's stacked node| over the parameters and over the
    optimizer state, the largest over the ranks, on every rank (None if a
    rank's leaves differ from the stacked run's); ``tree`` as for
    :func:`_share_nodes`.  Nothing of rank 0's memory is read after it
    returns."""
    import torch
    import torch.distributed as dist

    theirs = _share_nodes(group, tree)
    errs = None
    if sorted(theirs) == sorted(mine):
        errs = {part: max(float((mine[k] - theirs[k]).abs().max()) for k in theirs
                          if k.startswith(part)) for part in ("params", "opt")}
    del theirs
    torch.cuda.synchronize(group.device)
    out = [None] * group.world
    dist.all_gather_object(out, errs, group=group.pg)
    if group.rank == 0:
        torch.cuda.ipc_collect()
    if any(e is None for e in out):
        return None
    return {part: max(e[part] for e in out) for part in ("params", "opt")}


def _dist_vs_stacked_rank(group, depth, steps):
    """The body of phase 22 on one rank (see :func:`phase_dist_vs_stacked`).
    Rank 0 returns the report lines; any failed check raises.  A
    configuration held against the stacked run is compared on each rank's
    own node: rank 0 runs the stacked step and passes each rank its node
    through :func:`_share_nodes`; the finite and bitwise checks also run on
    each rank's own node, their verdicts gathered."""
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
    from repro_torch.train.train_state import init_train_state, model_plane_layout

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
            del state
            torch.cuda.empty_cache()
            sstate = want = None
            if lead:
                sstate, slosses = run(lambda: build_train_step(cfg, tcfg, group.world),
                                      group.world, cfg, tcfg, layout)
                want = _comparable(sstate, layout)
                torch.cuda.synchronize(dev)
            errs = _node_errors(group, mine, want)
            del sstate, want
            if errs is None:
                raise RuntimeError(f"{name}: leaves differ from the stacked run's")
            # the momentum is the mix's difference over lr: the parameter
            # tolerance carries over to it divided by the peak lr
            tols = {"params": tol, "opt": tol / DIST_LR}
            if not all(errs[p] < tols[p] for p in errs):
                raise RuntimeError(f"{name}: max |distributed - stacked| {errs} (tol {tols})")
            if lead:
                line += (f"; stacked {[round(v, 4) for v in slosses]}; max |distributed - "
                         f"stacked| {errs['params']:.3g} over the final parameters (< {tol}), "
                         f"{errs['opt']:.3g} over the optimizer state (< {tol} / lr)")
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
    each rank's final parameters and optimizer state held against its node
    of the stacked step's (rank 0 runs it) at the reference's
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
    log(f"phase 22: {depth} layers, vocabulary {CHECK_VOCAB:,}, {steps} steps, "
        f"{MAIN['nodes']} ranks on the card, "
        f"distributed == stacked in {held} configurations, the finite ones, and the "
        f"bitwise claims ({time.perf_counter() - t0:.1f} s):")
    for line in lines:
        log(f"  {line}")


# phase 23: checkpoint and resume at full width with the vocabulary cut, 2
# layers, on 2 ranks (4 before: the script's time limit; the checkpoint's
# I/O and the loopback gossip scale with the ranks), and the drill at full
# width on 4 ranks (4 -> 2), the vocabulary cut too (PR 22: the full
# vocabulary's embedding and head, 91 % of a 2-layer node, took the drill to
# 102.4 s of the script's time)
DIST_CKPT_RANKS = 2
DIST_CKPT = ["--simulate-nodes", str(MAIN["nodes"]), "--arch", MAIN["arch"], "--depth", "2",
             "--seq-len", str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
             "--algorithm", "decentlam-sa", "--gossip-delay", "1", "--flat-planes",
             "--fused-update", "--fused-impl", "triton", "--log-every", "1", "--timeout",
             str(DIST_TIMEOUT_S)]


def _drill_rank(world, argv):
    """Phase 23's drill on one rank: the CLI's rank body with the vocabulary
    cut and the shrink checked by :func:`_check_shrink`."""
    from repro_torch.launch import train

    model_config = train._model_config
    train._model_config = lambda args: _check_config(model_config(args))
    return train.rank_main(world, argv, None, _check_shrink)


def _check_shrink(grid, gathered, now):
    """``on_shrink`` hook of phases 23 and 41: the survivors' rebuilt state,
    gathered again to rank 0 (``now``), against ``elastic_reshape`` of the
    state gathered before the shrink, bit for bit (every parameter and
    optimizer tensor; the channel state starts afresh).  Rank 0 returns
    ``(tensors, differing, channel fresh)``."""
    import torch

    from repro_torch.train.checkpoint import elastic_reshape
    from repro_torch.utils import tree_leaves, tree_paths

    if now is None:
        return None
    want = elastic_reshape(gathered, grid.nodes)
    tree_a = {k: now[k] for k in ("params", "opt")}
    tree_b = {k: want[k] for k in ("params", "opt")}
    pa = dict(zip(tree_paths(tree_a), tree_leaves(tree_a)))
    pb = dict(zip(tree_paths(tree_b), tree_leaves(tree_b)))
    differ = [k for k in pb if k not in pa or not _same_bits(torch, pa[k], pb[k])]
    fresh = all(not bool(t.any()) for t in tree_leaves(now.get("channel", {})))
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
    from repro_torch.launch.mesh import init_grid
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.step import build_dist_train_step
    from repro_torch.train.train_state import gather_state, init_train_state, model_plane_layout
    from repro_torch.utils import tree_leaves, tree_paths

    args = train._parse(argv)
    cfg, tcfg = _check_config(train._model_config(args)), train._train_config(args)
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
    state = train._resume_ranks(init_grid(group, 1), root, cfg, channel, layout, True)
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
    """Phase 17's algorithm at delay 1 on planes, qwen3-0.6b at full width
    with the vocabulary cut to CHECK_VOCAB, 2 layers, 2 processes: 4 steps
    unbroken against 2 steps, a checkpoint
    (gathered to rank 0 and written), the trainer's resume (read on rank 0
    and scattered) and 2 more: losses, and every rank's parameters,
    optimizer and channel state (the ring and its count included) bit for
    bit; GB, save and restore seconds.  Then, on 4 processes at full width
    (the vocabulary cut), the CLI's rank body with --failure-drill 4 -> 2
    over 3 steps: finite losses, and the survivors' state after the shrink
    == elastic_reshape of the gathered state bit for bit."""
    import shutil

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
    log(f"phase 23: 2 layers, vocabulary {CHECK_VOCAB:,}, {DIST_CKPT_RANKS} processes, "
        f"decentlam-sa at delay 1 on planes: "
        f"unbroken {rep['losses_a']} == 2 steps, save, resume, 2 steps {rep['losses_b']}; "
        f"every rank's final state bit for bit in all {len(rep['tensors'])} tensors "
        f"({len(chan)} of the channel: {chan}); {time.perf_counter() - t:.1f} s")
    log(f"  {rep['gb']:.2f} GB per checkpoint ({free / 1e9:.1f} GB free on the disk); save "
        f"(gather to rank 0, write) {rep['save_s']:.1f} s, restore (read on rank 0, scatter, "
        f"to the device) {rep['restore_s']:.1f} s")

    t = time.perf_counter()
    rc = run_ranks(_drill_rank, MAIN["nodes"], DIST_CKPT + ["--steps", "3", "--failure-drill"],
                   timeout_s=DIST_TIMEOUT_S)[0]
    n_tensors, differ, fresh = rc["on_shrink"]
    if (not all(map(math.isfinite, rc["losses"])) or rc["n_nodes"] != MAIN["nodes"] // 2
            or differ or not fresh):
        raise RuntimeError(f"drill: losses {rc['losses']} on {rc['n_nodes']} nodes, "
                           f"{differ[:5]} differ from elastic_reshape, channel fresh {fresh}")
    log(f"  --failure-drill {rc['drill']} (vocabulary {CHECK_VOCAB:,}): losses {rc['losses']} "
        f"(finite), the survivors' "
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
    res, launches, total, trace, step_ms = _profiled_train(
        torch, ["--flat-planes"], arch=MOE["arch"], depth=MOE["depth"])
    steps = len(res["losses"])
    _finite_run(res, "the MoE main path", moe=True)
    if total != 2 * steps or launches != {op: steps for op in TAIL_OPS}:
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
    prof = _profile_report(torch, trace, step_ms, 1e3 * sum(res["step_times_s"][-2:]) / 2,
                           flops=_moe_matmul_flops_per_step(cfg, MAIN["nodes"]))
    for span in MOE_SPANS:
        ms = _span_report(torch, trace, span, "the forward, per step", 2)
        if ms is not None:
            log(f"    {span}: {ms / prof['busy_ms']:.1%} of the step's device time")
    del trace
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

    def share(trace, steps, what):
        _, busy = _device_kernels(torch, trace)
        ms = _span_report(torch, trace, "ssm_forward", what, steps)
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


# ---------------------------------------------------------------------------
# whisper-tiny, ResNet-20, the bias experiments and the simulator (27-29)
# ---------------------------------------------------------------------------

# ResNet-20 through the stacked oracle: 4 nodes of DecentLaM on exp, each on
# its own fixed batch of 128 seeded images (10 classes)
RESNET = dict(nodes=4, per_node_batch=128, steps=20, lr=0.05, momentum=0.9)
# the App. G.2 linear regression on the paper's 8-node torus
# (tests/test_bias_propositions.py) at the port's CPU tests' reduced steps
BIAS = dict(lr=1e-3, beta=0.8, steps=2000, prop1_steps=1500, sigma=50.0)
# the simulator's two bitwise claims: the event engine at equal constant
# speeds == run_stacked, every algorithm; vectorized == per-node on a straggler
SIM = dict(n=8, m=10, d=6, lr=1e-2, oracle_steps=6, steps=15, seed=3)


def _whisper_batches(torch, cfg, steps):
    """``steps`` global batches of the train step: SyntheticLM's tokens and
    targets (nodes * b, seq) beside f32 ``enc_frames`` (nodes * b, 1500, 384)
    from a seeded generator on the card (the frontend stub's output)."""
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig

    n, b = WHISPER["nodes"], WHISPER["per_node_batch"]
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=WHISPER["seq_len"],
                                         per_node_batch=b, n_nodes=n))
    gen = torch.Generator(device="cuda").manual_seed(27)
    out = []
    for k in range(steps):
        batch = {name: torch.as_tensor(v, device="cuda") for name, v in data.batch(k).items()}
        batch["enc_frames"] = torch.randn(n * b, cfg.enc_seq, cfg.d_model, generator=gen,
                                          device="cuda")
        out.append(batch)
    return out


def _whisper_train(torch, cfg, batches, impl):
    """whisper-tiny's train step through the API (its CLI refuses the
    encoder-decoder: its data carry no frames): 4 stacked nodes on flat
    planes, decentlam on exp, the stage kernel (``impl`` "triton") or its
    plain version ("torch"), the launch counts set to 0 just before the
    first step and read after the last."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.train.step import TrainConfig, build_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout

    n = WHISPER["nodes"]
    tc = TrainConfig(algorithm="decentlam", topology="exp", momentum=0.9,
                     schedule=ScheduleConfig(kind="warmup_cosine", peak_lr=3e-3, warmup_steps=1,
                                             total_steps=len(batches)),
                     fused_update=True, fused_impl=impl, flat_planes=True)
    step_fn, channel = build_train_step(cfg, tc, n)
    state = init_train_state(cfg, make_optimizer(tc.opt_config()), n,
                             device=torch.device("cuda"), channel=channel,
                             plane_layout=model_plane_layout(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": times, "state": state,
            "launches": dict(fused_stage_launch.launches_by_op),
            "total": fused_stage_launch.launches,
            "peak": torch.cuda.max_memory_allocated() / 2**30,
            "params_per_node": sum(s.size for segs in model_plane_layout(cfg).segments.values()
                                   for s in segs)}


def _whisper_serve(torch, cfg, params, frames, prompts, impl):
    """Greedy serving through ``prefill`` + ``decode_step`` (the engine
    refuses the encoder-decoder: its requests carry no frames): one wave of
    the prompts against their frames, then ``new - 1`` decode steps, with
    ``attn_impl`` = ``impl``.  Returns the tokens (B, new), each step's
    top-two logit gap (a share of max |logit|), the flash launches of the
    run (set to 0 just before it), prefill ms and decode ms per step."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches
    from repro_torch.models import transformer as T

    rt = T.RuntimeConfig(dtype="float32", attn_impl=impl)
    P, new = prompts.shape[1], WHISPER["new"]
    target = P + new
    toks, gaps, dec_s = [], [], []

    def pick(logits):
        lg = logits[:, :cfg.vocab_size].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]) / lg.abs().amax(dim=-1))
        tok = lg.argmax(dim=-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        return tok

    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, {"tokens": prompts, "enc_frames": frames}, cfg, rt,
                                  target_len=target)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        tok = pick(logits)
        for t in range(P, P + new - 1):
            t1 = time.perf_counter()
            logits, cache = T.decode_step(params, tok, cache, t, cfg, rt, target_len=target)
            tok = pick(logits)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t1)
        launches = flash_attention_launch.launches
    return {"tokens": torch.cat(toks, dim=1).cpu(), "gaps": torch.stack(gaps, dim=1).cpu(),
            "launches": launches, "prefill_ms": prefill_ms,
            "decode_ms": 1e3 * sum(dec_s[1:]) / max(len(dec_s) - 1, 1)}


def phase_whisper(torch):
    """whisper-tiny at full width and depth (4 + 4 layers, d 384, 6/6 heads,
    vocab 51,865, 1500 encoder frames): 3 training steps of 4 stacked nodes
    on flat planes through the stage kernel (2 launches per step; the plain
    stage == the kernel bit for bit over the 3 steps); then serving 8
    requests of 224 prompt tokens and 32 new through prefill and decode with
    the flash kernel (12 launches per prefill wave: the encoder's 4
    non-causal, the decoder's 4 causal and 4 cross) against the plain path,
    token for token (or parting only at a near tie); and the stage kernel at
    whisper's plane beside its bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.utils import resolve_device

    resolve_device("cuda")
    cfg = get_config(WHISPER["arch"])
    batches = _whisper_batches(torch, cfg, WHISPER["steps"])
    runs = {impl: _whisper_train(torch, cfg, batches, impl) for impl in ("triton", "torch")}
    kern, plain = runs["triton"], runs["torch"]
    steps = WHISPER["steps"]
    if not all(math.isfinite(v) for v in kern["losses"]):
        raise RuntimeError(f"whisper-tiny train: non-finite losses {kern['losses']}")
    if kern["total"] != 2 * steps or kern["launches"] != {op: steps for op in TAIL_OPS}:
        raise RuntimeError(f"whisper-tiny train: fused_update launched {kern['total']} times "
                           f"({kern['launches']}), want 2 x {steps}")
    if plain["total"] != 0:
        raise RuntimeError(f"whisper-tiny train, plain stage: {plain['total']} kernel launches")
    (ks, ps) = kern["state"], plain["state"]
    same = kern["losses"] == plain["losses"] and all(
        _same_bits(torch, ks["planes"][k], ps["planes"][k]) for k in ks["planes"]
    ) and all(_same_bits(torch, ks["opt"]["m"][k], ps["opt"]["m"][k]) for k in ks["opt"]["m"])
    if not same:
        raise RuntimeError(f"whisper-tiny train: the plain stage differs from the kernel: "
                           f"losses {plain['losses']} vs {kern['losses']}")
    n, b, seq = WHISPER["nodes"], WHISPER["per_node_batch"], WHISPER["seq_len"]
    step_ms = 1e3 * sum(kern["step_s"][1:]) / (steps - 1)
    log(f"phase 27: {cfg.name} full width ({cfg.n_enc_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {kern['params_per_node']:,} params/node) x {n} nodes, flat planes, "
        f"decoder seq {seq} x {b} per node, enc_frames ({n * b}, {cfg.enc_seq}, {cfg.d_model}), "
        f"{steps} steps: losses {[round(v, 4) for v in kern['losses']]}; fused_update launches "
        f"{kern['total']} ({kern['launches']}); the plain stage == the kernel bit for bit "
        f"(losses, final parameter and momentum planes); step {step_ms:.1f} ms (mean of steps "
        f"1..{steps - 1}), step times {[round(t, 4) for t in kern['step_s']]}, peak memory "
        f"{kern['peak']:.2f} GiB")
    train_launches = kern["launches"]
    del runs, kern, plain, ks, ps, batches
    torch.cuda.empty_cache()

    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(28)
    B, P = WHISPER["slots"], WHISPER["prompt"]
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda",
                            dtype=torch.int32)
    frames = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=gen, device="cuda")
    plain = _whisper_serve(torch, cfg, params, frames, prompts, "torch")
    kern = _whisper_serve(torch, cfg, params, frames, prompts, "cuda")
    per_wave = cfg.n_enc_layers + 2 * cfg.n_layers
    if kern["launches"] != per_wave or plain["launches"] != 0:
        raise RuntimeError(f"whisper-tiny serve: {kern['launches']} flash launches on the "
                           f"kernel path ({plain['launches']} plain), want {per_wave} per wave")
    parted = []
    for r in range(B):
        a, p_ = kern["tokens"][r], plain["tokens"][r]
        if torch.equal(a, p_):
            continue
        pos = int((a != p_).int().argmax())
        gap = float(plain["gaps"][r, pos])
        log(f"  request {r}: tokens part at generated position {pos} ({int(a[pos])} kernel vs "
            f"{int(p_[pos])} plain); plain top-two logit gap {gap:.3g} of max |logit|")
        if not gap < LOGIT_RTOL:
            raise RuntimeError(f"whisper-tiny serve, request {r}: kernel and plain paths part "
                               f"at position {pos} where the plain gap {gap:.3g} is not a near "
                               f"tie (< {LOGIT_RTOL})")
        parted.append(r)
    timed = _whisper_serve(torch, cfg, params, frames, prompts, "cuda")
    log(f"phase 27: {cfg.name} serve, {B} requests of {P} prompt tokens and "
        f"{WHISPER['new']} new, one prefill wave: flash launches {kern['launches']} per wave "
        f"(= {cfg.n_enc_layers} encoder non-causal + {cfg.n_layers} decoder causal + "
        f"{cfg.n_layers} cross non-causal at Sk {cfg.enc_seq}); kernel path == plain path token "
        f"for token on {B - len(parted)} of {B} requests"
        + (f", the other {len(parted)} part at near ties" if parted else "")
        + f" (smallest plain top-two gap {float(plain['gaps'].min()):.3g}); prefill "
        f"{kern['prefill_ms']:.1f} / {timed['prefill_ms']:.1f} ms per wave (first / second "
        f"run), plain {plain['prefill_ms']:.1f} ms; decode {timed['decode_ms']:.2f} ms per "
        f"step (plain {plain['decode_ms']:.2f})")
    del params, frames, prompts
    torch.cuda.empty_cache()
    plane = phase_plane_timing(torch, cfg=cfg)
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"  # noqa: E731
    for op, p in plane.items():
        log(f"  plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms by {p['bound_by']} ({p['bytes'] / 1e9:.3f} GB; "
            f"{p['bound_ms'] / p['ms']:.1%} of it), plain version {p['plain_ms']:.3f} ms, "
            f"library {fmt(p['library_ms'])}, max |kernel - plain| {p['err']:.3g}")
    return {"launches": train_launches, "flash_launches": kern["launches"], "plane": plane}


def _resnet_run(torch, images, labels):
    """ResNet-20 through ``run_stacked``: RESNET["nodes"] copies of one seeded
    init, DecentLaM on exp, node i on rows [i * b, (i + 1) * b) of the images
    every step.  Returns the final parameters and state, the mean loss over
    nodes at each step (before its update) and the seconds of the run."""
    from repro_torch.core import (
        OptimizerConfig,
        build_topology,
        make_optimizer,
        run_stacked,
    )
    from repro_torch.models.resnet_cifar import resnet20_init, resnet20_loss
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    n, b = RESNET["nodes"], RESNET["per_node_batch"]
    one = resnet20_init(torch.Generator(device="cuda").manual_seed(0))
    params0 = tree_map(lambda a: a[None].repeat((n,) + (1,) * a.ndim), one)
    losses = []

    def grad_fn(params, _step):
        grads, total = [], 0.0
        for i in range(n):
            leaves = [t[i].detach().requires_grad_() for t in tree_leaves(params)]
            loss, _ = resnet20_loss(tree_unflatten(params, leaves), images[i * b:(i + 1) * b],
                                    labels[i * b:(i + 1) * b])
            grads.append(torch.autograd.grad(loss, leaves))
            total = total + loss.detach()
        losses.append(total / n)
        return tree_unflatten(params, [torch.stack(g) for g in zip(*grads)])

    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=RESNET["momentum"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, _ = run_stacked(opt, build_topology("exp", n), params0, grad_fn,
                                   lr=RESNET["lr"], n_steps=RESNET["steps"])
    torch.cuda.synchronize()
    return params, state, [float(v) for v in losses], time.perf_counter() - t0


def phase_resnet(torch):
    """ResNet-20 (the paper's own domain) on the card: 4 nodes of DecentLaM
    through the stacked oracle, exp, each node on its own fixed batch of 128
    seeded 32x32x3 images of 10 classes, 20 steps: the loss falls; step time;
    the consensus distance of the final parameters; the run equals its
    repeat bit for bit (deterministic cuDNN, TF32 off: ``resolve_device``)."""
    from repro_torch.core import consensus_distance
    from repro_torch.utils import resolve_device, tree_leaves

    resolve_device("cuda")
    n, b = RESNET["nodes"], RESNET["per_node_batch"]
    gen = torch.Generator(device="cuda").manual_seed(28)
    images = torch.randn(n * b, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (n * b,), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    p1, s1, losses, wall = _resnet_run(torch, images, labels)
    p2, s2, again, _ = _resnet_run(torch, images, labels)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"ResNet-20: the loss did not fall: {losses}")
    same = losses == again and all(
        _same_bits(torch, a, c) for a, c in zip(tree_leaves(p1), tree_leaves(p2))) and all(
        _same_bits(torch, a, c) for a, c in zip(tree_leaves(s1), tree_leaves(s2)))
    if not same:
        raise RuntimeError("ResNet-20: the run differs from its repeat")
    flat = torch.cat([t.reshape(n, -1) for t in tree_leaves(p1)], dim=1)
    log(f"phase 28: ResNet-20 ({flat.shape[1]:,} params/node, HWIO weights, NHWC images) x "
        f"{n} nodes, decentlam through run_stacked, exp, {b} images per node, "
        f"{RESNET['steps']} steps at lr {RESNET['lr']}: losses "
        f"{[round(v, 4) for v in losses[:3]]} .. {[round(v, 4) for v in losses[-3:]]} (falls); "
        f"step {1e3 * wall / RESNET['steps']:.1f} ms (4 per-node forward + backward and the "
        f"plain stacked update); consensus distance {float(consensus_distance(flat)):.4g}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the repeat == the run bit for "
        f"bit (losses, parameters, momentum)")


def phase_bias_and_sim(torch):
    """The paper's bias experiments (App. G.2 linear regression on the 8-node
    torus, full batch) on the card, held to the reference tests' bounds: Fig.
    2 and Props. 2-3 (DmSGD's bias > 3x DSGD's, within 10x of 1/(1-beta)^2;
    DecentLaM's < 1.5x DSGD's and < 0.2x DmSGD's), the gamma^2 scaling
    (DecentLaM's bias ratio in (2, 8) at 2x lr) and Prop. 1 (DmSGD's error
    over DecentLaM's > 2 at sigma 0, smaller at sigma 50); then the
    simulator: the event engine (both strategies) at equal constant speeds
    == run_stacked bit for bit for every algorithm, and the vectorized
    engine == the per-node engine bit for bit on straggler_1slow."""
    import functools

    import numpy as np

    from repro_torch.core import (
        ALGORITHMS,
        OptimizerConfig,
        bias_to_optimum,
        build_topology,
        make_linear_regression,
        make_optimizer,
        run_bias_experiment,
        run_stacked,
    )
    from repro_torch.sim import SimSpec, simulate
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    lr, beta, steps = BIAS["lr"], BIAS["beta"], BIAS["steps"]
    prob = make_linear_regression(n=8, m=50, d=30, noise=0.01, seed=0)  # on the card
    topo = build_topology("torus", 8)
    bias = {a: float(run_bias_experiment(a, prob, topo, lr=lr, momentum=beta, n_steps=steps,
                                         record_every=steps)[-1])
            for a in ("dsgd", "dmsgd", "decentlam")}
    bias2 = float(run_bias_experiment("decentlam", prob, topo, lr=2 * lr, momentum=beta,
                                      n_steps=steps, record_every=steps)[-1])
    ratio, predicted = bias["dmsgd"] / bias["dsgd"], 1.0 / (1.0 - beta) ** 2
    gamma = bias2 / bias["decentlam"]
    rng = np.random.default_rng(0)

    def final_err(algo, sigma):
        opt = make_optimizer(OptimizerConfig(algorithm=algo, momentum=beta))

        def grad(x, _step):
            noise = torch.as_tensor(rng.standard_normal((8, prob.dim)), dtype=torch.float32,
                                    device="cuda")
            return prob.grad(x) + sigma * noise

        x, _, _ = run_stacked(opt, topo, torch.zeros((8, prob.dim), device="cuda"), grad,
                              lr=lr, n_steps=BIAS["prop1_steps"])
        return float(torch.mean(torch.sum((x - prob.x_star[None]) ** 2, dim=-1)))

    gap_full = final_err("dmsgd", 0.0) / final_err("decentlam", 0.0)
    gap_noisy = final_err("dmsgd", BIAS["sigma"]) / final_err("decentlam", BIAS["sigma"])
    checks = {
        "Fig. 2: dmsgd > 3 x dsgd": bias["dmsgd"] > 3.0 * bias["dsgd"],
        "Prop. 2: ratio within 10x of 1/(1-beta)^2": predicted / 10 < ratio < predicted * 10,
        "Prop. 3: decentlam < 1.5 x dsgd and < 0.2 x dmsgd":
            bias["decentlam"] < 1.5 * bias["dsgd"] and bias["decentlam"] < 0.2 * bias["dmsgd"],
        "gamma^2: ratio in (2, 8) at 2x lr": 2.0 < gamma < 8.0,
        "Prop. 1: gap > 2 at sigma 0, smaller at sigma 50":
            gap_full > 2.0 and gap_noisy < gap_full,
    }
    log(f"phase 29: App. G.2 linear regression (n 8, m 50, d 30) on the torus, full batch, "
        f"lr {lr}, beta {beta}, {steps} steps: final bias dsgd {bias['dsgd']:.4g}, dmsgd "
        f"{bias['dmsgd']:.4g} ({ratio:.2f}x dsgd; 1/(1-beta)^2 = {predicted:.0f}), decentlam "
        f"{bias['decentlam']:.4g}; decentlam at 2x lr {bias2:.4g} ({gamma:.2f}x); Prop. 1 at "
        f"{BIAS['prop1_steps']} steps: dmsgd / decentlam error {gap_full:.2f} at sigma 0, "
        f"{gap_noisy:.2f} at sigma {BIAS['sigma']:g}; "
        + "; ".join(f"{k}: {'holds' if v else 'FAILS'}" for k, v in checks.items()))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"the bias bounds fail on the card: {failed}")
    t_bias = time.perf_counter() - t0

    t1 = time.perf_counter()
    small = make_linear_regression(n=SIM["n"], m=SIM["m"], d=SIM["d"], noise=0.01, seed=1)
    grad = lambda x, _s: small.grad(x)  # noqa: E731
    x0 = torch.zeros((SIM["n"], SIM["d"]), device="cuda")

    def same_tree(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(_same_bits(torch, u, v) for u, v in zip(la, lb))

    for algo in ALGORITHMS:
        opt = make_optimizer(OptimizerConfig(algorithm=algo, momentum=beta))
        p_ref, s_ref, _ = run_stacked(opt, build_topology("ring", SIM["n"]), x0, grad,
                                      lr=SIM["lr"], n_steps=SIM["oracle_steps"])
        for engine in ("pernode", "vectorized"):
            r = simulate(opt, SimSpec(topology="ring", n=SIM["n"], lr=SIM["lr"],
                                      n_steps=SIM["oracle_steps"], scenario="homogeneous",
                                      engine=engine), x0, grad)
            if not (same_tree(r.params, p_ref) and same_tree(r.opt_state, s_ref)):
                raise RuntimeError(f"simulator: the {engine} engine at equal constant speeds "
                                   f"differs from run_stacked for {algo}")
    metric = functools.partial(bias_to_optimum, x_star=small.x_star)
    stats = {}
    for algo in ("decentlam", "decentlam-sa"):
        opt = make_optimizer(OptimizerConfig(algorithm=algo, momentum=beta))
        res = {}
        for engine in ("pernode", "vectorized"):
            spec = SimSpec(topology="ring", n=SIM["n"], lr=SIM["lr"], n_steps=SIM["steps"],
                           scenario="straggler_1slow", seed=SIM["seed"], record_dt=3.0,
                           metric_fn=metric, engine=engine)
            te = time.perf_counter()
            res[engine] = simulate(opt, spec, x0, grad)
            torch.cuda.synchronize()
            stats[(algo, engine)] = time.perf_counter() - te
        a, b = res["pernode"], res["vectorized"]
        if algo == "decentlam":  # phase 36 projects this run onto the wall clock
            straggler = {"result": a, "opt": opt, "grad": grad,
                         "topology": build_topology("ring", SIM["n"])}
        equal = (same_tree(a.params, b.params) and same_tree(a.opt_state, b.opt_state)
                 and (a.steps == b.steps).all() and (a.stall_time == b.stall_time).all()
                 and a.sim_time == b.sim_time and a.trace == b.trace
                 and a.final_metric == b.final_metric)
        if not equal:
            raise RuntimeError(f"simulator: vectorized != per-node on straggler_1slow ({algo})")
        stats[algo] = (a.sim_time, float(a.stall_time.sum()), a.final_metric)
    log(f"phase 29: the simulator on the card (linear regression n {SIM['n']}, ring): the event "
        f"engine at equal constant speeds == run_stacked bit for bit for all "
        f"{len(ALGORITHMS)} algorithms ({SIM['oracle_steps']} steps, per-node and vectorized); "
        f"vectorized == per-node bit for bit on straggler_1slow ({SIM['steps']} steps, seed "
        f"{SIM['seed']}; the whole result) for "
        + ", ".join(f"{a} (sim time {stats[a][0]:.4g}, stall {stats[a][1]:.4g}, bias "
                    f"{stats[a][2]:.4g}; per-node {stats[(a, 'pernode')]:.2f}s, vectorized "
                    f"{stats[(a, 'vectorized')]:.2f}s)" for a in ("decentlam", "decentlam-sa"))
        + f"; bias experiments {t_bias:.1f}s, simulator {time.perf_counter() - t1:.1f}s")

    # row-sparse gossip in the simulator (SimSpec.sparse): every row touched
    # == dense gossip, and the engines agree, under gradients that touch a
    # third of the rows
    t2 = time.perf_counter()
    opt = make_optimizer(OptimizerConfig(algorithm="decentlam", momentum=beta))
    rows = (torch.arange(SIM["d"], device="cuda")[None, :] % 3) == 0

    def sparse_grad(x, s):
        return torch.where(torch.roll(rows, s, dims=1), small.grad(x), 0.0)

    comm = {}
    for mode in ("exact", "delta"):
        for engine in ("pernode", "vectorized"):
            kw = dict(topology="ring", n=SIM["n"], lr=SIM["lr"], n_steps=SIM["steps"],
                      scenario="homogeneous", engine=engine)
            dense = simulate(opt, SimSpec(**kw), x0, grad)
            every_row = simulate(opt, SimSpec(sparse=mode, **kw), x0, grad)
            if not same_tree(every_row.params, dense.params):
                raise RuntimeError(f"simulator: sparse={mode} with every row touched != dense "
                                   f"({engine})")
        a = simulate(opt, SimSpec(sparse=mode, engine="pernode", **{
            k: v for k, v in kw.items() if k != "engine"}), x0, sparse_grad)
        b = simulate(opt, SimSpec(sparse=mode, engine="vectorized", **{
            k: v for k, v in kw.items() if k != "engine"}), x0, sparse_grad)
        if not (same_tree(a.params, b.params) and same_tree(a.opt_state, b.opt_state)):
            raise RuntimeError(f"simulator: sparse={mode}: vectorized != per-node")
        comm[mode] = a.comm
    log(f"phase 29: SimSpec(sparse=exact|delta) on the card ({SIM['steps']} steps, ring): every "
        f"row touched == dense gossip bit for bit (both engines); a third of the rows touched: "
        f"vectorized == per-node bit for bit; comm "
        + "; ".join(f"{m}: wire {c['wire_sparse_bytes']:.0f} of {c['wire_dense_bytes']:.0f} B, "
                    f"mailbox {c['mailbox_bytes']:.0f} of {c['mailbox_dense_bytes']:.0f} B"
                    for m, c in comm.items())
        + f" ({time.perf_counter() - t2:.1f}s)")
    return straggler


# ---------------------------------------------------------------------------
# Row-sparse gossip and the fault-tolerant gossip runtime (phases 30-32)
# ---------------------------------------------------------------------------

# phase 30: qwen3-0.6b at full width cut to 2 layers (a node's plane 328,512
# rows, 151,936 of them the untied embedding), 4 ranks sharing the card over
# gloo, decentlam on exp, planes, 4 x 256 tokens per node
SPARSE = dict(depth=2, steps=3, plain_steps=2, all_dirty_rows=1 << 16)
# phase 31: phase 15's run (full width and depth, 4 stacked nodes, planes)
RES = dict(steps=3, window=(2, 14), fault_steps=16, nan_window=(6, 7), plain_depth=4)
# phase 32: 4 ranks, 2 layers, 4 steps under chaos and the resilient layer
RES_DIST = dict(depth=2, steps=4,
                chaos=("silence,nodes=1,start=1,stop=3", "drop,prob=0.3"))
RES_LR = 3e-3  # the CLI's default peak lr


def _res_tcfg(steps, fields, impl="triton"):
    """The CLI's TrainConfig for ``steps`` steps (warmup_cosine at its
    default peak lr) on planes through the stage kernel."""
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.train.step import TrainConfig

    return TrainConfig(**{"fused_update": True, "fused_impl": impl, "flat_planes": True,
                          "schedule": ScheduleConfig(kind="warmup_cosine", peak_lr=RES_LR,
                                                     warmup_steps=min(20, max(steps // 5, 1)),
                                                     total_steps=max(steps, 2)),
                          **fields})


def _bits_equal_chunked(torch, dev_t, host_t, chunk=1 << 26) -> bool:
    """A device tensor against a host copy, bit for bit, a chunk at a time
    (the host copy comes up to the card one chunk at a time)."""
    a = dev_t.reshape(-1).view(torch.uint8)
    b = host_t.reshape(-1).view(torch.uint8)
    if a.numel() != b.numel():
        return False
    for lo in range(0, a.numel(), chunk):
        if not torch.equal(a[lo:lo + chunk], b[lo:lo + chunk].to(a.device, non_blocking=True)):
            return False
    return True


def _sparse_rank(group, depth):
    """The body of phase 30 on one rank (see :func:`phase_sparse_main_path`).
    Rank 0 returns the report; any failed check raises on every rank."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import PpermuteChannel
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.topology import build_topology
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.sparse import RowTracker, SparsePpermuteChannel
    from repro_torch.train.step import build_dist_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout

    dev, lead = group.device, group.rank == 0
    cfg = dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth)
    layout = model_plane_layout(cfg)
    (bucket,) = layout.buckets
    rows = layout.rows[bucket]
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                         per_node_batch=MAIN["per_node_batch"],
                                         n_nodes=group.world))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
               for s in range(SPARSE["steps"])]

    def every(value):
        out = [None] * group.world
        dist.all_gather_object(out, value, group=group.pg)
        return out

    def run(fields, steps, impl="triton", keep_init=False, snap_at=None):
        """``steps`` steps of a ``SPARSE["steps"]``-step schedule; with
        ``snap_at``, the planes, momentum and mask after that step too."""
        tcfg = _res_tcfg(SPARSE["steps"], fields, impl)
        step_fn, channel = build_dist_train_step(cfg, tcfg, group)
        channel.timings = []
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), 1, device=dev,
                                 channel=channel, plane_layout=layout)
        init = state["planes"][bucket].clone() if keep_init else None
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        recs = []
        for k in range(steps):
            staged, sent = channel.staged_bytes, getattr(channel, "sent_bytes", 0)
            vol = ({n: v.clone() for n, v in state["channel"]["rows"]["vol"].items()}
                   if "rows" in state["channel"] else None)
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state, m = step_fn(state, batches[k])
            loss = float(m["loss"])
            torch.cuda.synchronize(dev)
            rec = {"loss": loss, "step_s": time.perf_counter() - t,
                   "gossip_s": channel.timings[-1], "staged": channel.staged_bytes - staged,
                   "launches": fused_stage_launch.launches}
            if vol is not None:
                now = state["channel"]["rows"]["vol"]
                rec["dirty"] = channel.dirty_fractions(state["channel"])[0]
                rec["vol_sparse"] = float(now["sparse"][0] - vol["sparse"][0])
                rec["vol_dense"] = float(now["dense"][0] - vol["dense"][0])
                rec["sent"] = channel.sent_bytes - sent
            recs.append(rec)
            if k == snap_at:
                snap = {"x": state["planes"][bucket].clone(),
                        "m": state["opt"]["m"][bucket].clone(),
                        "dirty": state["channel"]["rows"]["dirty"][bucket][0].clone()}
        rec_peak = torch.cuda.max_memory_allocated(dev)
        per_step = 2 if impl == "triton" else 0  # the plain stage launches no kernel
        ok = (all(math.isfinite(r["loss"]) for r in recs)
              and [r["launches"] for r in recs] == [per_step * (k + 1) for k in range(steps)])
        if not all(every(ok)):
            raise RuntimeError(f"{fields}: non-finite loss or not {per_step} stage launches "
                               f"per step on some rank: "
                               f"{[(r['loss'], r['launches']) for r in recs]}")
        return state, recs, channel, init if snap_at is None else (init, snap), rec_peak

    report = {}
    # exact mode; clean rows keep their initial bits (weight decay 0: an
    # untouched embedding row gets no gradient, and the mix leaves it)
    state, recs, channel, (init, exact), peak = run({"sparse_gossip": True}, SPARSE["steps"],
                                                    keep_init=True,
                                                    snap_at=SPARSE["plain_steps"] - 1)
    report["exact"] = (every(recs), every(peak))
    launches = dict(fused_stage_launch.launches_by_op)
    dirty = state["channel"]["rows"]["dirty"][bucket][0]
    clean = ~dirty
    n_clean = int(clean.sum())
    plane = state["planes"][bucket][0]
    ok = bool(torch.equal(plane[clean].view(torch.int32), init[0][clean].view(torch.int32)))
    if not all(every(ok)) or n_clean == 0:
        raise RuntimeError(f"exact mode: clean rows moved on some rank ({n_clean} clean)")
    tracker = RowTracker.for_model(layout, tied_embeddings=cfg.tie_embeddings)
    report["clean"] = (n_clean, rows, tracker.summary())
    x = state["planes"][bucket]
    del init, state, dirty, clean, plane
    torch.cuda.empty_cache()

    # a dense round on the trained planes (timed); on their first rows, the
    # sparse channel's round with every row dirty == the dense channel's
    topo = build_topology("exp", group.world)
    dense = PpermuteChannel(topo, group)
    dense.timings = []
    dense.apply(dense.init({bucket: x}), {bucket: x}, 0)
    report["dense round"] = every({"gossip_s": dense.timings[-1], "staged": dense.staged_bytes})
    part = x[:, :SPARSE["all_dirty_rows"]]
    _, want = dense.apply(dense.init({bucket: part}), {bucket: part}, 0)
    sp = SparsePpermuteChannel(topo, group)
    st = sp.mark(sp.init({bucket: part}), {bucket: torch.ones(part.shape[1], dtype=torch.bool,
                                                               device=dev)})
    _, got = sp.apply(st, {bucket: part}, 0)
    if not all(every(_same_bits(torch, got[bucket], want[bucket]))):
        raise RuntimeError("exact mode with every row dirty != the dense channel on some rank")
    report["all_dirty_rows"] = part.shape[1]
    del x, part, want, got, dense, sp, st
    torch.cuda.empty_cache()

    # the plain stage in exact mode: the whole state bit for bit (after the
    # kernel run's second step, kept for it)
    state, _, _, _, _ = run({"sparse_gossip": True}, SPARSE["plain_steps"], impl="torch")
    same = (_same_bits(torch, state["planes"][bucket], exact["x"])
            and _same_bits(torch, state["opt"]["m"][bucket], exact["m"])
            and _same_bits(torch, state["channel"]["rows"]["dirty"][bucket][0], exact["dirty"]))
    if not all(every(same)):
        raise RuntimeError("exact mode: --fused-impl torch != triton on some rank")
    del state, exact
    torch.cuda.empty_cache()

    state, recs, _, _, peak = run({"sparse_gossip": True, "sparse_mode": "delta"},
                                  SPARSE["steps"])
    report["delta"] = (every(recs), every(peak))
    for op, k in fused_stage_launch.launches_by_op.items():
        launches[op] = launches.get(op, 0) + k
    # the stage kernel's launches in the two sparse runs, summed over the ranks
    report["launches"] = {op: sum(r.get(op, 0) for r in every(launches))
                          for op in TAIL_OPS}
    del state
    torch.cuda.empty_cache()
    return report if lead else None


def _rows_and_faults_rank(group):
    """Phases 30 and 32 in one spawned group of 4 ranks (one spawn and one
    CUDA context per rank for both): rank 0 returns both reports."""
    t = time.perf_counter()
    sparse = _sparse_rank(group, SPARSE["depth"])
    sparse_s = time.perf_counter() - t
    faults = _res_dist_rank(group, RES_DIST["depth"], RES_DIST["steps"])
    return (sparse, sparse_s, faults) if group.rank == 0 else None


def phase_sparse_main_path(torch):
    """Phase 30 (and phase 32, :func:`_log_dist_faults`, in the same spawned
    group).  Row-sparse gossip, one process per node: 4 ranks sharing the
    card over gloo, qwen3-0.6b at full width cut to 2 layers, decentlam on
    exp, planes, through ``build_dist_train_step``: exact mode and delta
    mode (exact mode at delay 1 is held against the reference by the CPU
    tests).  Per step: the dirty fraction, ``vol``'s sparse and
    dense-equivalent bytes, the bytes sent and staged, gossip seconds, step
    time, each rank's peak memory; beside them one dense round on exact
    mode's trained planes (gossip seconds, bytes staged).  Gates: finite
    losses and 2 stage launches per rank and step in every run; exact mode's
    clean rows keep their initial bits on every rank; the plain stage == the
    kernel in exact mode, the whole state bit for bit; exact mode with every
    row marked == the dense channel on every rank (one round on the
    planes' first rows)."""
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report, sparse_s, faults = run_ranks(_rows_and_faults_rank, MAIN["nodes"],
                                         timeout_s=DIST_TIMEOUT_S)[0]
    group_s = time.perf_counter() - t0
    n_clean, rows, summary = report.pop("clean")
    dense = report.pop("dense round")
    all_dirty_rows = report.pop("all_dirty_rows")
    launches = report.pop("launches")
    emb = next(s for s in summary["sources"] if s["name"] == "embed")
    log(f"phase 30: row-sparse gossip, {MAIN['nodes']} ranks on the card (gloo), "
        f"{MAIN['arch']} full width, {SPARSE['depth']} layers ({rows:,} plane rows per node, "
        f"the untied embedding {emb['rows']:,} of them), decentlam on exp "
        f"({sparse_s:.1f} s in the spawned group, which took {group_s:.1f} s with phase 32):")
    for name, (per_rank, peaks) in report.items():
        log(f"  {name}: losses {[round(r['loss'], 4) for r in per_rank[0]]}, peak memory per "
            f"rank {[round(p / 2**30, 2) for p in peaks]} GiB")
        for k in range(len(per_rank[0])):
            rs = [ranks[k] for ranks in per_rank]
            line = (f"    step {k}: step {rs[0]['step_s'] * 1e3:.1f} ms, gossip "
                    f"{[round(r['gossip_s'], 3) for r in rs]} s, staged "
                    f"{[round(r['staged'] / 1e9, 4) for r in rs]} GB")
            if "dirty" in rs[0]:
                line += (f", dirty {[round(r['dirty'], 4) for r in rs]}, vol sparse "
                         f"{[round(r['vol_sparse'] / 1e9, 4) for r in rs]} GB / dense "
                         f"{[round(r['vol_dense'] / 1e9, 4) for r in rs]} GB, sent "
                         f"{[round(r['sent'] / 1e9, 4) for r in rs]} GB")
            log(line)
    log(f"  exact mode: {n_clean:,} of {rows:,} rows clean after {SPARSE['steps']} steps, "
        f"at their initial bits on every rank; plain stage == kernel (planes, momentum, mask "
        f"after {SPARSE['plain_steps']} steps) bit for bit on every rank; every row dirty == "
        f"the dense channel bit for bit (one round on the trained planes' first "
        f"{all_dirty_rows:,} rows)")
    log(f"  a dense round on exact mode's trained planes: gossip "
        f"{[round(r['gossip_s'], 3) for r in dense]} s, staged "
        f"{[round(r['staged'] / 1e9, 4) for r in dense]} GB per rank")
    # the stage kernel at one rank's plane of this depth
    import dataclasses

    from repro_torch.configs import get_config

    plane = phase_plane_timing(torch, nodes=1, cfg=dataclasses.replace(
        get_config(MAIN["arch"]), n_layers=SPARSE["depth"]))
    for op, p in plane.items():
        lib = "null" if p["library_ms"] is None else f"{p['library_ms']:.3f} ms"
        log(f"  per rank: plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms ({p['bound_ms'] / p['ms']:.1%} of it), plain version "
            f"{p['plain_ms']:.3f} ms, library {lib}, max |kernel - plain| {p['err']:.3g}")
    want = 2 * MAIN["nodes"] * SPARSE["steps"]  # exact and delta, every rank, every step
    if launches != {op: want for op in TAIL_OPS}:
        raise RuntimeError(f"stage launches in the sparse runs over the ranks {launches}, "
                           f"want {want} of each stage")
    log(f"  stage launches in the exact and delta runs, over the ranks: {launches}")
    _log_dist_faults(faults)
    return {"launches": launches, "plane": plane}


def phase_resilience_main_path(torch, flat):
    """The fault-tolerant runtime on phase 15's run (qwen3-0.6b at full
    width and depth, 4 stacked nodes, planes, the stage kernel): an empty
    ChaosSchedule and the resilient layer with no fault equal the unwrapped
    run bit for bit over 3 steps; silence on node 1 for steps 2..13 under
    the resilient layer and the host's health monitor (its states per step,
    node 1 distrusted while SUSPECT or DEAD, one round's mix on a slice ==
    healed_W @ x in float64, node 1 rejoining from a materialized snapshot
    of node 0 after the window) and, in the same run, a NaN round from node
    2 quarantined with every parameter finite; 2 launches per step; at 4
    layers the plain stage
    == the kernel under chaos and the resilient layer, the whole state bit
    for bit."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import StackedChannel
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.topology import build_topology
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch.train import _Health, _parse_chaos
    from repro_torch.resilience import (
        ChaosChannel,
        ChaosSchedule,
        ResilientChannel,
        healed_W,
        rejoin_node,
        with_trust,
    )
    from repro_torch.serve import WeightPublisher
    from repro_torch.train.step import build_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout
    from repro_torch.utils import tree_leaves

    n, dev = MAIN["nodes"], torch.device("cuda")
    t_phase = time.perf_counter()

    def run(cfg, fields, steps, impl="triton", hook=None):
        layout = model_plane_layout(cfg)
        tcfg = _res_tcfg(steps, fields, impl)
        step_fn, channel = build_train_step(cfg, tcfg, n)
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), n, device=dev,
                                 channel=channel, plane_layout=layout)
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                             per_node_batch=MAIN["per_node_batch"], n_nodes=n))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, times, launches = [], [], []
        for k in range(steps):
            batch = {key: torch.from_numpy(v).to(dev) for key, v in data.batch(k).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches.append(fused_stage_launch.launches)
            if hook is not None:
                state = hook(k, state, channel, layout)
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"{fields}: losses {losses}")
        per_step = 2 if impl == "triton" else 0  # the plain stage launches no kernel
        if launches != [per_step * (k + 1) for k in range(steps)]:
            raise RuntimeError(f"{fields}: stage launches after each step {launches}, want "
                               f"{per_step} per step")
        return state, losses, times, torch.cuda.max_memory_allocated()

    cfg = get_config(MAIN["arch"])
    steady = lambda ts: 1e3 * sum(ts[1:]) / max(len(ts) - 1, 1)  # noqa: E731

    # the unwrapped run, its final planes kept on the host
    state, base_losses, times, peak = run(cfg, {}, RES["steps"])
    (bucket,) = state["planes"]
    host = {"x": state["planes"][bucket].cpu(), "m": state["opt"]["m"][bucket].cpu()}
    rows = [f"unwrapped {steady(times):.1f} ms/step, peak {peak / 2**30:.2f} GiB"]
    del state
    torch.cuda.empty_cache()
    for name, fields in (("an empty ChaosSchedule", {"chaos": ChaosSchedule()}),
                         ("--resilient with no fault", {"resilient": True})):
        state, losses, times, peak = run(cfg, fields, RES["steps"])
        same = (losses == base_losses
                and _bits_equal_chunked(torch, state["planes"][bucket], host["x"])
                and _bits_equal_chunked(torch, state["opt"]["m"][bucket], host["m"]))
        if not same:
            raise RuntimeError(f"{name}: not the unwrapped run bit for bit ({losses} vs "
                               f"{base_losses})")
        rows.append(f"{name} == unwrapped bit for bit (losses, parameter and momentum "
                    f"planes), {steady(times):.1f} ms/step, peak {peak / 2**30:.2f} GiB")
        del state
        torch.cuda.empty_cache()
    del host
    # one gossip round on the full plane, alone: the stacked channel and the
    # resilient layer around it (clean: every peer trusted, every payload
    # finite)
    gen = torch.Generator(device="cuda").manual_seed(31)
    shape = (n, model_plane_layout(cfg).rows[bucket], 1024)
    x = torch.randn(shape, generator=gen, device=dev)
    topo = build_topology("exp", n)
    round_ms = {}
    for name, ch in (("stacked", StackedChannel(topo)),
                     ("resilient", ResilientChannel(StackedChannel(topo)))):
        st = ch.init(x)
        st, y = ch.apply(st, x, 0)
        del y
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            st, y = ch.apply(st, x, 0)
            del y
        torch.cuda.synchronize()
        round_ms[name] = 1e3 * (time.perf_counter() - t) / 3
        del st
    del x
    torch.cuda.empty_cache()
    rows.append(f"one round on the {shape} plane alone: stacked "
                f"{round_ms['stacked']:.2f} ms, resilient around it {round_ms['resilient']:.2f} "
                "ms (host clock, 3 rounds between syncs)")
    log(f"phase 31: {MAIN['arch']} full width and depth x {n} nodes, planes, {RES['steps']} "
        f"steps: " + "; ".join(rows) + f" (phase 15: {flat['step_ms']:.1f} ms/step, peak "
        f"{flat['peak'] / 2**30:.2f} GiB)")

    # silence on node 1, healed: the monitor's states, the trust mask, one
    # round's healed mix, the rejoin from node 0's snapshot; in the same run
    # a NaN round from node 2, quarantined (a poisoned payload is no missed
    # round: node 2's version gaps, and so its state, stay those of a live
    # peer)
    lo, hi = RES["window"]
    nlo, nhi = RES["nan_window"]
    spec = f"silence,nodes=1,start={lo},stop={hi}"
    nan_spec = f"nan,nodes=2,frac=0.001,start={nlo},stop={nhi},prob=1"
    sched = _parse_chaos([spec, nan_spec], 0)
    health = _Health(1, n, lead=False)
    trusts, checks = [], {}
    topo = build_topology("exp", n)

    def hook(k, state, channel, layout):
        state = health(k, state, channel)
        trust = channel._vec(state["channel"]["res"]["trust"]).copy()
        trusts.append(trust)
        if k == lo + 2:  # node 1 distrusted: one round on a slice of the planes
            x = state["planes"][bucket][:, :4096].clone()
            ch = ResilientChannel(ChaosChannel(StackedChannel(topo), sched))
            st = with_trust(ch.init(x), trust)
            st["in"]["x"]["round"].fill_(k + 1)
            _, y = ch.apply(st, x, k + 1)
            want = torch.from_numpy(healed_W(topo, k + 1, trust)).to(dev) @ x.reshape(n, -1).double()
            err = float((y.reshape(n, -1).double() - want).abs().max() / want.abs().max())
            if not err <= 1e-6:
                raise RuntimeError(f"healed mix off healed_W @ x by {err:.3g} of scale")
            checks["healed"] = err
        if k == hi - 1:  # the window closes: node 1 rejoins from node 0's snapshot
            t = time.perf_counter()
            pub = WeightPublisher(layout, gap_threshold=0)
            pub.offer({b: p[0] for b, p in state["planes"].items()}, version=k + 1, gap=0)
            snap = pub.current.materialize()
            del pub
            state = rejoin_node(state, 1, snap.planes, params_key="planes", reset=("opt",))
            ok = (_same_bits(torch, state["planes"][bucket][1], snap.planes[bucket].to(dev))
                  and not bool(state["opt"]["m"][bucket][1].any()))
            del snap
            if not ok:
                raise RuntimeError("rejoin: node 1's plane != the snapshot or momentum not zero")
            health.monitor.report_alive([1])
            state = {**state, "channel": with_trust(state["channel"], health.monitor.trust)}
            health.applied = health.monitor.trust.copy()
            checks["rejoin_s"] = time.perf_counter() - t
        return state

    state, losses, times, peak = run(cfg, {"chaos": sched, "resilient": True},
                                     RES["fault_steps"], hook=hook)
    states = [s for _, s in health.states]
    want = ([["alive"] * n] * lo + [["alive", "suspect", "alive", "alive"]] * 8
            + [["alive", "dead", "alive", "alive"]] * (hi - lo - 8)
            + [["alive"] * n] * (RES["fault_steps"] - hi))
    if states != want:
        raise RuntimeError(f"health states {states} != {want}")
    bad_trust = [k for k, (t, s) in enumerate(zip(trusts, states)) if t[1] != (s[1] == "alive")]
    if bad_trust or trusts[-1].tolist() != [True] * n:
        raise RuntimeError(f"node 1's trust does not follow its state at steps {bad_trust}")
    quar = [int(v) for v in state["channel"]["res"]["quarantined"].cpu()]
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["planes"]))
    if not (sum(quar) > 0 and finite):
        raise RuntimeError(f"NaN round: quarantined {quar}, parameters finite {finite}")
    log(f"phase 31: --chaos '{spec}' --chaos '{nan_spec}' --resilient, {RES['fault_steps']} "
        f"steps: losses "
        f"{[round(v, 4) for v in losses]}; node 1's state per step "
        f"{[s[1] for s in states]} (SUSPECT from its first missed round, DEAD after 3 + 6 "
        f"suspect rounds, trusted only while ALIVE); one round on rows 0..4095 == healed_W @ "
        f"x within {checks['healed']:.3g} of scale (float64); rejoined after step {hi - 1} "
        f"from node 0's materialized snapshot in {checks['rejoin_s']:.2f} s (plane == "
        f"snapshot, momentum zero), losses after it {[round(v, 4) for v in losses[hi:]]}; "
        f"{steady(times):.1f} ms/step (phase 15: {flat['step_ms']:.1f}), peak "
        f"{peak / 2**30:.2f} GiB; 2 stage launches per step; the NaN round from node 2 "
        f"quarantined per node {quar}, every parameter finite")
    del state
    torch.cuda.empty_cache()

    # the plain stage == the kernel under chaos and the resilient layer
    small = dataclasses.replace(cfg, n_layers=RES["plain_depth"])
    faults = _parse_chaos(["silence,nodes=1,start=1,stop=3", "nan,nodes=2,frac=0.01,prob=1,"
                           "start=2,stop=3", "dup,prob=0.3"], 0)
    finals = {}
    for impl in ("triton", "torch"):
        st, ls, _, _ = run(small, {"chaos": faults, "resilient": True}, RES["steps"], impl)
        finals[impl] = (ls, [t.clone() for t in tree_leaves(
            {"p": st["planes"], "o": st["opt"], "c": st["channel"]}) if t.is_cuda])
        del st
    (la, ta), (lb, tb) = finals["triton"], finals["torch"]
    if la != lb or len(ta) != len(tb) or not all(_same_bits(torch, a, b) for a, b in zip(ta, tb)):
        raise RuntimeError("chaos + resilient: the plain stage != the kernel")
    log(f"phase 31: at {RES['plain_depth']} layers, {RES['steps']} steps under silence, NaN "
        f"and dup faults with --resilient: --fused-impl torch == triton bit for bit (losses, "
        f"planes, momentum, the channel's device state: {len(ta)} tensors); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del finals, ta, tb
    torch.cuda.empty_cache()


def _res_dist_rank(group, depth, steps):
    """The body of phase 32 on one rank: the distributed step under the
    chaos schedule and the resilient layer with the CLI's health loop; rank
    0 runs the stacked step under the same schedule and loop, and each rank
    holds its node against the stacked run's (:func:`_node_errors`)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.train import _Health, _parse_chaos
    from repro_torch.resilience import fleet_sender_gaps
    from repro_torch.train.step import build_dist_train_step, build_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout

    dev, lead = group.device, group.rank == 0
    cfg = _check_config(dataclasses.replace(get_config(MAIN["arch"]), n_layers=depth))
    layout = model_plane_layout(cfg)
    tcfg = _res_tcfg(steps, {"chaos": _parse_chaos(list(RES_DIST["chaos"]), 0),
                             "resilient": True})
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                         per_node_batch=MAIN["per_node_batch"],
                                         n_nodes=group.world))

    def run(build, n):
        step_fn, channel = build()
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), n, device=dev,
                                 channel=channel, plane_layout=layout)
        health = _Health(1, group.world, lead=False)
        losses, gaps = [], []
        for k in range(steps):
            batch = {key: torch.from_numpy(v).to(dev) for key, v in data.batch(k).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            gaps.append(fleet_sender_gaps(channel, state["channel"]).tolist())
            state = health(k, state, channel)
        return state, losses, gaps, [s for _, s in health.states]

    t0 = time.perf_counter()
    state, losses, gaps, states = run(lambda: build_dist_train_step(cfg, tcfg, group), 1)
    dist_s = time.perf_counter() - t0
    mine = _comparable(state, layout)
    del state
    torch.cuda.empty_cache()
    sstate = want = None
    if lead:
        sstate, slosses, sgaps, sstates = run(lambda: build_train_step(cfg, tcfg, group.world),
                                              group.world)
        want = _comparable(sstate, layout)
        torch.cuda.synchronize(dev)
    errs = _node_errors(group, mine, want)
    del sstate, want, mine
    torch.cuda.empty_cache()
    if not lead:
        return None
    tols = {"params": 2e-5, "opt": 2e-5 / RES_LR}
    if (gaps != sgaps or states != sstates or errs is None
            or not all(errs[p] < tols[p] for p in errs)):
        raise RuntimeError(f"distributed vs stacked under chaos: gaps {gaps} vs {sgaps}, "
                           f"states {states} vs {sstates}, errors {errs} (tol {tols})")
    return {"losses": losses, "stacked": slosses, "gaps": gaps, "states": states,
            "errs": errs, "dist_s": dist_s}


def _log_dist_faults(r):
    """Phase 32's report (run in phase 30's spawned group): chaos and the
    resilient layer on 4 ranks sharing the card (gloo), 2 layers, 4 steps,
    with the CLI's schedule parser and health loop: the sender gaps every
    rank gathers (``fleet_sender_gaps``) and the monitor's states equal the
    stacked run's, and the final parameters and optimizer state are within
    the reference's distributed-vs-oracle tolerance of it (every rank draws
    the same fires from the hash)."""
    log(f"phase 32: {MAIN['nodes']} ranks (gloo), {RES_DIST['depth']} layers, vocabulary "
        f"{CHECK_VOCAB:,}, "
        f"{RES_DIST['steps']} steps, --chaos " + " --chaos ".join(f"'{c}'" for c in
                                                                  RES_DIST["chaos"])
        + f" --resilient: losses {[round(v, 4) for v in r['losses']]} (stacked "
        f"{[round(v, 4) for v in r['stacked']]}); sender gaps per step {r['gaps']} == the "
        f"stacked run's; monitor states {r['states']} == the stacked run's; max |distributed "
        f"- stacked| {r['errs']['params']:.3g} over the parameters (< 2e-5), "
        f"{r['errs']['opt']:.3g} over the optimizer state (< 2e-5 / lr); the distributed run "
        f"{r['dist_s']:.1f} s")


# ---------------------------------------------------------------------------
# phases 33-35: tensor parallelism on a (nodes x tp) grid of ranks sharing the
# card over gloo (every collective staged through host memory), and serving
# while training on the one-process-per-node trainer
# ---------------------------------------------------------------------------

# phase 33: qwen3-0.6b at full width and depth, tp 2 on 2 ranks, f32, flash
TP_SERVE = dict(arch="qwen3-0.6b", tp=2, slots=8, requests=8, min_prompt=256,
                max_prompt=2048, max_new=16, checked=4)
TP_RTOL = 5e-4  # tests/scripts/distributed_serve.py's sharded-vs-tp=1 tolerance
# phase 34: 2 nodes x tp 2 = 4 ranks at full width and depth, planes, 2 steps
TP_TRAIN = dict(nodes=2, tp=2, steps=2)
TP_TRAIN_RTOL = 1e-5  # the final parameters, relative to each leaf's scale
TP_DIR = os.path.join(HERE, "build", "tp_smoke")
# phase 35: --serve-while-training on 2 ranks, 4 layers, the vocabulary cut
SWT_DIST = dict(nodes=2, depth=4, steps=4, publish_every=2, requests=8)
# phases 37-40: tensor parallelism for the rest of the zoo, at published
# width, each path's ranks sharing the card over gloo as phases 33-35's.
# Phase 37: granite-moe-1b-a400m trained at 2 nodes x tp 2 in expert mode
# (16 of 32 experts a rank), cut to phase 24's 12 of 24 layers: the tp 1
# run's two full-depth nodes (~30 GB each with momentum, gradient and
# gossip planes) beside the tp ranks' kept planes would not fit the card
TP_MOE = dict(arch="granite-moe-1b-a400m", depth=12, nodes=2, tp=2, steps=2,
              per_node_batch=MAIN["per_node_batch"], seq_len=MAIN["seq_len"])
# phases 38-39: xlstm-350m and hymba-1.5b at full depth behind the engine at
# tp 2 (phase 33's requests), beside the tp 1 engine; the launches a wave
# and rank of each one's kernel
# phases 38-39 hold tp 2 against tp 1 at TP_RTOL, or, where it is larger, at
# ZOO_FLOOR_X times the spread of two tp 1 runs that differ only in their f32
# summation order (the kernels and their plain versions): xlstm-350m's 24
# random-init layers amplify f32 rounding ~1e3-fold (tp 1 kernel vs plain
# 4.8e-3 of the logits' scale at 64 tokens, 1.0e-2 at 2048; 3e-6 at 6
# layers, on an H100 80GB HBM3), so xlstm-350m is also held at TP_RTOL at 6
# layers (phase 12's depth); (kernel, launches a wave at full depth, the
# depth of that tight check or 0)
TP_ZOO_SERVE = dict(TP_SERVE, max_new=8)  # phase 33's with 8 new tokens (the script's time)
TP_ZOO_ARCHS = {"xlstm-350m": ("mlstm", 20, 6), "hymba-1.5b": ("flash", 32, 0)}
ZOO_FLOOR_X = 10
# phase 40: internvl2-2b at full depth with its 256 patch embeddings spliced
# over a 512-token prompt, 8 rows, then 4 teacher-forced decode steps, at
# tp 2 beside tp 1; whisper-tiny trained at 1 node x tp 2, full depth, 1500
# seeded frames a row, beside the tp 1 run
TP_VLM = dict(arch="internvl2-2b", batch=8, prompt=512, decode=4)
TP_WHISPER = dict(arch="whisper-tiny", depth=0, nodes=1, tp=2, steps=2, per_node_batch=4,
                  seq_len=256)
# the mlstm_chunk kernel at a tp 2 rank of phase 38: each rank's dv = 256 of 512
ML_TP = dict(B=8, H=4, S=2048, dk=512, dv=256, chunk=128)


def _tp_requests(vocab, spec=None):
    import numpy as np

    from repro_torch.serve import Request

    spec = spec or TP_SERVE
    rng = np.random.default_rng(0)
    lens = rng.integers(spec["min_prompt"], spec["max_prompt"] + 1, spec["requests"])
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=spec["max_new"]) for i, n in enumerate(lens)]


def _tp_engine_run(torch, cfg, make_params, grid, spec=None, floor=False):
    """The phase-33 engine (``spec``: TP_SERVE's fields) over
    ``make_params()`` (the global tree, freed once the engine holds its
    shard) on ``grid`` (None: one process, tp = 1), with the flash and
    mLSTM kernels: the first wave's prefill logits and the first
    ``checked`` decode batches' logits (gathered, on the host), prefill and
    decode wall ms, flash and mLSTM launches, tokens, peak memory (the
    rank's and the card's in use), and the steps' model-group collectives.
    With ``floor`` (tp = 1) also the first wave's prefill logits on the
    plain attention and mLSTM paths (``plain_prefill``): two tp = 1 runs that
    differ only in their f32 summation order, the spread a tp run's sums in
    another order can be held to."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_launch,
        reset_launches,
    )
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_launch
    from repro_torch.kernels.mlstm_chunk.kernel import reset_launches as reset_mlstm
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve import gather_logits

    spec = spec or TP_SERVE
    slots = spec["slots"]
    rec = {"decode": [], "prefill_ms": [], "decode_ms": [], "card": 0, "active": []}

    def on_logits(lg, active):
        if len(rec["decode"]) < spec["checked"]:  # numpy: it leaves the rank
            rec["decode"].append(lg.float().cpu().numpy())
            rec["active"].append(dict(active))

    params = make_params()
    engine = ServeEngine(cfg, slots=slots, max_prompt=spec["max_prompt"],
                         max_new=spec["max_new"], params=params, device="cuda", grid=grid,
                         timing=grid is not None, on_logits=on_logits,
                         runtime=RuntimeConfig(dtype="float32", attn_impl="cuda",
                                               mlstm_impl="cuda"))
    del params
    torch.cuda.empty_cache()
    pre, dec = engine.prefill_step, engine.decode_step

    def card():
        free, total = torch.cuda.mem_get_info()
        rec["card"] = max(rec["card"], total - free)

    def prefill(p, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = pre(p, b)
        torch.cuda.synchronize()
        rec["prefill_ms"].append(1e3 * (time.perf_counter() - t))
        card()
        if "prefill" not in rec:
            rec["prefill"] = gather_logits(lg, grid, global_batch=slots).float().cpu().numpy()
            if floor:
                rec["wave"] = b["tokens"]
        return lg, cache

    def decode(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dec(*args)
        torch.cuda.synchronize()
        rec["decode_ms"].append(1e3 * (time.perf_counter() - t))
        return out

    engine.prefill_step, engine.decode_step = prefill, decode
    for r in _tp_requests(cfg.vocab_size, spec):
        engine.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_mlstm()
    done = engine.run_until_drained()
    card()
    if floor:
        from repro_torch.train.serve import ServeConfig, build_prefill_step

        plain = build_prefill_step(cfg, ServeConfig(runtime=RuntimeConfig(dtype="float32"),
                                                    target_len=spec["max_prompt"]
                                                    + spec["max_new"]))
        lg, _ = plain(engine._params, {"tokens": rec.pop("wave")})
        rec["plain_prefill"] = lg.float().cpu().numpy()
        del lg
    rec.update(flash=flash_attention_launch.launches, mlstm=mlstm_chunk_launch.launches,
               waves=engine.prefills,
               tokens={c.rid: c.tokens.tolist() for c in done},
               peak=torch.cuda.max_memory_allocated(),
               tp={k: None if f.tp is None else (f.tp.seconds, f.tp.calls, f.tp.staged_bytes)
                   for k, f in (("prefill", pre), ("decode", dec))})
    return rec


def _tp_serve_rank(world):
    """Phase 33 on one of the 2 ranks: the engine on the (1 x 2) grid; then
    rank 0 alone runs the tp = 1 engine on the same weights.  Rank 0
    returns both records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T

    grid = init_grid(world, TP_SERVE["tp"])
    cfg = get_config(TP_SERVE["arch"])

    def make():  # the same global tree at every call
        return T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             tp=TP_SERVE["tp"])

    mine = _tp_engine_run(torch, cfg, make, grid)
    if world.rank:
        return mine
    torch.cuda.empty_cache()
    return mine, _tp_engine_run(torch, cfg, make, None)


def _tp_compare(tp, ref, rtol=TP_RTOL):
    """Phase 33's gates on rank 0's two records: the first wave's logits,
    then each slot's decode logits while its tokens agree (where they part,
    the tp = 1 run's own top-two gap there must be under the tolerance
    ``rtol``: a near tie).  Returns the largest relative differences."""
    import numpy as np

    def rel(a, b):
        return float(np.abs(a[..., :b.shape[-1]] - b).max() / np.abs(b).max())

    # a tp run's logits carry the vocabulary's padding for tp past the tp = 1
    # run's columns
    errs = {"prefill": rel(tp["prefill"], ref["prefill"])}
    if not errs["prefill"] <= rtol:
        raise RuntimeError(f"TP prefill logits off the tp = 1 engine's by {errs['prefill']:.3g}"
                           f" (rtol {rtol:.3g})")
    parted, dec = {}, []
    for s, (a, b) in enumerate(zip(tp["decode"], ref["decode"])):
        scale = float(np.abs(b).max())
        for j in sorted(ref["active"][s]):
            if j in parted:
                continue
            a_j = a[j][:b.shape[-1]]
            dec.append(float(np.abs(a_j - b[j]).max()) / scale)
            if dec[-1] > rtol:
                raise RuntimeError(f"decode step {s}, slot {j}: logits off by {dec[-1]:.3g}")
            if int(a_j.argmax()) != int(b[j].argmax()):
                top = np.sort(b[j])[::-1][:2]
                if float(top[0] - top[1]) > rtol * scale:
                    raise RuntimeError(f"decode step {s}, slot {j}: the tokens part at a gap "
                                       f"{float(top[0] - top[1]):.3g} (no near tie)")
                parted[j] = s
    errs["decode"], errs["parted"] = max(dec), parted
    return errs


def phase_tp_serve(torch):
    """Phase 33: tensor-parallel serving.  qwen3-0.6b at full width and
    depth behind the engine on a (1 x 2) grid: 2 ranks sharing the card over
    gloo (every model-group collective staged through host memory), f32, the
    flash kernel at each rank's 8 q heads and 4 kv heads; 8 slots, 8
    requests of 256..2048 prompt tokens, 16 new each.  Gates: the first
    wave's logits and the first 4 decode steps' against the tp = 1 engine on
    the same weights at 5e-4 relative; every request completes on both
    ranks with the same tokens; 28 flash launches per wave on each rank.
    Prints prefill ms per wave, decode ms per step, the collectives' seconds,
    count and staged bytes per decode step, peak memory per rank and the
    card's."""
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    out = run_ranks(_tp_serve_rank, TP_SERVE["tp"], device="cuda", timeout_s=DIST_TIMEOUT_S)
    (tp0, ref), tp1 = out[0], out[1]
    errs = _tp_compare(tp0, ref)
    from repro_torch.configs import get_config

    cfg_layers = get_config(TP_SERVE["arch"]).n_layers
    for r, rec in enumerate((tp0, tp1)):
        if rec["flash"] != cfg_layers * rec["waves"] or rec["waves"] != 1:
            raise RuntimeError(f"rank {r}: {rec['flash']} flash launches in {rec['waves']} "
                               f"waves, want {cfg_layers} per wave")
        if len(rec["tokens"]) != TP_SERVE["requests"]:
            raise RuntimeError(f"rank {r}: {len(rec['tokens'])} of {TP_SERVE['requests']} done")
    if tp0["tokens"] != tp1["tokens"]:
        raise RuntimeError("the two ranks generated different tokens")
    same = sum(tp0["tokens"][k] == ref["tokens"][k] for k in ref["tokens"])
    steps = len(tp0["decode_ms"])
    sec, calls, staged = tp0["tp"]["decode"]
    psec, pcalls, pstaged = tp0["tp"]["prefill"]
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    log(f"phase 33: {TP_SERVE['arch']} full width and depth, tp {TP_SERVE['tp']} on 2 ranks "
        f"sharing the card (gloo, staged through host memory), f32, flash: "
        f"{TP_SERVE['requests']} requests of {TP_SERVE['min_prompt']}..{TP_SERVE['max_prompt']}"
        f" prompt tokens, {TP_SERVE['max_new']} new; all complete on both ranks with the same "
        f"tokens ({same} of {len(ref['tokens'])} requests token for token as the tp = 1 "
        f"engine); flash launches per rank {tp0['flash']}, {tp1['flash']} in 1 wave (28 per "
        f"wave)")
    log(f"  against the tp = 1 engine on the same weights: prefill logits max rel diff "
        f"{errs['prefill']:.3g}, the first {TP_SERVE['checked']} decode steps "
        f"{errs['decode']:.3g} (rtol {TP_RTOL}); slots whose tokens parted at a near tie "
        f"{errs['parted'] or 'none'}")
    log(f"  prefill {mean(tp0['prefill_ms']):.1f} ms per wave (tp = 1: "
        f"{mean(ref['prefill_ms']):.1f}); its collectives {psec:.3f} s, {pcalls} calls, "
        f"{pstaged / 1e9:.3f} GB staged; decode {mean(tp0['decode_ms'][1:]):.1f} ms per step "
        f"(steps 1..{steps - 1}; tp = 1: {mean(ref['decode_ms'][1:]):.1f}); the model group's "
        f"collectives per decode step {sec / steps * 1e3:.1f} ms (each after a device sync), "
        f"{calls / steps:.0f} calls, {staged / steps / 1e6:.2f} MB staged (device -> host and "
        "back)")
    log(f"  peak memory per rank {tp0['peak'] / 2**30:.2f}, {tp1['peak'] / 2**30:.2f} GiB "
        f"(tp = 1: {ref['peak'] / 2**30:.2f}); the card in use at most "
        f"{max(tp0['card'], tp1['card']) / 2**30:.2f} GiB")
    return {"flash": tp0["flash"], "errs": errs}


def _tp_keep(store, steps, step, state, metrics):
    """``on_step`` of phase 34's runs: the stage launches by op after each
    step, and the final parameter planes (kept alive in ``store``)."""
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch

    store.setdefault("launches", []).append(dict(fused_stage_launch.launches_by_op))
    if step == steps - 1:
        store["planes"] = state["planes"]


def _tp_train_rank(world, argv_tp, argv_one, spec=None):
    """Phase 34 on one of 4 ranks: the CLI's rank body at (2 x 2); then on
    ranks 0 and 1 the tp = 1 run of the same flags (2 nodes, one each), and
    each tp rank holds its shard of its node's final parameters against the
    tp = 1 node's (read through a CUDA IPC handle: the ranks share the
    card).  ``spec`` (default TP_TRAIN with TP_SERVE's arch) sets the arch,
    its depth (0: the published one), the nodes, tp and steps.  Returns
    each run's result and the comparison."""
    import dataclasses

    import functools
    import io
    import pickle
    from multiprocessing.reduction import ForkingPickler

    import torch
    import torch.distributed as dist
    import torch.multiprocessing  # noqa: F401  (the CUDA tensor reductions)

    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_update.kernel import reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import subgroup
    from repro_torch.train.train_state import model_plane_layout
    from repro_torch.utils import tree_leaves, tree_map, tree_paths

    spec = spec or {**TP_TRAIN, "arch": TP_SERVE["arch"], "depth": 0}
    steps, tp = spec["steps"], spec["tp"]
    keep_tp, keep_one = {}, {}
    reset_launches()
    res_tp = train.rank_main(world, argv_tp, functools.partial(_tp_keep, keep_tp, steps))
    torch.cuda.empty_cache()
    node, m = divmod(world.rank, tp)
    sub = subgroup(world, list(range(spec["nodes"])))
    res_one = None
    if sub is not None:
        reset_launches()
        res_one = train.rank_main(sub, argv_one, functools.partial(_tp_keep, keep_one, steps))
    blob = None
    if sub is not None:
        buf = io.BytesIO()
        ForkingPickler(buf, pickle.HIGHEST_PROTOCOL).dump(keep_one["planes"])
        blob = buf.getvalue()
    blobs = [None] * world.world
    dist.all_gather_object(blobs, blob)
    theirs = keep_one["planes"] if node == world.rank else pickle.loads(blobs[node])
    cfg = get_config(spec["arch"])
    if spec["depth"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["depth"])
    one, lay = model_plane_layout(cfg), model_plane_layout(cfg, tp)
    # the tp = 1 node's leaves padded to tp's global shapes (the vocabulary
    # and the q heads pad at their ends), cut to this rank's shard; the
    # padding, which tp = 1 has not, is masked out of the comparison
    glob = lay.global_template()

    def padded(x, like, fill):
        pads = [p for n, full in zip(reversed(x.shape[1:]), reversed(like.shape))
                for p in (0, full - n)]
        return torch.nn.functional.pad(x, pads, value=fill)

    tree1 = one.view_unpack(theirs, leading=1)
    want = lay.shard_slice(tree_map(lambda x, g: padded(x, g, 0.0), tree1, glob), m, leading=1)
    mask = lay.shard_slice(tree_map(lambda x, g: padded(torch.ones_like(x), g, 0.0), tree1,
                                    glob), m, leading=1)
    got = lay.view_unpack(keep_tp["planes"], leading=1)
    diffs = [float(((a - b) * k).abs().max()) for a, b, k in
             zip(tree_leaves(got), tree_leaves(want), tree_leaves(mask))]
    err = max(d / float(b.abs().max().clamp(min=1e-30))
              for d, b in zip(diffs, tree_leaves(want)))
    worst = max(zip(diffs, tree_paths(got)))
    del theirs, want, got, mask, tree1
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.ipc_collect()
    return {"tp": res_tp, "one": res_one, "err": err, "worst": worst,
            "launches": (keep_tp["launches"], keep_one.get("launches"))}


def _tp_train_argv(spec, tag):
    """The CLI flags of a TP train phase's two runs (``spec``: arch, depth,
    nodes, tp, steps, per_node_batch, seq_len), its measurements under
    TP_DIR/``tag``-*.json: ``(argv at tp, argv at tp = 1)``."""
    flags = ["--simulate-nodes", str(spec["nodes"]), "--arch", spec["arch"],
             "--steps", str(spec["steps"]), "--seq-len", str(spec["seq_len"]),
             "--per-node-batch", str(spec["per_node_batch"]), "--algorithm", "decentlam",
             "--topology", "exp", "--flat-planes", "--fused-update", "--fused-impl", "triton",
             "--log-every", "1"] + (["--depth", str(spec["depth"])] if spec["depth"] else [])
    return (flags + ["--tp", str(spec["tp"]), "--measure-json",
                     os.path.join(TP_DIR, f"{tag}-tp.json")],
            flags + ["--measure-json", os.path.join(TP_DIR, f"{tag}-one.json")])


def _tp_train_check(torch, out, spec, phase):
    """A TP train phase's gates on its ranks' results (see
    :func:`phase_tp_train`), its log lines and the rank plane's stage
    timing.  Returns the phase's record."""
    import dataclasses

    from repro_torch.configs import get_config

    res, one = out[0]["tp"], out[0]["one"]
    steps, world = spec["steps"], spec["nodes"] * spec["tp"]
    if not all(math.isfinite(v) for v in res["losses"] + one["losses"]):
        raise RuntimeError(f"losses {res['losses']}, tp = 1 {one['losses']}")
    # each op once per rank and step, in both runs (the tp = 1 run on the
    # first `nodes` ranks only)
    want = [{op: k + 1 for op in TAIL_OPS} for k in range(steps)]
    for r, o in enumerate(out):
        if o["launches"][0] != want or (o["launches"][1] not in (None, want)):
            raise RuntimeError(f"rank {r}: stage launches by op after each step "
                               f"{o['launches']}, want {want}")
    # the tp run's launches of each op, summed over the ranks
    launches = {op: sum(o["launches"][0][-1][op] for o in out) for op in TAIL_OPS}
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], one["losses"]))
    err = max(o["err"] for o in out)
    if not (rel <= 1e-5 and err <= TP_TRAIN_RTOL):
        raise RuntimeError(f"tp {spec['tp']} against tp 1: losses rel {rel:.3g}, parameters "
                           f"{err:.3g} of scale (worst {[o['worst'] for o in out]})")
    cfg = get_config(spec["arch"])
    if spec["depth"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["depth"])
    depth = f"{spec['depth']} of {get_config(spec['arch']).n_layers} layers" if spec[
        "depth"] else "full depth"
    log(f"phase {phase}: {spec['arch']} full width, {depth}, {spec['nodes']} nodes x "
        f"{spec['tp']}-way TP = {world} ranks sharing the card ({res['backend']}), planes, "
        f"decentlam on exp, {spec['per_node_batch']} x {spec['seq_len']} tokens a node, "
        f"{steps} steps: losses {res['losses']} (tp = 1 on {spec['nodes']} rank(s): "
        f"{one['losses']}, max rel {rel:.3g}); each rank's shard of its node's final "
        f"parameters within {err:.3g} of scale of the tp = 1 run's (tol {TP_TRAIN_RTOL}); "
        f"stage launches by op after each step, rank 0's {out[0]['launches'][0]}, summed over "
        f"the {world} ranks {launches}")
    times = [round(t, 3) for t in res["step_times_s"]]
    log(f"  step {1e3 * res['step_s']:.1f} ms (step times {times}; tp = 1: "
        f"{1e3 * one['step_s']:.1f} ms); gossip per rank and round "
        f"{[round(t, 3) for t in res['gossip_s_per_round']]} s, staged "
        f"{[round(b / 1e9, 3) for b in res['staged_bytes_per_round']]} GB (tp = 1: "
        f"{[round(t, 3) for t in one['gossip_s_per_round']]} s, "
        f"{[round(b / 1e9, 3) for b in one['staged_bytes_per_round']]} GB)")
    log(f"  the model group's collectives per rank and step (each after a device sync): "
        f"{[round(t, 3) for t in res['tp_s_per_step']]} s, "
        f"{[round(c) for c in res['tp_calls_per_step']]} calls, "
        f"{[round(b / 1e9, 3) for b in res['tp_staged_bytes_per_step']]} GB staged")
    log(f"  peak memory per rank {[round(p / 2**30, 2) for p in res['peak_mem_bytes_by_rank']]} "
        f"GiB (tp = 1: {[round(p / 2**30, 2) for p in one['peak_mem_bytes_by_rank']]}); the "
        f"card in use at most {res['card_used_bytes'] / 2**30:.2f} GiB (tp = 1 run: "
        f"{one['card_used_bytes'] / 2**30:.2f}, the tp planes kept beside it)")
    plane = phase_plane_timing(torch, nodes=1, cfg=cfg, tp=spec["tp"])
    fmt = lambda v: "null" if v is None else f"{v:.3f} ms"  # noqa: E731
    for op, p in plane.items():
        log(f"  a tp rank's plane {op} on {p['shape']} f32: kernel {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms by {p['bound_by']} ({p['bound_ms'] / p['ms']:.1%} of it), "
            f"plain version {p['plain_ms']:.3f} ms, library {fmt(p['library_ms'])}, max "
            f"|kernel - plain| {p['err']:.3g}")
    return {"res": res, "one": one, "plane": plane, "launches": launches}


def phase_tp_train(torch, spec=None, phase=34):
    """Phase 34: tensor-parallel training.  qwen3-0.6b at full width and
    depth, 2 nodes x tp 2 = 4 ranks sharing the card over gloo, flat planes,
    the fused update, decentlam on exp, 4 x 256 tokens per node, 2 steps,
    through the CLI's rank body (``--simulate-nodes 2 --tp 2``).  Gates:
    finite losses; each stage op launched once per rank and step (each
    rank's local plane), counted by op after every step; each rank's shard of its node's final parameters against the
    tp = 1 one-process-per-node run on 2 ranks (the same flags, in the same
    spawned group) within 1e-5 of each leaf's scale, the losses within 1e-5
    relative.  Prints the step time, gossip seconds per round, the model
    group's collective seconds, count and staged bytes per step, peak
    memory per rank and the card's."""
    import shutil

    from repro_torch.launch.mesh import run_ranks

    spec = spec or {**TP_TRAIN, "arch": TP_SERVE["arch"], "depth": 0,
                    "per_node_batch": MAIN["per_node_batch"], "seq_len": MAIN["seq_len"]}
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    torch.cuda.empty_cache()
    argv_tp, argv_one = _tp_train_argv(spec, "train")
    out = run_ranks(_tp_train_rank, spec["nodes"] * spec["tp"], argv_tp, argv_one, spec,
                    device="cuda", timeout_s=DIST_TIMEOUT_S)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    return _tp_train_check(torch, out, spec, phase)


def _swt_check(engine, pub):
    """``on_serve`` of phase 35 (rank 0): each offer that ships is held
    against the snapshot's planes, bit for bit.  Returns the counts."""
    import torch

    seen = {"checked": 0, "equal": 0}
    offer = pub.offer

    def checked(src, **kw):
        shipped = offer(src, **kw)
        if shipped:
            seen["checked"] += 1
            seen["equal"] += all(_same_bits(torch, pub.current.planes[k].to(p.device), p)
                                 for k, p in src.items())
        return shipped

    pub.offer = checked
    return seen


def _swt_rank(world, argv):
    """Phase 35 on one rank: the CLI's rank body with the vocabulary cut."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import RuntimeConfig

    model_config = train._model_config
    train._model_config = lambda args: _check_config(model_config(args))
    return train.rank_main(world, argv, None, None,
                           RuntimeConfig(dtype="float32", attn_impl="cuda"), _swt_check)


def phase_dist_serve_while_training(torch):
    """Phase 35: ``--simulate-nodes 2 --serve-while-training`` (tp = 1) at
    full width cut to 4 layers and the vocabulary to CHECK_VOCAB, planes,
    the stage kernel; rank 0 publishes its node every 2 steps and serves 8
    requests from the snapshots with the flash kernel.  Gates: every
    shipped snapshot equals node 0's parameters bit for bit, every request
    completes, finite losses."""
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    argv = ["--simulate-nodes", str(SWT_DIST["nodes"]), "--arch", MAIN["arch"], "--depth",
            str(SWT_DIST["depth"]), "--steps", str(SWT_DIST["steps"]), "--seq-len",
            str(MAIN["seq_len"]), "--per-node-batch", str(MAIN["per_node_batch"]),
            "--flat-planes", "--fused-update", "--fused-impl", "triton",
            "--serve-while-training", "--publish-every", str(SWT_DIST["publish_every"]),
            "--serve-requests", str(SWT_DIST["requests"]), "--log-every", "1"]
    res = run_ranks(_swt_rank, SWT_DIST["nodes"], argv, device="cuda",
                    timeout_s=DIST_TIMEOUT_S)[0]
    serve = res["serve"]
    shipped = serve["publisher"]["published"]
    if not all(math.isfinite(v) for v in res["losses"]):
        raise RuntimeError(f"losses {res['losses']}")
    if not (shipped == SWT_DIST["steps"] // SWT_DIST["publish_every"]
            and serve["on_serve"] == {"checked": shipped, "equal": shipped}
            and serve["completed"] == SWT_DIST["requests"]):
        raise RuntimeError(f"serving while training on ranks: {serve}")
    log(f"phase 35: --simulate-nodes {SWT_DIST['nodes']} --serve-while-training, "
        f"{MAIN['arch']} at full width, {SWT_DIST['depth']} layers, vocabulary {CHECK_VOCAB:,}, "
        f"{SWT_DIST['steps']} steps: losses {res['losses']}; {shipped} snapshots shipped by "
        f"rank 0, each == node 0's parameters bit for bit; {serve['completed']} of "
        f"{SWT_DIST['requests']} requests done, {serve['engine']['swaps']} swap(s), swap stall "
        f"{serve['engine']['swap_stall_s']:.3f} s; step {1e3 * res['step_s']:.1f} ms")
    return serve


# ---------------------------------------------------------------------------
# The cost stack on the card (phase 36)
# ---------------------------------------------------------------------------

# the product FLOPs the cost model counts in phase 15's step, against the
# shape formula (_matmul_flops_per_step); the dry run's peak memory against
# the allocator's peak of one real step at that shape
COST_FLOPS_RTOL = 0.02
COST_MEM_RATIO = (0.5, 2.0)


def _plane_step(torch, cfg, nodes):
    """Phase 15's step (decentlam on exp, planes, the stage kernel, f32) for
    ``nodes`` stacked nodes of ``cfg``, its state on the card and one batch
    of 4 x 256 tokens per node."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.step import TrainConfig, build_train_step
    from repro_torch.train.train_state import init_train_state, model_plane_layout

    tcfg = TrainConfig(fused_update=True, fused_impl="triton", flat_planes=True)
    step, channel = build_train_step(cfg, tcfg, nodes)
    state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), nodes,
                             device=torch.device("cuda"), channel=channel,
                             plane_layout=model_plane_layout(cfg))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=MAIN["seq_len"],
                                         per_node_batch=MAIN["per_node_batch"], n_nodes=nodes))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    return step, state, batch


def phase_cost_model(torch, flat, straggler):
    """The cost stack (``repro_torch.launch``: roofline, costmodel, dryrun;
    ``repro_torch.sim.wallclock``) on the card: (a) the cost model over one
    of phase 15's steps (product FLOPs against the shape formula within
    COST_FLOPS_RTOL, stage units == the launch counter's 2, the roofline
    terms at the f32 peak, MODEL_FLOPS' share of the f32 peak in phase 15's
    step time); (b) over one prefill wave of phase 7's engine (flash units
    == the flash counter == 28, their FLOPs == ``work``'s); (c) the meta dry
    run of qwen3-0.6b train_4k on pod1 and decode_32k on pod2, and a 1 x 1
    grid at phase 15's per-node shape, whose tracked peak is held against
    the allocator's peak of one real step (a ratio in COST_MEM_RATIO); (d)
    phase 29's straggler run projected onto the wall clock, calibrated by
    phase 15's measured step (wallclock_s == sim_time x the step, exactly)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.costmodel import CostRecorder
    from repro_torch.launch.roofline import F32_FLOP_PER_S, HW, model_flops, roofline_terms
    from repro_torch.models import transformer as T
    from repro_torch.sim import calibrate_from_dryrun, project_wallclock

    smi = _smi()
    cfg = get_config(MAIN["arch"])
    nodes = MAIN["nodes"]

    # (a) one flat-plane train step of phase 15
    step, state, batch = _plane_step(torch, cfg, nodes)
    n_params = T.count_params(state["params"]) // nodes  # one node's
    reset_launches()
    rec = CostRecorder()
    t = time.perf_counter()
    with rec:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t
    c = rec.costs
    launched = fused_stage_launch.launches
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    formula = _matmul_flops_per_step(cfg, nodes)
    rel = abs(c.product_flops - formula) / formula
    units = c.kernel_launches.get("fused_update", 0)
    if not rel <= COST_FLOPS_RTOL:
        raise RuntimeError(f"cost model: {c.product_flops:.6g} product FLOPs in phase 15's step, "
                           f"the shape formula {formula:.6g} ({rel:.2%} apart, tol "
                           f"{COST_FLOPS_RTOL:.0%})")
    if not units == launched == 2:
        raise RuntimeError(f"cost model: {units} stage units, the launcher counted {launched}; "
                           "want 2 on planes")
    hw = HW(peak_flops=F32_FLOP_PER_S)
    terms = roofline_terms(flops_per_device=c.flops, bytes_per_device=c.materialized_bytes,
                           collective_egress=c.collective_bytes, hw=hw)
    tokens = nodes * MAIN["per_node_batch"] * MAIN["seq_len"]
    mf = model_flops(n_params, tokens, training=True)
    step_s = flat["step_ms"] / 1e3
    log(f"phase 36: the cost model over one of phase 15's steps (qwen3-0.6b, {nodes} nodes, "
        f"{MAIN['per_node_batch']} x {MAIN['seq_len']} tokens per node, planes; {smi}): "
        f"{c.flops / 1e12:.4f} TFLOP, of it products {c.product_flops / 1e12:.4f} against "
        f"{formula / 1e12:.4f} from the shapes ({rel:.3%} apart, tol {COST_FLOPS_RTOL:.0%}); "
        f"stage units {units} == launches {launched}; materialized {c.materialized_bytes / 1e9:.2f} "
        f"GB (naive {c.naive_bytes / 1e9:.2f} GB); roofline at the f32 peak: compute "
        f"{terms['compute_s'] * 1e3:.1f} ms, memory {terms['memory_s'] * 1e3:.1f} ms, collective "
        f"{terms['collective_s'] * 1e3:.1f} ms, {terms['dominant']}-bound, lower bound "
        f"{terms['step_time_lower_bound_s'] * 1e3:.1f} ms against phase 15's {flat['step_ms']:.1f} "
        f"ms step; MODEL_FLOPS 6 N D = 6 x {n_params:,} x {tokens} = {mf / 1e12:.3f} TFLOP, "
        f"{mf / step_s / 1e12:.2f} TFLOP/s in phase 15's step: {mf / step_s / F32_FLOP_PER_S:.1%} "
        f"of the 67 TFLOP/s f32 peak (the counted step took {counted_s:.2f} s under the "
        "recorder)")

    # (b) one prefill wave of phase 7's engine
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = _engine(torch, cfg, params, attn_impl="cuda")
    wave = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE["slots"], SERVE["max_prompt"]),
                                    device="cuda", generator=torch.Generator(device="cuda")
                                    .manual_seed(3))}
    fa_kernel.reset_launches()
    rec = CostRecorder()
    with rec:
        eng.prefill_step(params, wave)
    torch.cuda.synchronize()
    fa = rec.costs
    flash = fa_kernel.flash_attention_launch.launches
    per_call = fa_kernel.work((SERVE["slots"], SERVE["max_prompt"], cfg.n_heads, cfg.hd),
                              (SERVE["slots"], SERVE["max_prompt"], cfg.n_kv_heads, cfg.hd),
                              torch.float32, True, 0)
    units = fa.kernel_launches.get("flash_attention", 0)
    if not units == flash == cfg.n_layers:
        raise RuntimeError(f"cost model: {units} flash units in a prefill wave, the launcher "
                           f"counted {flash}; want {cfg.n_layers}")
    if fa.kernel_flops["flash_attention"] != units * per_call[0]:
        raise RuntimeError(f"cost model: flash units' {fa.kernel_flops['flash_attention']} "
                           f"FLOPs != {units} x work()'s {per_call[0]}")
    log(f"phase 36: one qwen3-0.6b prefill wave of phase 7's engine ({SERVE['slots']} x "
        f"{SERVE['max_prompt']} tokens, f32): flash units {units} == launches {flash} == "
        f"{cfg.n_layers} layers, {fa.kernel_flops['flash_attention'] / 1e12:.4f} TFLOP == "
        f"{units} x work() {per_call[0] / 1e9:.2f} GFLOP; the wave {fa.flops / 1e12:.4f} TFLOP "
        f"(products {fa.product_flops / 1e12:.4f}), {fa.materialized_bytes / 1e9:.2f} GB "
        "materialized")
    del eng, params, wave
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the meta dry run, and its memory against one real step
    for arch, shape, mesh in ((MAIN["arch"], "train_4k", "pod1"),
                              (MAIN["arch"], "decode_32k", "pod2")):
        r = dryrun.run_cell(arch, shape, mesh)
        t_, m = r["roofline"], r["memory"]
        log(f"phase 36: dry run {arch} {shape} on {mesh} ({r['grid'][0]} nodes x tp "
            f"{r['grid'][1]}, one rank, bf16, meta; the H100's constants): compute "
            f"{t_['compute_s'] * 1e3:.3f} ms, memory {t_['memory_s'] * 1e3:.3f} ms, collective "
            f"{t_['collective_s'] * 1e3:.3f} ms, {t_['dominant']}-bound; arguments "
            f"{m['argument_bytes'] / 2**30:.3f} GiB, temp {m['temp_bytes'] / 2**30:.3f} GiB, "
            f"outputs {m['output_bytes'] / 2**30:.3f} GiB; units {r['raw']['kernel_launches']}, "
            f"collectives {r['collectives']['counts']} ({r['collectives']['egress_bytes'] / 1e9:.3f}"
            f" GB egress); MF-util {r['model_flops_utilization']:.1%}; {r['seconds']['run']:.1f} s")
    one = ShapeSpec("phase 15 per node", "train", MAIN["seq_len"], MAIN["per_node_batch"])
    args = dryrun.parser().parse_args(["--dtype", "float32"])
    r = dryrun.run_cell(MAIN["arch"], one, (1, 1), args)
    tracked = r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step, state, batch = _plane_step(torch, cfg, 1)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    real = torch.cuda.max_memory_allocated() - base
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    ratio = tracked / real
    lo, hi = COST_MEM_RATIO
    log(f"phase 36: a 1 x 1 grid at phase 15's per-node shape ({MAIN['per_node_batch']} x "
        f"{MAIN['seq_len']} tokens, f32, planes): the dry run's arguments + temp "
        f"{tracked / 2**30:.3f} GiB ({r['memory']['argument_bytes'] / 2**30:.3f} + "
        f"{r['memory']['temp_bytes'] / 2**30:.3f}) against one real step's "
        f"max_memory_allocated {real / 2**30:.3f} GiB (state and batch included): ratio "
        f"{ratio:.3f} (gate [{lo}, {hi}])")
    if not lo <= ratio <= hi:
        raise RuntimeError(f"dry run memory {tracked} B vs the real step's {real} B: ratio "
                           f"{ratio:.3f} outside [{lo}, {hi}]")

    # (d) phase 29's straggler run on the wall clock
    sim = straggler["result"]
    measured = calibrate_from_dryrun({"measured_step_s": step_s})
    roof = project_wallclock(sim, straggler["topology"], opt=straggler["opt"],
                             grad_fn=straggler["grad"])
    cal = project_wallclock(sim, straggler["topology"], opt=straggler["opt"],
                            grad_fn=straggler["grad"], measured_step_s=measured)
    if cal["wallclock_s"] != sim.sim_time * measured or cal["dominant"] != "measured":
        raise RuntimeError(f"calibrated wall clock {cal['wallclock_s']!r} != sim_time "
                           f"{sim.sim_time!r} x {measured!r}")
    log(f"phase 36: phase 29's straggler_1slow run (decentlam, ring, n {SIM['n']}; sim time "
        f"{sim.sim_time:.6g}) on the wall clock: roofline price {roof['step_time_s'] * 1e3:.3f} "
        f"ms a step ({roof['dominant']}; the 30-dim toy's roofline "
        f"{roof['roofline_s'] * 1e9:.3f} ns), {roof['wallclock_s']:.6g} s; calibrated by phase "
        f"15's measured {step_s * 1e3:.1f} ms step: {cal['wallclock_s']:.6g} s == sim_time x "
        f"step exactly, {cal['steps_per_s']:.4g} steps/s, {cal['device_hours']:.4g} "
        "device-hours")
    return {"flops": c.flops, "product_flops": c.product_flops, "mem_ratio": ratio}


# ---------------------------------------------------------------------------
# Tensor parallelism for the rest of the zoo (phases 37-40)
# ---------------------------------------------------------------------------


def _on_device_tp(size, index):
    """A model group of ``size`` whose collectives are on-device identities
    (a copy of the rank's own tensor), for checking that the sharded code
    between the collectives waits on no host: each real gloo collective
    stages its tensor through host memory, a sync by design."""
    from repro_torch.models.layers import TPContext

    class OnDevice(TPContext):
        def all_reduce(self, x, op="sum"):
            self.calls += 1
            return x.clone()

    tp = OnDevice(None)
    tp.size, tp.index = size, index
    return tp


def _moe_tp_layer_no_sync(torch, cfg, tp_size):
    """One MoE layer in expert mode at a tp rank's shard (its ``E / tp``
    experts and its block of the dispatch tables) at the main path's shape
    (4 x 256 tokens), forward and backward, with CUDA's sync debug mode at
    "error": the routing, the rank's slots, its experts and its combine
    never wait on the host (the model group's collectives are on-device
    identities here, :func:`_on_device_tp`)."""
    from repro_torch.models.layers import Initializer
    from repro_torch.models.moe import _expert_sharding, moe_forward, moe_init, moe_shard_axes
    from repro_torch.utils import shard

    if _expert_sharding(cfg, tp_size) != "expert":
        raise RuntimeError(f"{cfg.name} at tp {tp_size} is not expert-sharded")
    gen = torch.Generator(device="cuda").manual_seed(37)
    full = moe_init(Initializer(gen), cfg)
    tp = _on_device_tp(tp_size, 1)
    params = {k: v.clone().requires_grad_()
              for k, v in shard(full, moe_shard_axes(cfg, tp_size), tp_size, tp.index).items()}
    del full
    x = torch.randn(MAIN["per_node_batch"], MAIN["seq_len"], cfg.d_model, device="cuda",
                    generator=gen, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_forward(x, params, cfg, tp)
        loss = out.square().mean() + aux["moe_load_balance"] + aux["moe_router_z"]
        torch.autograd.grad(loss, [x, *params.values()])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if tp.calls != 3:  # the combine forward; the input's and the gates' gradients
        raise RuntimeError(f"the sharded MoE layer made {tp.calls} model-group all-reduces, "
                           "want 3")
    log(f"phase 37: one {cfg.name} MoE layer at tp {tp_size} rank {tp.index} "
        f"({params['w_in'].shape[0]} of {cfg.n_experts} experts) forward + backward at "
        f"{tuple(x.shape)} ran with no host sync (CUDA sync debug mode \"error\"; its "
        f"{tp.calls} model-group all-reduces on-device identities here)")


def phase_tp_moe_train(torch):
    """Phase 37: granite-moe-1b-a400m trained at 2 nodes x tp 2 in expert
    mode (TP_MOE; the CLI's rank body, phase 34's run and gates): first one
    sharded MoE layer with no host sync (:func:`_moe_tp_layer_no_sync`),
    then 2 steps on planes beside the tp 1 run on 2 ranks: a rank's shard
    of the final parameters within 1e-5 of scale of tp 1's, each stage op
    once per rank and step; a rank plane's stage timing."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TP_MOE["arch"]), n_layers=TP_MOE["depth"])
    _moe_tp_layer_no_sync(torch, cfg, TP_MOE["tp"])
    return phase_tp_train(torch, TP_MOE, 37)


def _unpadded(cfg, tp, params):
    """A global tree padded for ``tp`` cut to tp = 1's shapes (the padded q
    heads and vocabulary rows dropped): the same model at tp = 1."""
    from repro_torch.utils import tree_map

    hd, h, v = cfg.hd, cfg.n_heads, cfg.vocab_size
    p = tree_map(lambda x: x, params)  # new dicts, the same tensors
    p["embed"]["table"] = p["embed"]["table"][:v]
    if "lm_head" in p:
        p["lm_head"]["w"] = p["lm_head"]["w"][:, :v]
    for g in p["groups"].values():
        if "attn" in g:
            g["attn"]["wq"] = g["attn"]["wq"][..., :h * hd]
            g["attn"]["wo"] = g["attn"]["wo"][:, :h * hd]
    return p


def _tp_vlm_run(torch, cfg, make_params, grid):
    """Phase 40's VLM run on ``grid`` (None: one process, tp = 1): the
    rank's serving shard of ``make_params()``, one prefill of TP_VLM's
    seeded 8 x 512 tokens with 256 seeded patch embeddings spliced over
    the first positions, then 4 decode steps fed the prompt's next seeded
    tokens; the gathered logits (on the host), wall ms, flash launches,
    peak memory and the model group's collectives."""
    from repro_torch.interop import shard
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_launch,
        reset_launches,
    )
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.train import serve as S
    from repro_torch.utils import tree_map

    b, n, k = TP_VLM["batch"], TP_VLM["prompt"], TP_VLM["decode"]
    scfg = S.ServeConfig(runtime=RuntimeConfig(dtype="float32", attn_impl="cuda"),
                         target_len=n + k)
    params = make_params()
    if grid is not None:
        axes = S.serve_specs(cfg, grid, global_batch=b)[0]
        params = tree_map(lambda x: x.clone(), shard(params, axes, grid.tp, grid.model.rank))
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(40)
    toks = torch.randint(0, cfg.vocab_size, (b, n + k), device="cuda", generator=gen)
    patches = torch.randn(b, cfg.num_patches, cfg.d_model, device="cuda", generator=gen)
    pre = S.build_prefill_step(cfg, scfg, grid, global_batch=b, timing=grid is not None)
    dec = S.build_decode_step(cfg, scfg, grid, target_len=n + k, global_batch=b,
                              timing=grid is not None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    lg, cache = pre(params, {"tokens": toks[:, :n], "patch_embeds": patches})
    torch.cuda.synchronize()
    rec = {"prefill_ms": 1e3 * (time.perf_counter() - t), "flash": flash_attention_launch.launches,
           "prefill": S.gather_logits(lg, grid, global_batch=b).float().cpu().numpy(),
           "decode": [], "decode_ms": []}
    for j in range(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = dec(params, toks[:, n + j:n + j + 1], cache, torch.tensor(n + j))
        torch.cuda.synchronize()
        rec["decode_ms"].append(1e3 * (time.perf_counter() - t))
        rec["decode"].append(S.gather_logits(lg, grid, global_batch=b).float().cpu().numpy())
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["tp"] = {name: None if f.tp is None else (f.tp.seconds, f.tp.calls, f.tp.staged_bytes)
                 for name, f in (("prefill", pre), ("decode", dec))}
    del params, cache, lg
    torch.cuda.empty_cache()
    return rec


def _tp_zoo_rank(world):
    """Phases 38-40 on one of 2 ranks sharing the card: xlstm-350m's and
    hymba-1.5b's engines on the (1 x 2) grid, then rank 0 alone the tp = 1
    engine on the same weights (the padding cut); internvl2-2b's prefill
    with patches and decode on the grid and at tp = 1 on rank 0; whisper-
    tiny's training through the CLI's rank body at (1 x 2) beside the tp 1
    run on rank 0 (:func:`_tp_train_rank`).  Rank 0 returns the tp = 1
    records beside its own."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T

    tp = TP_ZOO_SERVE["tp"]
    grid = init_grid(world, tp)
    out = {}

    def runs(cfg, run, **one):
        def make():  # the same global tree at every call
            return T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), tp=tp)

        mine = run(torch, cfg, make, grid)
        torch.cuda.empty_cache()
        ref = run(torch, cfg, lambda: _unpadded(cfg, tp, make()), None, **one) \
            if world.rank == 0 else None
        torch.cuda.empty_cache()
        return mine, ref

    def engine(t, c, m, g, **kw):
        return _tp_engine_run(t, c, m, g, TP_ZOO_SERVE, **kw)

    for arch, (_, _, depth) in TP_ZOO_ARCHS.items():
        cfg = get_config(arch)
        out[arch] = runs(cfg, engine, floor=True)
        if depth:
            out[f"{arch}@{depth}"] = runs(dataclasses.replace(cfg, n_layers=depth), engine)
    out[TP_VLM["arch"]] = runs(get_config(TP_VLM["arch"]), _tp_vlm_run)
    out[TP_WHISPER["arch"]] = _tp_train_rank(world, *_tp_train_argv(TP_WHISPER, "whisper"),
                                             TP_WHISPER)
    return out


def _tp_zoo_gates(what, mine, other, kernel, per_wave):
    """Phase 38/39's launch, completion and rank-agreement gates."""
    for r, m in enumerate((mine, other)):
        if m["waves"] != 1 or m[kernel] != per_wave:
            raise RuntimeError(f"{what} rank {r}: {m[kernel]} {kernel} launches in "
                               f"{m['waves']} waves, want {per_wave} in 1")
        if len(m["tokens"]) != TP_ZOO_SERVE["requests"]:
            raise RuntimeError(f"{what} rank {r}: {len(m['tokens'])} requests done")
    if mine["tokens"] != other["tokens"]:
        raise RuntimeError(f"{what}: the two ranks generated different tokens")


def _tp_serve_log(phase, arch, mine, ref, errs, kernel, per_wave):
    """Phase 38/39's log lines: launches, the tp 1 comparison, times,
    collectives and memory (rank 0's records)."""
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    sec, calls, staged = mine["tp"]["decode"]
    psec, pcalls, pstaged = mine["tp"]["prefill"]
    steps = len(mine["decode_ms"])
    same = sum(mine["tokens"][k] == ref["tokens"][k] for k in ref["tokens"])
    log(f"phase {phase}: {arch} full width and depth, tp {TP_ZOO_SERVE['tp']} on 2 ranks "
        f"sharing the card (gloo), f32, the {kernel} kernel: {TP_ZOO_SERVE['requests']} "
        f"requests of {TP_ZOO_SERVE['min_prompt']}..{TP_ZOO_SERVE['max_prompt']} prompt "
        f"tokens, {TP_ZOO_SERVE['max_new']} new; all complete on both ranks with the same "
        f"tokens ({same} of {len(ref['tokens'])} requests token for token as the tp = 1 "
        f"engine); {kernel} launches {mine[kernel]} in {mine['waves']} wave ({per_wave} a wave "
        f"and rank)")
    log(f"  against the tp = 1 engine on the same weights: prefill logits max rel diff "
        f"{errs['prefill']:.3g}, the first {TP_ZOO_SERVE['checked']} decode steps "
        f"{errs['decode']:.3g} (rtol {TP_RTOL}); slots whose tokens parted at a near tie "
        f"{errs['parted'] or 'none'}")
    log(f"  prefill {mean(mine['prefill_ms']):.1f} ms per wave (tp = 1: "
        f"{mean(ref['prefill_ms']):.1f}); its collectives {psec:.3f} s, {pcalls} calls, "
        f"{pstaged / 1e9:.3f} GB staged; decode {mean(mine['decode_ms'][1:]):.1f} ms per step "
        f"(tp = 1: {mean(ref['decode_ms'][1:]):.1f}); collectives per decode step "
        f"{sec / steps * 1e3:.1f} ms, {calls / steps:.0f} calls, {staged / steps / 1e6:.2f} MB "
        f"staged; peak memory per rank {mine['peak'] / 2**30:.2f} GiB (tp = 1: "
        f"{ref['peak'] / 2**30:.2f})")


def phase_tp_zoo(torch):
    """Phases 38-40 in one spawned group of 2 ranks sharing the card over
    gloo (:func:`_tp_zoo_rank`), each against tp 1 on the same weights:

    * 38: xlstm-350m at full width and depth behind the engine at tp 2
      (phase 33's requests; each rank's mLSTM on dv 256 of 512, sLSTM
      replicated): the first wave's logits and the first 4 decode steps
      within max(5e-4, ZOO_FLOOR_X x the spread of two tp = 1 runs on the
      first wave, kernels against plain versions), the same tokens on both
      ranks, 20 mlstm_chunk launches a wave and rank; at 6 layers the same
      at 5e-4; then the kernel at the rank shape against its plain
      version, timed (ML_TP);
    * 39: hymba-1.5b the same at full depth, 32 flash launches a wave and
      rank (the kernel at 13 expanded heads is phase 9's shape, held there);
    * 40: internvl2-2b's prefill with 256 patch embeddings and 4 decode
      steps at 5e-4 relative, 24 flash launches a rank; whisper-tiny
      trained at 1 node x tp 2 (the CLI, seeded frames): phase 34's gates.

    Every gate raises."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    torch.cuda.empty_cache()
    out = run_ranks(_tp_zoo_rank, TP_ZOO_SERVE["tp"], device="cuda", timeout_s=DIST_TIMEOUT_S)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    rec = {}
    rel = lambda a, b: float(np.abs(a[..., :b.shape[-1]] - b).max() / np.abs(b).max())  # noqa: E731
    for phase, (arch, (kernel, per_wave, depth)) in zip((38, 39), TP_ZOO_ARCHS.items()):
        (mine, ref), (other, _) = out[0][arch], out[1][arch]
        spread = rel(ref["prefill"], ref["plain_prefill"])
        rtol = max(TP_RTOL, ZOO_FLOOR_X * spread)
        errs = _tp_compare(mine, ref, rtol)
        _tp_zoo_gates(arch, mine, other, kernel, per_wave)
        _tp_serve_log(phase, arch, mine, ref, errs, kernel, per_wave)
        log(f"  two tp = 1 runs on the first wave, the kernels against their plain versions "
            f"(f32 sums in another order): prefill logits {spread:.3g} of scale apart; tp 2 "
            f"held at {rtol:.3g} (max of {TP_RTOL} and {ZOO_FLOOR_X} x that)")
        rec[arch] = {"launches": mine[kernel], "errs": errs, "spread": spread}
        if depth:
            cut = dataclasses.replace(get_config(arch), n_layers=depth)
            n = sum(1 for g in T.block_groups(cut) if g.kind == "mlstm" for _ in g.layers) \
                if cut.xlstm else depth
            (m6, r6), (o6, _) = out[0][f"{arch}@{depth}"], out[1][f"{arch}@{depth}"]
            errs6 = _tp_compare(m6, r6)
            _tp_zoo_gates(f"{arch} at {depth} layers", m6, o6, kernel, n)
            log(f"  at {depth} layers (full width): the first wave's logits {errs6['prefill']:.3g}"
                f" and the first {TP_ZOO_SERVE['checked']} decode steps {errs6['decode']:.3g} of "
                f"scale off the tp = 1 engine's (rtol {TP_RTOL}); {kernel} launches {m6[kernel]} "
                f"({n} a wave and rank); tokens parted at a near tie {errs6['parted'] or 'none'}")
            rec[arch]["errs_cut"] = errs6
    rec["mlstm"] = phase_mlstm_timing(torch, ML_TP, "a tp 2 rank's shape of phase 38 (dv 256 "
                                      "of 512)", 38)

    (mine, ref), (other, _) = out[0][TP_VLM["arch"]], out[1][TP_VLM["arch"]]
    errs = [rel(mine["prefill"], ref["prefill"])] + [rel(a, b) for a, b in
                                                     zip(mine["decode"], ref["decode"])]
    layers = get_config(TP_VLM["arch"]).n_layers
    if max(errs) > TP_RTOL or not np.array_equal(mine["prefill"], other["prefill"]):
        raise RuntimeError(f"{TP_VLM['arch']} at tp 2: logits off tp 1 by {errs} (rtol "
                           f"{TP_RTOL}) or the ranks' gathered logits differ")
    if mine["flash"] != layers or other["flash"] != layers:
        raise RuntimeError(f"{TP_VLM['arch']}: flash launches {mine['flash']}, "
                           f"{other['flash']} a rank, want {layers} (one a layer)")
    sec, calls, staged = mine["tp"]["prefill"]
    log(f"phase 40: {TP_VLM['arch']} full width and depth, tp 2 on 2 ranks, f32, flash: "
        f"{TP_VLM['batch']} x {TP_VLM['prompt']} prompt tokens with "
        f"{get_config(TP_VLM['arch']).num_patches} seeded patch embeddings a row spliced, then "
        f"{TP_VLM['decode']} decode steps: logits max rel diff to tp 1 prefill {errs[0]:.3g}, "
        f"decode {[f'{e:.3g}' for e in errs[1:]]} (rtol {TP_RTOL}); flash launches "
        f"{mine['flash']} a rank (one a layer); prefill {mine['prefill_ms']:.1f} ms (tp = 1: "
        f"{ref['prefill_ms']:.1f}), its collectives {sec:.3f} s, {calls} calls, "
        f"{staged / 1e9:.3f} GB staged; decode {[round(t, 1) for t in mine['decode_ms']]} ms "
        f"(tp = 1: {[round(t, 1) for t in ref['decode_ms']]}); peak per rank "
        f"{mine['peak'] / 2**30:.2f} GiB (tp = 1: {ref['peak'] / 2**30:.2f})")
    rec["vlm"] = {"launches": mine["flash"], "errs": errs}
    rec["whisper"] = _tp_train_check(torch, [o[TP_WHISPER["arch"]] for o in out], TP_WHISPER,
                                     40)
    return rec


# ---------------------------------------------------------------------------
# The tensor-parallel checkpoint and drill, the examples (41-42)
# ---------------------------------------------------------------------------

# phase 41: phase 23's arguments (qwen3-0.6b at full width, 2 layers, the
# vocabulary cut to CHECK_VOCAB, decentlam-sa at delay 1 on planes, the Triton
# stage kernel) on a 2 x 2 grid of 4 ranks
TP_CKPT = ["--simulate-nodes", "2", "--tp", "2"] + DIST_CKPT[2:]
TP_CKPT_DIR = os.path.join(HERE, "build", "tp_ckpt")
# phase 42: the examples, cut for the script's time: torch_bias_demo's
# studies from 3000 steps to 600 (every trace has settled by step 300),
# torch_quickstart from 60 steps to 20 (DecentLaM's consensus distance is
# below DmSGD's from step 20 on), torch_train_lm from 120 to 10 (the drill at
# step 5; a step of its 8 ranks sharing the card took 0.37-0.54 s)
EXAMPLES_DIR = os.path.join(HERE, "examples")
EX = dict(bias_steps=600, quickstart_steps=20, train_steps=10)
EX_DIR = os.path.join(HERE, "build", "examples")
# the reference's bias tests (tests/test_bias_propositions.py): DmSGD's
# amplification over DSGD within 10x of Prop. 2's 25x and above 3x;
# DecentLaM within 1.5x of DSGD and below 0.2x of DmSGD
BIAS_AMP = (2.5, 250.0)


def _tp_ckpt_rank(world, root, argv):
    """Phase 41 on one of 4 ranks, through the CLI's rank body
    (``rank_main``) with the vocabulary cut: 4 steps unbroken; 2 steps
    checkpointed at their end (under ``root``) and resumed to step 4; each
    rank's final parameters, optimizer and channel state against the
    unbroken run's, bit for bit.
    Then ``--failure-drill`` over 3 steps, 2 x 2 -> 1 x 2, checked by
    :func:`_check_shrink`.  The stage kernel's launches are counted by op
    over each run.  Rank 0 returns the report; the others their part."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.fused_update.kernel import fused_stage_launch, reset_launches
    from repro_torch.launch import train

    model_config = train._model_config
    train._model_config = lambda args: _check_config(model_config(args))
    final, launches = {}, []

    def keep(step, state, metrics):
        if step == 3:
            final["state"] = _host_copy(state)

    def run(extra, on_step=None, on_shrink=None):
        reset_launches()
        out = train.rank_main(world, argv + extra, on_step, on_shrink)
        launches.append(dict(fused_stage_launch.launches_by_op))
        return out

    ra = run(["--steps", "4"], keep)
    straight = final.pop("state")
    saved = run(["--steps", "2", "--ckpt-dir", root])
    gb = None
    if world.rank == 0:
        gb = os.path.getsize(os.path.join(root, "step_00000002", "state.npz")) / 1e9
    rb = run(["--steps", "4", "--ckpt-dir", root, "--resume"], keep)
    resumed = final.pop("state")
    differ = sorted(set(straight) ^ set(resumed)) + [
        k for k in straight if k in resumed and not _same_bits(torch, straight[k], resumed[k])]
    verdicts = [None] * world.world
    dist.all_gather_object(verdicts, differ)
    paths = sorted(straight)
    del straight, resumed
    torch.cuda.empty_cache()
    rc = run(["--steps", "3", "--failure-drill"], on_shrink=_check_shrink)
    if world.rank:
        return {"drill": rc, "launches": launches}
    return {"a": ra, "saved": saved, "b": rb, "drill": rc, "differ": verdicts, "gb": gb,
            "launches": launches, "tensors": paths}


def phase_tp_checkpoint(torch):
    """Phase 23's arguments at ``--tp 2`` on a 2 x 2 grid of 4 ranks sharing
    the card over gloo (qwen3-0.6b at full width, 2 layers, the vocabulary
    cut; decentlam-sa at delay 1 on planes, the stage kernel in Triton):
    4 steps unbroken against 2 steps, save, ``--resume``, 2 steps: the
    losses and every rank's tensors bit for bit, the channel's ring and
    ``count`` included; the checkpoint's GB, save and restore seconds.
    Then ``--failure-drill`` 2 x 2 -> 1 x 2 over 3 steps: finite losses,
    the survivors' state == ``elastic_reshape`` of the gathered state bit
    for bit, the channel re-initialized, the leaving ranks' records.  The
    stage kernel launched by every rank in every run."""
    import shutil

    from repro_torch.launch.mesh import run_ranks

    shutil.rmtree(TP_CKPT_DIR, ignore_errors=True)
    os.makedirs(TP_CKPT_DIR)
    free = shutil.disk_usage(HERE).free
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        out = run_ranks(_tp_ckpt_rank, 4, TP_CKPT_DIR, TP_CKPT, timeout_s=DIST_TIMEOUT_S)
    finally:
        shutil.rmtree(TP_CKPT_DIR, ignore_errors=True)
    rep = out[0]
    ra, rb, rc = rep["a"], rep["b"], rep["drill"]
    if (rb["start_step"] != 2 or rep["saved"]["losses"] != ra["losses"][:2]
            or rb["losses"] != ra["losses"][2:] or any(rep["differ"])):
        raise RuntimeError(f"phase 41: resumed losses {rb['losses']}, unbroken {ra['losses']}; "
                           f"tensors that differ per rank {[d[:5] for d in rep['differ']]}")
    n_tensors, differ, fresh = rc["on_shrink"]
    left = [r["drill"] for r in out[2:]]
    if (not all(map(math.isfinite, rc["losses"])) or rc["drill"] != {"step": 1, "from": 2, "to": 1}
            or rc["n_nodes"] != 1 or differ or not fresh
            or left != [{"left_at_step": 1, "rank": 2}, {"left_at_step": 1, "rank": 3}]):
        raise RuntimeError(f"phase 41 drill: {rc['drill']}, losses {rc['losses']} on "
                           f"{rc['n_nodes']} nodes, {differ[:5]} differ from elastic_reshape, "
                           f"channel fresh {fresh}, leaving ranks {left}")
    # every rank launched each stage op in each run (unbroken, saved, resumed, drill)
    counts = [r["launches"] for r in out]
    ops = sorted({op for c in counts for run in c for op in run})
    if not ops or any(not run.get(op) for c in counts for run in c for op in ops):
        raise RuntimeError(f"phase 41: stage launches by rank and run {counts}")
    chan = [k for k in rep["tensors"] if k.startswith("channel/")]
    if not any(k.endswith("/count") for k in chan) or not any("/hist/" in k for k in chan):
        raise RuntimeError(f"phase 41: the ranks' channel state holds {chan}")
    log(f"phase 41: 2 nodes x tp 2, 2 layers, vocabulary {CHECK_VOCAB:,}, decentlam-sa at "
        f"delay 1 on planes ({_smi()}): unbroken {ra['losses']} == 2 steps, save, --resume, "
        f"2 steps {rb['losses']}; every rank's final state bit for bit in all "
        f"{len(rep['tensors'])} tensors ({len(chan)} of the channel: {chan}); stage launches "
        f"by rank, run and op {counts}")
    log(f"  {rep['gb']:.3f} GB per checkpoint ({free / 1e9:.1f} GB free on the disk); save "
        f"(gather to rank 0, write) {rep['saved']['save_s'] + rb['save_s']} s, restore (read "
        f"on rank 0, scatter, to the device) {rb['restore_s']:.2f} s")
    log(f"  --failure-drill {rc['drill']}: losses {rc['losses']} (finite) on 1 node x tp 2, "
        f"the survivors' state == elastic_reshape of the gathered state bit for bit in "
        f"{n_tensors} tensors, the channel re-initialized, ranks 2-3 left with {left}; "
        f"{time.perf_counter() - t:.1f} s")


def phase_examples(torch):
    """The five examples of the port through their ``main`` on the card:
    ``torch_bias_demo`` (Figs. 2-3, its studies cut to EX's steps; the
    amplification and the ratio within the reference tests' bounds),
    ``torch_sim_cluster`` (finite trace, the H100 projection),
    ``torch_quickstart`` (finite losses; DecentLaM's final consensus
    distance below DmSGD's, and the final losses side by side),
    ``torch_train_lm`` (8 ranks sharing the card over gloo, the JAX example's
    argv, its steps cut: finite losses, the drill 8 -> 4) and ``torch_serve_lm`` (8 ranks,
    a 4 x 2 grid: every request complete, the same tokens on every rank,
    the flash kernel launched on every rank).  Returns the serve run's
    flash launches (rank 0's)."""
    import shutil

    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    import torch_bias_demo
    import torch_quickstart
    import torch_serve_lm
    import torch_sim_cluster
    import torch_train_lm

    smi, secs = _smi(), {}

    def timed_main(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        secs[name] = round(time.perf_counter() - t, 1)
        return out

    bias = timed_main("bias_demo", torch_bias_demo.main, ["--steps", str(EX["bias_steps"])])
    traces = [v for tr in bias["traces"].values() for v in tr]
    amp, ratio = bias["amplification"], bias["ratio"]
    final = {a: tr[-1] for a, tr in bias["traces"].items()}
    if not (all(map(math.isfinite, traces)) and BIAS_AMP[0] < amp < BIAS_AMP[1] and amp > 3.0
            and ratio < 1.5 and final["decentlam"] < 0.2 * final["dmsgd"]):
        raise RuntimeError(f"phase 42 bias_demo: amplification {amp}, ratio {ratio}, final {final}")
    sim = timed_main("sim_cluster", torch_sim_cluster.main, [])
    vals = [v for e in sim["trace"] for v in (e["consensus"], e["metric"])]
    if not (sim["trace"] and all(map(math.isfinite, vals)) and "TPU" not in
            sim["projection_label"] and sim["projection"]["wallclock_s"] > 0):
        raise RuntimeError(f"phase 42 sim_cluster: {sim['summary']}, {sim['projection']}")
    qs = timed_main("quickstart", torch_quickstart.main,
                    ["--steps", str(EX["quickstart_steps"])])
    loss = {a: r["losses"][-1] for a, r in qs.items()}
    cons = {a: r["consensus_sq"][-1] for a, r in qs.items()}
    if not (all(math.isfinite(v) for r in qs.values() for v in r["losses"])
            and cons["decentlam"] < cons["dmsgd"]):
        raise RuntimeError(f"phase 42 quickstart: final losses {loss}, consensus {cons}")
    shutil.rmtree(EX_DIR, ignore_errors=True)
    try:
        tl = timed_main("train_lm", torch_train_lm.main,
                        ["--ckpt-dir", os.path.join(EX_DIR, "train_lm"), "--timeout",
                         str(DIST_TIMEOUT_S), "--steps", str(EX["train_steps"])])
    finally:
        shutil.rmtree(EX_DIR, ignore_errors=True)
    half = EX["train_steps"] // 2
    if not (all(map(math.isfinite, tl["losses"])) and len(tl["losses"]) == EX["train_steps"]
            and tl["drill"] == {"step": half, "from": 8, "to": 4} and tl["n_nodes"] == 4):
        raise RuntimeError(f"phase 42 train_lm: drill {tl['drill']}, {tl['n_nodes']} nodes, "
                           f"losses {tl['losses'][:3]}..{tl['losses'][-3:]}")
    sv = timed_main("serve_lm", torch_serve_lm.main, ["--timeout", str(DIST_TIMEOUT_S)])
    toks = sv["tokens"]
    if not (sv["shards_agree"] and len(toks) == torch_serve_lm.B
            and all(len(t) == torch_serve_lm.GEN for t in toks)
            and all(n > 0 for n in sv["flash_launches"])):
        raise RuntimeError(f"phase 42 serve_lm: agree {sv['shards_agree']}, lengths "
                           f"{[len(t) for t in toks]}, flash launches {sv['flash_launches']}")
    log(f"phase 42: the examples on the card ({smi}), seconds {secs}")
    log(f"  bias_demo ({EX['bias_steps']} steps a study): DmSGD amplification {amp:.1f}x "
        f"(bounds {BIAS_AMP}), DecentLaM / DSGD {ratio:.3f}; final biases {final}")
    log(f"  sim_cluster: {len(sim['trace'])} trace rows, summary {sim['summary']}; "
        f"{sim['projection_label']}: {sim['projection']}")
    log(f"  quickstart ({EX['quickstart_steps']} steps, 8 stacked nodes): final losses {loss}, "
        f"final consensus "
        f"{cons} (DecentLaM's below DmSGD's); DecentLaM's final loss "
        f"{'below' if loss['decentlam'] < loss['dmsgd'] else 'not below'} DmSGD's")
    log(f"  train_lm (8 ranks over gloo, {EX['train_steps']} steps): losses "
        f"{tl['losses'][0]:.4f} .. "
        f"{tl['losses'][-1]:.4f}, drill {tl['drill']}, step {tl['step_s']:.4f} s")
    secs_by_rank = [tuple(round(x, 2) for x in r) for r in sv["seconds"]]
    log(f"  serve_lm (4 x 2 grid of 8 ranks): {len(toks)} requests x {len(toks[0])} tokens, "
        f"the same on every rank; flash launches by rank {sv['flash_launches']}; host seconds "
        f"(grid, engine set up, serve) by rank {secs_by_rank}; request 0 {toks[0]}")
    return sv["flash_launches"][0]


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "build", "triton"))
    # bytecode under build/pycache: where the installed packages have none
    # cached, every spawned rank would compile torch's sources again (~5 s a
    # group of ranks on the card's host); this process compiles them once
    sys.pycache_prefix = os.path.join(HERE, "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention.kernel import build as build_flash
    from repro_torch.kernels.mlstm_chunk.kernel import build as build_mlstm

    t0 = time.perf_counter()
    phases = {}

    held = {}

    def timed(name, fn, *args):
        # each phase starts with the allocator's free segments released (after
        # a collection: a reference cycle, such as phase 16's hooked engine,
        # holds its tensors until one), and what it leaves allocated is
        # logged: a tensor kept past its phase pins a segment that later
        # phases (and spawned ranks) cannot use
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = fn(torch, *args)
        phases[name] = round(time.perf_counter() - t, 1)
        held[name.split()[0]] = round(torch.cuda.memory_allocated() / 2**30, 2)
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
    whisper = timed("27 whisper-tiny train and serve", phase_whisper)
    timed("28 ResNet-20 through run_stacked", phase_resnet)
    straggler = timed("29 bias experiments and the simulator", phase_bias_and_sim)
    sparse = timed("30 + 32 row-sparse gossip; chaos and the resilient layer on 4 ranks",
                   phase_sparse_main_path)
    timed("31 resilience on the stacked trainer", phase_resilience_main_path, flat)
    tp_serve = timed("33 tensor-parallel serve", phase_tp_serve)
    tp_train = timed("34 tensor-parallel train", phase_tp_train)
    timed("35 serve while training on ranks", phase_dist_serve_while_training)
    timed("36 cost model on the card", phase_cost_model, flat, straggler)
    tp_moe = timed("37 tensor-parallel MoE train", phase_tp_moe_train)
    tp_zoo = timed("38-40 tensor-parallel xLSTM, hybrid, VLM serve; whisper train", phase_tp_zoo)
    timed("41 tensor-parallel checkpoint, resume, drill", phase_tp_checkpoint)
    ex_flash = timed("42 the examples on the card", phase_examples)
    log(f"phase times (s): {phases}; total {time.perf_counter() - t0:.1f}s")
    log(f"device memory allocated after each phase (GiB): {held}")
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
    fa_whisper = {k: fa[k] for k in ("whisper-tiny encoder", "whisper-tiny cross")}
    fa_tp = fa["qwen3-0.6b prefill, a tp 2 rank"]
    fa_hy_tp = fa["hymba-1.5b prefill, a tp 2 rank"]
    fa_vlm_tp = fa["internvl2-2b prefill, a tp 2 rank"]
    fa_ex = fa["serve_lm example, a (4 x 2) rank"]
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
    # whisper-tiny's main path (phase 27): the plane stages at its
    # (4, rows, 1024) plane, and flash at its encoder's and cross-attention's
    # prefill shapes (phase 9); every launch of the serve run counts
    records += [{
        "name": f"fused_update[whisper-tiny plane {op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": whisper["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in whisper["plane"].items()]
    records += [{
        "name": f"flash_attention[{k}: non-causal, Sq {FA_MAIN_SHAPES[k][1]}, Sk 1500, f32, "
                "hd 64, 6/6 heads]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": whisper["flash_launches"],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for k, rec in fa_whisper.items()]
    # phase 30: one rank's plane at 2 layers under row-sparse gossip
    records += [{
        "name": f"fused_update[rank plane {op}, {SPARSE['depth']} layers, row-sparse gossip]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": sparse["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in sparse["plane"].items()]
    # phase 34: a tp 2 rank's local plane, one launch per stage, rank and step
    # (the launches summed over the 4 ranks)
    records += [{
        "name": f"fused_update[tp 2 rank plane {op}]",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/_triton.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:66",
        "launches": tp_train["launches"][op],
        "max_abs_err": rec["err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for op, rec in tp_train["plane"].items()]
    # phase 33: flash at a tp 2 rank's local heads, launched 28 times per
    # wave on each rank (the count is rank 0's); the time at that shape
    # (phase 9)
    records.append({
        "name": "flash_attention[qwen3-0.6b at tp 2, a rank's prefill: causal, f32, hd 64, "
                "8/4 heads]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": tp_serve["flash"],
        "max_abs_err": fa_tp["err"],
        "ms": fa_tp["ms"],
        "plain_ms": fa_tp["plain_ms"],
        "bound_ms": fa_tp["bound_ms"],
        "bound_by": fa_tp["bound_by"],
        "library_ms": fa_tp["library_ms"],
    })
    # phase 37: a granite-moe-1b-a400m tp 2 rank's local plane (12 layers,
    # expert-sharded), one launch per stage, rank and step (summed over the
    # 4 ranks); phase 40: a whisper-tiny tp 2 rank's plane (2 ranks)
    for arch, rec_tp in ((TP_MOE["arch"], tp_moe), (TP_WHISPER["arch"], tp_zoo["whisper"])):
        records += [{
            "name": f"fused_update[{arch} tp 2 rank plane {op}]",
            "route": "triton",
            "source": "src/repro_torch/kernels/fused_update/_triton.py",
            "replaces": "src/repro/kernels/fused_update/kernel.py:66",
            "launches": rec_tp["launches"][op],
            "max_abs_err": rec["err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        } for op, rec in rec_tp["plane"].items()]
    # phase 38: mlstm_chunk at a tp 2 rank's dv = 256, 20 launches a wave on
    # each rank (the count is rank 0's); phases 39-40: flash at hymba's 13
    # expanded heads and internvl2's 8/4 heads of a tp 2 rank (32 and 24 a
    # wave and rank), timed at those shapes in phase 9
    ml_tp = tp_zoo["mlstm"]
    records.append({
        "name": "mlstm_chunk[xlstm-350m at tp 2, a rank's prefill: f32, dk 512, dv 256, "
                "chunk 128]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:99",
        "launches": tp_zoo["xlstm-350m"]["launches"],
        "max_abs_err": ml_tp["err"],
        "ms": ml_tp["ms"],
        "plain_ms": ml_tp["plain_ms"],
        "bound_ms": ml_tp["bound_ms"],
        "bound_by": ml_tp["bound_by"],
        "library_ms": ml_tp["library_ms"],
    })
    for name, rec, launches in (
            ("hymba-1.5b at tp 2, a rank's prefill: causal, window 1024, f32, hd 64, 13/13 "
             "heads", fa_hy_tp, tp_zoo["hymba-1.5b"]["launches"]),
            ("internvl2-2b at tp 2, a rank's prefill: causal, f32, hd 128, 8/4 heads",
             fa_vlm_tp, tp_zoo["vlm"]["launches"])):
        records.append({
            "name": f"flash_attention[{name}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
            "launches": launches,
            "max_abs_err": rec["err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    # phase 42: flash in torch_serve_lm's prefill on a rank of the (4 x 2)
    # grid, one launch a layer (the count is rank 0's); the time at that
    # shape (phase 9)
    records.append({
        "name": "flash_attention[serve_lm example at tp 2, a rank's prefill: causal, f32, hd 32, "
                "2/1 heads]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": ex_flash,
        "max_abs_err": fa_ex["err"],
        "ms": fa_ex["ms"],
        "plain_ms": fa_ex["plain_ms"],
        "bound_ms": fa_ex["bound_ms"],
        "bound_by": fa_ex["bound_by"],
        "library_ms": fa_ex["library_ms"],
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
