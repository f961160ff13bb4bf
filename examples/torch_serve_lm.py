"""Serve a small LM with batched requests on a (4 x 2) grid of ranks, the
counterpart of ``examples/serve_lm.py``: 4 request shards x 2-way tensor
parallelism, greedy sampling from the vocab-sharded logits.

Each of the 8 ranks (spawned by ``repro_torch.launch.mesh.run_ranks``; on
one card they share it over gloo) runs the continuous-batching
``ServeEngine`` on its place of the grid: its node's 2 of the 8 slots, its
model rank's shard of the weights.  Every decode batch's logits are
gathered to every rank, so every rank picks the same tokens.  On the card
the prefill's attention is the flash-attention kernel (``attn_impl=
"cuda"``), on the CPU its plain version.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py               # on the card
      PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

``main(argv, params=None)`` returns what it prints; ``params``, a global
parameter tree (numpy or tensors, as ``repro_torch.interop.from_numpy``
takes), replaces the seeded random weights.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import tiny_lm
from repro_torch.launch.mesh import init_grid, run_ranks
from repro_torch.models import transformer as T
from repro_torch.utils import tree_map

CONFIG = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=1024)
SHARDS, TP = 4, 2
B, PROMPT, GEN = 8, 24, 16


def _serve_rank(world, params, prompts, device):
    """One rank's engine: every request, greedy, to GEN new tokens; the
    completions, per request and generated token the gap between the two
    largest logits, and the flash-attention kernel's launches."""
    import time

    from repro_torch.interop import from_numpy
    from repro_torch.kernels.flash_attention.kernel import flash_attention_launch, reset_launches
    from repro_torch.serve import Request, ServeEngine

    t0 = time.perf_counter()
    cfg = tiny_lm(**CONFIG)
    grid = init_grid(world, TP)
    t_grid = time.perf_counter()
    gaps = np.zeros((B, GEN), np.float32)

    def on_logits(lg, active):
        top = torch.topk(lg.float(), 2, dim=-1).values.cpu()
        for slot, (rid, idx) in active.items():
            gaps[rid, idx] = float(top[slot, 0] - top[slot, 1])

    rt = T.RuntimeConfig(dtype="float32", attn_impl="cuda" if device == "cuda" else "torch")
    engine = ServeEngine(cfg, slots=B, max_prompt=PROMPT, max_new=GEN,
                         params=from_numpy(params), runtime=rt, device=device, grid=grid,
                         on_logits=on_logits)
    for i in range(B):
        engine.submit(Request(rid=i, tokens=prompts[i], max_new_tokens=GEN))
    reset_launches()
    t1 = time.perf_counter()
    done = {c.rid: [int(t) for t in c.tokens] for c in engine.run_until_drained()}
    return {"tokens": [done[i] for i in range(B)], "gaps": gaps,
            "node": grid.node.rank, "model": grid.model.rank,
            "flash_launches": flash_attention_launch.launches,
            "seconds": (t_grid - t0, t1 - t_grid, time.perf_counter() - t1)}


def main(argv=None, params=None) -> dict:
    """Serve B prompts; returns ``{"tokens": (B, GEN) list, "gaps": the top-2
    logit gap of each pick, "shards_agree": every rank of a shard picked
    the same tokens, "ranks": (node, model index) by rank,
    "flash_launches": by rank, "seconds": (grid, engine set up, serving)
    host seconds by rank}``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=600.0,
                   help="fail when a rank outlives this many seconds")
    args = p.parse_args(argv)
    cfg = tiny_lm(**CONFIG)
    if params is None:
        params = T.init_params(cfg, torch.Generator().manual_seed(0), tp=TP)
    params = tree_map(lambda x: np.asarray(x.detach().cpu() if torch.is_tensor(x) else x),
                      params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    ranks = run_ranks(_serve_rank, SHARDS * TP, params, prompts, args.device,
                      device=args.device, timeout_s=args.timeout)
    print(f"prefilled {B} requests x {PROMPT} tokens on a ({SHARDS} x {TP}) grid of "
          f"{len(ranks)} ranks")
    tokens = ranks[0]["tokens"]
    agree = all(r["tokens"] == tokens for r in ranks)
    print("greedy continuations (token ids):")
    for b in range(min(4, B)):
        print(f"  request {b}: {tokens[b]}")
    print(f"every rank picked the same tokens: {agree}")
    return {"tokens": tokens, "gaps": ranks[0]["gaps"], "shards_agree": agree,
            "ranks": [(r["node"], r["model"]) for r in ranks],
            "flash_launches": [r["flash_launches"] for r in ranks],
            "seconds": [r["seconds"] for r in ranks]}


if __name__ == "__main__":
    main(sys.argv[1:])
