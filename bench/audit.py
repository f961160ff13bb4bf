"""Where a cell's traced steps go, read off the program's spans
(``bench/spans.py``), and whether its host syncs are all named:

    python3 bench/audit.py --workload <name> --seed <n>

Builds the cell's trainer as the benchmark does, runs the three checked
steps and two more, profiles the cell's ``profiled_steps`` steps as a traced
run does (``harness._profile``) and prints one JSON object: per profiled
step the device-busy ms, each phase's and gossip span's device ms and host
ms, the device ms launched in the step outside every phase span
(``untiled_ms``), the drained-queue idle ms after the syncs, the sync
spans, every host call that waits for the device inside the step and no
``sync.*`` span (``unspanned_syncs``), and the traced seconds per step.
The benchmark's runs do not run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "bench", ".cache", "triton"))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SPANS = ("train.prepare", "train.forward", "train.backward", "train.guard", "train.update",
         "train.metrics", "gossip.apply", "gossip.codec", "gossip.mix", "sync.finite_guard",
         "sync.metrics", "moe_router", "moe_dispatch", "moe_experts", "moe_combine")


def audit(cell, seed: int, device, impl: str = "triton") -> dict:
    from bench import harness, spans

    prog = harness.Program(cell, seed, device, impl)
    prog.check_steps()
    for _ in range(2):
        prog.step()
    harness.sync(device)
    k = int(cell.traffic["profiled_steps"])
    tr, seconds, _ = harness._profile(prog, k)
    sp = spans.Spans(tr)
    host: dict[str, int] = {}
    for name, _, s, e in tr.cpu:
        if name in SPANS:
            host[name] = host.get(name, 0) + e - s
    out = {
        "workload": cell.name, "seed": seed, "profiled_steps": k,
        "traced_s_per_step": seconds / k,
        "busy_ms": tr.busy_ns() / 1e6 / k,
        "device_ms": {n: sp.device_ns(n) / 1e6 / k for n in SPANS if n in sp.count},
        "update_self_ms": sp.device_ns("train.update", ("gossip.apply",)) / 1e6 / k,
        "host_ms": {n: v / 1e6 / k for n, v in host.items()},
        "spans_per_step": {n: sp.count[n] / k for n in SPANS if n in sp.count},
        "untiled_ms": sp.untiled_ns() / 1e6 / k,
        "unplaced_ms": (sum(e - s for _, s, e, _ in tr.device)
                        - sum(ns for _, ns in sp.launched())) / 1e6 / k,
        "sync_idle_ms": sp.sync_idle_ns() / 1e6 / k,
        "unspanned_syncs": sp.unspanned_syncs(),
        "idle_gaps": tr.idle_gaps(harness.STEP_SPAN),
    }
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("audit needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.utils import resolve_device

    device = resolve_device("cuda")
    out = audit(harness.load_cell(args.workload), args.seed, device)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
