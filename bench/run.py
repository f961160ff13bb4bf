"""The benchmark of the PyTorch port (``repro_torch``): one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; then ``checks``, each number compared beside its
limit, which are also the last lines of standard error.  Exits non-zero
and prints no result without a CUDA card (or with fewer than the cell
asks for), and if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed.  The Triton cache and the
Python bytecode of every module the run imports live in ``bench/.cache`` of
the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # bytecode at a fixed path in the checkout, written even where the
    # environment says not to: where the installed packages ship none (torch
    # and triton on the card's host), every run would compile their sources
    # again, seconds of set-up that swing with the host's load
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    marks = {}
    t = time.perf_counter()
    import torch

    marks["import torch"] = time.perf_counter() - t
    t = time.perf_counter()
    from bench import harness

    cell = harness.load_cell(args.workload)
    marks["harness"] = time.perf_counter() - t
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from repro_torch.utils import resolve_device

    device = resolve_device("cuda")
    torch.zeros(1, device=device)  # the card's context, made here so set-up's log shows it
    torch.cuda.synchronize(device)
    marks["cuda init"] = time.perf_counter() - t
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0,
                           device=device, marks=marks)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(res["memory_peak_bytes"]),
                   "power_limit": power_limit()}
    if args.trace:
        device_info.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device_info}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    # a non-finite number (a reading that never came) is printed as a string
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                          "limit": c["limit"]} for k, c in res["checks"].items()}
    for msg in res["log"]:
        print(msg, file=sys.stderr)
    print(f"device {device_info['kind']}, power limit {device_info['power_limit']}",
          file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
