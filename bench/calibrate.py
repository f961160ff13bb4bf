"""The readings that the limits in ``bench/limits/<cell>.json`` are set from,
at the cell's own size on the card, many seeds in one process (training's
readings need no measured window):

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6

For each of ``--seeds``, the program's first three steps against the
reference (the lower readings).  For each of ``--control-seeds``, the
reference put in the program's place three ways: computed in TF32 (the
control: the precision below the configuration's float32), with half of
each node's rows left out of its loss, and with the gossip's exchange left
out (the faults); each against the float32 reference.  One JSON line a
reading.  The benchmark's runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "bench", ".cache", "triton")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", dest="control_seeds", default="")
    args = p.parse_args(argv)

    import torch

    from bench import compare, harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.utils import resolve_device

    device = resolve_device("cuda")
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        prog = harness.Program(cell, seed, device, "triton")
        got = prog.check_steps()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        want = harness.reference_readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "program",
                          "numbers": compare.numbers(got, want), "losses": got["losses"],
                          "ref_losses": want["losses"],
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        want = harness.reference_readings(cell, seed, device)
        for side, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"fault": "half_batch"}),
                         ("fault_no_exchange", {"fault": "no_exchange"})):
            t = time.perf_counter()
            got = harness.reference_readings(cell, seed, device, **kw)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "numbers": compare.numbers(got, want),
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
