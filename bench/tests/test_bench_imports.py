"""Nothing the harness or the reference runs loads JAX or the JAX package:
a whole run on the CPU (traced, every reader and both references loaded) in
a fresh interpreter, then its modules compared by their whole top-level
name (``repro_torch`` begins with ``repro``, and is the system under test)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCRIPT = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
import bench.run, bench.calibrate
from bench import harness
from bench.reference import dense, moe
from bench.tests.tiny import tiny_cell
for name in ("olmo-1b.l8.b1k.int8ef", "granite-moe-1b-a400m.l12.b4k"):
    res = harness.run_cell(tiny_cell(name), 9, 0.1, True, t0=time.perf_counter(),
                           device=torch.device("cpu"), impl="torch")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_a_run():
    code = SCRIPT.format(root=ROOT, src=os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, tops
