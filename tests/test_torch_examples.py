"""The five examples of the port (``examples/torch_*.py``), each through
its ``main`` on the CPU:

* none imports ``jax`` or ``repro``;
* ``torch_bias_demo`` and ``torch_sim_cluster`` print the traces of the JAX
  examples (run as subprocesses with ``JAX_PLATFORMS=cpu``) within
  ``TRACE_RTOL`` (their ``.3e`` print rounds to 5e-4 of a value), the
  simulator's schedule exactly;
* ``torch_serve_lm`` on the JAX example's weights (``init_params(jax.random.
  key(0), cfg, tp=2)`` through ``interop``) picks the JAX example's 8 x 16
  greedy tokens; where a request's tokens first differ, the port's two
  largest logits there are within ``GAP_TOL`` (an f32 near-tie);
* ``torch_quickstart`` and ``torch_train_lm`` against the port's own CLI on
  the same arguments (their JAX versions fail on this tree in jax's
  ``shard_map`` check, a reference-side fault: ROADMAP.md §3), at fewer
  steps.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
if EXAMPLES not in sys.path:  # the spawned ranks import the examples by name
    sys.path.insert(0, EXAMPLES)

import torch_bias_demo  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_lm  # noqa: E402
import torch_sim_cluster  # noqa: E402
import torch_train_lm  # noqa: E402

PORTED = ["torch_bias_demo", "torch_quickstart", "torch_serve_lm", "torch_sim_cluster",
          "torch_train_lm"]
TRACE_RTOL = 5e-3
GAP_TOL = 1e-4  # absolute: the logits are O(1), the two packages agree to ~1e-6
JAX_TIMEOUT_S = 240
_SERVE_REF = """
import runpy, sys
import jax
import numpy as np
g = runpy.run_path("examples/serve_lm.py", run_name="serve_lm")
flat = {"/".join(str(p.key) for p in path): np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(g["params"])[0]}
np.savez(sys.argv[1], gen=np.asarray(g["gen"]), **{"params/" + k: v for k, v in flat.items()})
"""


def _env():
    # one thread each: the examples' ops are small, and the test shares the
    # host's cores with the suite's other workers
    return {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
            "PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's examples on one intra-op thread, as the JAX ones run."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The three JAX examples that run on this tree, started together:
    bias_demo's and sim_cluster's stdout, serve_lm's tokens and weights."""
    npz = str(tmp_path_factory.mktemp("serve_lm") / "ref.npz")
    cmds = {"bias_demo": [sys.executable, "examples/bias_demo.py"],
            "sim_cluster": [sys.executable, "examples/sim_cluster.py"],
            "serve_lm": [sys.executable, "-c", _SERVE_REF, npz]}
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            out[k] = p.communicate(timeout=JAX_TIMEOUT_S)[0]
            assert p.returncode == 0, (k, out[k][-2000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    with np.load(npz) as z:
        out["serve_lm"] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_neither_jax_nor_repro(name):
    with open(os.path.join(EXAMPLES, name + ".py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}, roots


def _rows(text, pattern):
    return [m.groups() for m in re.finditer(pattern, text, re.M)]


def test_bias_demo_matches_the_jax_example(jax_runs):
    res = torch_bias_demo.main(["--device", "cpu"])
    rows = _rows(jax_runs["bias_demo"], r"^\s*(\d+)\s+(\S+e\S+)\s+(\S+e\S+)\s+(\S+e\S+)\s*$")
    assert [int(r[0]) for r in rows] == res["ticks"] and len(rows) == 11
    for i, row in enumerate(rows):
        for a, v in zip(torch_bias_demo.ALGOS, row[1:]):
            assert res["traces"][a][i] == pytest.approx(float(v), rel=TRACE_RTOL), (a, i)
    amp = float(re.search(r"amplification: (\S+)x", jax_runs["bias_demo"]).group(1))
    ratio = float(re.search(r"bias ratio: (\S+)", jax_runs["bias_demo"]).group(1))
    assert abs(res["amplification"] - amp) <= 0.05 + TRACE_RTOL * amp
    assert abs(res["ratio"] - ratio) <= 0.005 + TRACE_RTOL * ratio


def test_sim_cluster_matches_the_jax_example(jax_runs):
    res = torch_sim_cluster.main(["--device", "cpu"])
    text = jax_runs["sim_cluster"]
    rows = _rows(text, r"^\s*(\d+\.\d)\s+(\d+)-(\d+)\s+(\S+e\S+)\s+(\S+e\S+)\s*$")
    assert len(rows) == len(res["trace"]) > 10
    for row, mine in zip(rows, res["trace"]):
        assert f"{mine['t']:.1f}" == row[0]
        assert (mine["min_step"], mine["max_step"]) == (int(row[1]), int(row[2]))
        assert mine["consensus"] == pytest.approx(float(row[3]), rel=TRACE_RTOL)
        assert mine["metric"] == pytest.approx(float(row[4]), rel=TRACE_RTOL)
    summary = dict(_rows(text, r"^  (\w+)\s+(.+)$"))
    for key in ("n_start", "n_final", "recovery_mode", "steps_min", "steps_max",
                "steps_total", "events"):
        assert str(res["summary"][key]) == summary[key], key
    for key in ("sim_time", "stall_time_total", "effective_batch_fraction"):
        assert res["summary"][key] == pytest.approx(float(summary[key]), rel=1e-6), key
    # the projection is on the H100's constants, labelled as such
    assert "TPU" in text and "TPU" not in res["projection_label"]
    assert "H100" in res["projection_label"] and res["projection"]["wallclock_s"] > 0


def test_serve_lm_gives_the_jax_examples_tokens(jax_runs):
    ref = jax_runs["serve_lm"]
    params = {}
    for key, v in ref.items():
        if key.startswith("params/"):
            node = params
            *parents, last = key[len("params/"):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = v
    res = torch_serve_lm.main(["--device", "cpu", "--timeout", "200"], params=params)
    assert res["shards_agree"] and res["flash_launches"] == [0] * 8  # plain on the CPU
    assert sorted(res["ranks"]) == [(i, m) for i in range(4) for m in range(2)]
    got, want = np.asarray(res["tokens"]), ref["gen"]
    assert got.shape == want.shape == (8, 16)
    for b in range(8):
        differ = np.nonzero(got[b] != want[b])[0]
        if differ.size:  # an f32 near-tie: the two largest logits within GAP_TOL
            k = int(differ[0])
            assert res["gaps"][b, k] < GAP_TOL, (b, k, res["gaps"][b, k])


def test_quickstart_matches_the_cli(monkeypatch):
    """The example's loop is the stacked CLI's: the same losses and
    consensus distances, step for step, for both algorithms."""
    steps = 6
    res = torch_quickstart.main(["--device", "cpu", "--steps", str(steps)])
    monkeypatch.setattr(cli, "_model_config",
                        lambda args: torch_quickstart.tiny_lm(**torch_quickstart.CONFIG))
    monkeypatch.setattr(cli, "_train_config",
                        lambda args: torch_quickstart.train_config(args.algorithm))
    for algo in torch_quickstart.ALGOS:
        mine = res[algo]
        assert all(np.isfinite(mine["losses"])) and mine["rounds"] == steps
        assert mine["hops"] > 0 and mine["egress_bytes"] > 0
        want = cli.main(["--nodes", str(torch_quickstart.N_NODES), "--algorithm", algo,
                         "--seq-len", str(torch_quickstart.SEQ), "--per-node-batch", "4",
                         "--heterogeneity", "0.5", "--steps", str(steps), "--track-consensus",
                         "--device", "cpu", "--log-every", "100"])
        assert mine["losses"] == want["losses"], algo
        assert mine["consensus_sq"] == want["consensus_sq"], algo


def test_train_lm_matches_the_cli(tmp_path):
    """The example is the CLI with the JAX example's argv and a checkpoint
    directory of the caller's: the same losses and drill (8 -> 4 nodes)."""
    cut = ["--steps", "4", "--seq-len", "32", "--per-node-batch", "2", "--timeout", "200"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    res = torch_train_lm.main(["--device", "cpu", "--ckpt-dir", a] + cut)
    want = cli.main(torch_train_lm.ARGV + ["--ckpt-dir", b, "--device", "cpu"] + cut)
    assert res["drill"] == want["drill"] == {"step": 2, "from": 8, "to": 4}
    assert len(res["losses"]) == 4 and all(np.isfinite(res["losses"]))
    assert res["losses"] == want["losses"]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["step_00000004"]
    assert torch_train_lm.argv_of([])[-4:] == ["--ckpt-dir", os.path.normpath(
        torch_train_lm.DEFAULT_CKPT), "--device", "cuda"]
    assert "/tmp" not in torch_train_lm.DEFAULT_CKPT
