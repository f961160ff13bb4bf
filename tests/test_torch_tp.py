"""Tensor parallelism of the port's dense decoders on a (nodes x tp) grid of
gloo CPU ranks:

* sharded serving on the (4, 2) grid against ``repro``'s
  ``build_prefill_step``/``build_decode_step`` on a (4, 2) mesh of 8
  simulated devices (one JAX subprocess, ``torch_tp_ref.py``), the full
  batch and the ``global_batch=1`` fallback, at ``tests/scripts/
  distributed_serve.py``'s relative 5e-4, on its config and on one with
  padded q heads and vocabulary, qk-norm and a sharded rolling window;
  the continuous-batching engine on the grid against the one-process
  engine;
* every leaf's gradient at tp = 2 and 4, joined over the model group,
  against the port's tp = 1 gradient of the same model (padding gets
  none);
* 2 steps of the 2 x 2 distributed step against the port's tp = 1 step
  (the stacked step) on planes and per leaf, with clip and LARS norms
  over the model group; the checkpoint form round trip; the publisher's
  sharded plane source.

The ranks' bodies are in ``torch_tp_workers.py``; each spawned group has a
deadline."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_tp_cases as C
import torch_tp_workers as W
from repro_torch.launch.mesh import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT_S = 180
# the distributed step against the stacked one: f32 sums over the model
# group round in another order; relative to each leaf's scale.  The
# parameters hold to TRAIN_RTOL; decentlam's momentum carries (x - mix) /
# lr, which turns the parameters' rounding into ~1e-4 of its own scale
TRAIN_RTOL = {"params": 1e-5, "opt": 5e-4}
# a joined gradient against tp = 1's, relative to the leaf's scale
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_tp_ref.py"), out],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files if "/params/" not in k}
    ranks = run_ranks(W.serve_ranks, C.NODES * C.TP, out, device="cpu", timeout_s=TIMEOUT_S)
    return ref, ranks


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.mark.parametrize("case", sorted(C.SERVE_CASES))
@pytest.mark.parametrize("tag", ["b8", "b1"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_sharded_serving_matches_repro(serve, case, tag, phase):
    ref, ranks = serve
    key = f"{case}/{tag}/{phase}"
    for r, got in enumerate(ranks):  # every rank holds the gathered logits
        assert got[key].shape == ref[key].shape, (r, key)
        assert _rel(got[key], ref[key]) < C.SERVE_RTOL, (r, key, _rel(got[key], ref[key]))
    # the cache is sequence-sharded: each rank holds 1/tp of the slots (of
    # the window's rolling buffer, where there is one)
    window = C.SERVE_CASES[case].get("sliding_window", 0)
    cap = min(window, C.S + C.EXTRA) if window else C.S + C.EXTRA
    assert ranks[0][f"{case}/{tag}/slots"] == -(-cap // C.TP)


def test_batch_split_and_replicated_fallback(serve):
    _, ranks = serve
    assert all(r[f"{c}/split"] for r in ranks for c in C.SERVE_CASES)  # 8 rows over 4 nodes


@pytest.mark.parametrize("source", ["params", "publisher"])
def test_engine_on_the_grid_matches_one_process(serve, source):
    """Every rank completes the same requests with the same tokens as the
    tp = 1 engine, from a global tree or from a publisher's global
    snapshot; the first decode batch's logits agree at 5e-4.  Each rank
    holds its serving shard only: the leaves' own storage, or the shard's
    planes, less than the global tree."""
    _, ranks = serve
    done1, lg1, _, _ = ranks[0]["engine1"]
    assert len(done1) == 11
    for r in ranks:
        done, lg, stats, (held, local, whole, planes) = r[
            "engine" if source == "params" else "engine_pub"]
        assert done == done1
        assert stats["completed"] == 11
        assert _rel(lg[:, :lg1.shape[1]], lg1) < C.SERVE_RTOL
        assert local < whole
        assert held == (local if source == "params" else planes)
        assert source == "params" or stats["version"] == 1


@pytest.fixture(scope="module")
def four():
    """The gradient and the train cases in one spawned group of 4 ranks."""
    return run_ranks(W.grad_and_train_ranks, 4, device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def grads(four):
    return four[0]["grads"]


@pytest.mark.parametrize("case", sorted(C.GRAD_CASES))
def test_joined_gradients_equal_tp1(grads, case):
    res = grads[case]
    assert res.pop("loss") < 1e-5
    for path, (rel, pad) in res.items():
        assert rel < GRAD_RTOL, (path, rel)
        assert pad == 0.0, (path, pad)  # padded heads and vocab rows get no gradient


@pytest.fixture(scope="module")
def train(four):
    return [r["train"] for r in four]


@pytest.mark.parametrize("case", sorted(W.TRAIN_CASES))
def test_dist_step_2x2_matches_tp1(train, case):
    res = train[0][case]
    for part, tol in TRAIN_RTOL.items():
        assert res["err"][part] < tol, (part, res["err"])
    metrics, smetrics = res["metrics"]
    for m, s in zip(metrics, smetrics):
        assert abs(m["loss"] - s["loss"]) < 1e-5 * abs(s["loss"])
    if "consensus" in res:
        # repro's _consensus_metric at tp > 1: each model rank's sum over
        # its shard (replicated leaves whole), the mean over the model
        # group; not the unsharded sum of the tp = 1 step
        got, want, whole = res["consensus"]
        assert abs(got - want) <= 1e-5 * want + 1e-12, (got, want)
        if case == "leaf-disconnected":
            assert want > 1e-6 * whole > 0 and abs(want - whole) > 1e-3 * whole
    # gather -> scatter -> reconcile -> ensure gives each rank its state back,
    # the channel's included
    for r in train:
        assert r[case]["roundtrip"]
    # the gathered (checkpoint) state holds the channel state (the telemetry)
    assert res["channel"]


def test_publisher_takes_the_sharded_plane_form(train):
    assert train[0]["planes-decentlam"]["publisher"]
