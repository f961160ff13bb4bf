"""The failure drill on a ``(nodes x tp)`` grid, on gloo CPU ranks:
``--simulate-nodes 2 --tp 2 --failure-drill`` shrinks 2 x 2 to 1 x 2
halfway, once on planes (the rank bodies spawned directly, so that every
rank's result comes back) and once per leaf (through the CLI).  The losses
are finite; the survivors' state, gathered again, equals ``repro``'s
``elastic_reshape`` of the state gathered before the shrink bit for bit,
with a fresh channel of the reference's global shapes; the leaving ranks
return their record, and no rank outlives ``--timeout``."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_workers as W
from repro.train import checkpoint as jckpt
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import run_ranks

TIMEOUT_S = 150
ARGV = ["--device", "cpu", "--arch", "qwen3-0.6b", "--smoke", "--seq-len", "32",
        "--per-node-batch", "2", "--fused-update", "--log-every", "1", "--simulate-nodes",
        "2", "--tp", "2", "--steps", "3", "--failure-drill", "--algorithm", "decentlam-sa",
        "--gossip-delay", "1", "--timeout", str(TIMEOUT_S)]


@pytest.fixture(scope="module")
def planes():
    t = time.monotonic()
    out = run_ranks(cli.rank_main, 4, ARGV + ["--flat-planes"], None, W.shrink_states,
                    device="cpu", timeout_s=TIMEOUT_S)
    return out, time.monotonic() - t


@pytest.fixture(scope="module")
def per_leaf():
    return cli.main(ARGV, on_shrink=W.shrink_states)


def _check_against_repro(res):
    assert res["drill"] == {"step": 1, "from": 2, "to": 1}
    assert res["n_nodes"] == 1 and res["tp"] == 2
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    shrink = res["on_shrink"]
    assert shrink["grid"] == (1, 2, 2)
    gathered, now = shrink["gathered"], shrink["now"]
    assert any(v.any() for v in gathered["channel"].values())  # a ring was in flight
    want = jckpt.elastic_reshape(jax.tree.map(jnp.asarray, gathered), 1)
    for part in ("params", "opt"):
        assert sorted(now[part]) == sorted(want[part]), part
        for k, w in want[part].items():
            assert now[part][k].tobytes() == np.asarray(w).tobytes(), (part, k)
    # the channel starts afresh, in the global form repro's reset has
    chan = {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in want["channel"].items()}
    assert {k: (v.shape, v.dtype) for k, v in now["channel"].items()} == chan
    assert not any(v.any() for v in now["channel"].values())


def test_drill_on_planes_shrinks_the_grid(planes):
    out, _ = planes
    _check_against_repro(out[0])
    assert out[1]["n_nodes"] == 1 and out[1]["losses"] == out[0]["losses"]


def test_drill_per_leaf_shrinks_the_grid(per_leaf):
    _check_against_repro(per_leaf)


def test_leaving_ranks_return_their_record_in_time(planes):
    out, seconds = planes
    assert out[2] == {"left_at_step": 1, "rank": 2}
    assert out[3] == {"left_at_step": 1, "rank": 3}
    assert seconds < TIMEOUT_S
