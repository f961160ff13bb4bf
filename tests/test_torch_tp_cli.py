"""The CLI's tensor parallelism and serving while training on the
one-process-per-node trainer, on gloo CPU ranks:

* ``--simulate-nodes 2 --tp 2`` (4 ranks) prints its grid, checkpoints the
  global state with ``plane_tp`` 2, and a resume at tp = 1 from its
  halfway checkpoint continues with the tp 2 run's losses (the 2 x 2 step
  against the tp 1 step: ``test_torch_tp.py``);
* ``--simulate-nodes 2 --serve-while-training``: rank 0 publishes its node
  (every shipped snapshot equals node 0's weights bit for bit) and serves
  every request;
* what stays refused: the stacked trainer at tp > 1, serving while
  training at tp > 1.
"""

import json
import os
import shutil

import pytest

import torch_tp_workers as W
from repro_torch.launch import train as cli

BASE = ["--device", "cpu", "--arch", "qwen3-0.6b", "--smoke", "--seq-len", "32",
        "--per-node-batch", "2", "--fused-update", "--log-every", "1", "--timeout", "150"]


def test_tp2_trains_and_resumes_across_tp(tmp_path, capfd):
    ckpt = str(tmp_path / "ckpt")
    tp2 = cli.main(["--simulate-nodes", "2", "--tp", "2", "--steps", "4", "--flat-planes",
                    "--ckpt-dir", ckpt, "--ckpt-every", "2"] + BASE)
    assert "mesh: 2 nodes x 2-way TP (4 ranks)" in capfd.readouterr().out
    assert tp2["tp"] == 2 and tp2["n_nodes"] == 2
    with open(os.path.join(ckpt, "step_00000002", "manifest.json")) as f:
        assert json.load(f)["plane_tp"] == 2
    # the halfway checkpoint, at tp = 1 per leaf
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    res = cli.main(["--simulate-nodes", "2", "--steps", "4", "--ckpt-dir", ckpt,
                    "--resume"] + BASE)
    assert res["start_step"] == 2
    assert res["losses"] == pytest.approx(tp2["losses"][2:], rel=1e-5)


def test_serve_while_training_on_ranks():
    res = cli.main(["--simulate-nodes", "2", "--steps", "4", "--flat-planes",
                    "--serve-while-training", "--publish-every", "2"] + BASE,
                   on_serve=W.check_snapshots)
    serve = res["serve"]
    assert serve["completed"] == 8
    assert serve["publisher"]["published"] == 2
    assert serve["on_serve"] == {"checked": 2, "equal": 2}


@pytest.mark.parametrize("argv, err", [
    (["--nodes", "2", "--tp", "2"], NotImplementedError),
    (["--simulate-nodes", "2", "--tp", "2", "--serve-while-training"], ValueError),
    (["--simulate-nodes", "2", "--tp", "2", "--failure-drill"], NotImplementedError),
])
def test_refusals(argv, err):
    with pytest.raises(err):
        cli.main(argv + ["--device", "cpu", "--smoke", "--steps", "1"])
