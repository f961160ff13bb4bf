"""Tensor-parallel training of the rest of the zoo on gloo CPU ranks:

* every family's gradient (granite-moe in expert and ffn mode, xLSTM,
  hymba, the VLM with its patches, whisper's encoder-decoder with its
  frames) at tp = 2 and 4, each leaf joined over the model group, against
  the port's tp = 1 gradient of the same model at 1e-5 of the leaf's scale
  (padding gets none): replicated leaves (the router, sLSTM, norms,
  mLSTM's q/k and gates) whole on every rank, counted once;
* 2 steps of the 2 x 2 distributed step against the port's tp = 1 step
  for MoE in expert mode (granite-moe-1b's 4 experts) and ffn mode
  (granite-moe-3b's 5), on planes and per leaf with the clip norm over
  the model group, and the checkpoint form's round trip.

The ranks' bodies are in ``torch_tp_workers.py``."""

import pytest

import torch_tp_cases as C
import torch_tp_workers as W
from repro_torch.launch.mesh import run_ranks

TIMEOUT_S = 180
GRAD_RTOL = 1e-5
TRAIN_RTOL = {"params": 1e-5, "opt": 5e-4}  # as tests/test_torch_tp.py's


@pytest.fixture(scope="module")
def four():
    return run_ranks(W.zoo_grad_and_train_ranks, 4, C.ZOO_GRAD, device="cpu",
                     timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", C.ZOO_GRAD)
def test_joined_gradients_equal_tp1(four, arch, tp):
    res = dict(four[0]["grads"][tp][arch])
    assert res.pop("loss") < 1e-6
    for path, (rel, pad) in res.items():
        assert rel < GRAD_RTOL, (path, rel)
        assert pad == 0.0, (path, pad)


@pytest.mark.parametrize("case", sorted(W.ZOO_TRAIN["granite-moe-1b-a400m"]))
@pytest.mark.parametrize("arch", sorted(W.ZOO_TRAIN))
def test_moe_dist_step_2x2_matches_tp1(four, arch, case):
    res = four[0]["train"][arch][case]
    for part, tol in TRAIN_RTOL.items():
        assert res["err"][part] < tol, (part, res["err"])
    metrics, smetrics = res["metrics"]
    for m, s in zip(metrics, smetrics):
        assert abs(m["loss"] - s["loss"]) < 1e-5 * abs(s["loss"])
    for r in four:  # gather -> scatter -> reconcile gives each rank its state back
        assert r["train"][arch][case]["roundtrip"]
