"""Tensor-parallel serving of the rest of the zoo on a (4, 2) grid of gloo
CPU ranks, against ``repro``'s ``build_prefill_step``/``build_decode_step``
on a (4, 2) mesh of 8 simulated devices (one JAX subprocess,
``torch_tp_ref.py zoo``), at ``tests/scripts/distributed_serve.py``'s
relative 5e-4: granite-moe-1b (expert-sharded), granite-moe-3b
(ffn-sharded), xlstm-350m (mLSTM on a rank's dv, sLSTM replicated),
hymba-1.5b (the SSM's channels beside windowed attention) and
internvl2-2b with its patch embeddings, each through prefill and 4
decode steps fed repro's tokens; the caches' rank shapes; the engine on
the grid against the one-process engine for the recurrent families (the
recurrent-state fault of the engine, mirrored as at tp = 1); and
whisper-tiny's training loss at tp 2 against repro's ``forward_loss``
inside ``shard_map``.  The ranks' bodies are in ``torch_tp_workers.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_tp_cases as C
import torch_tp_workers as W
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as T

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT_S = 180
# whisper's loss at tp 2 against repro's: f32 sums in another order
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "zoo.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_tp_ref.py"), out, "zoo"],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files if "/params/" not in k}
    ranks = run_ranks(W.zoo_serve_ranks, C.NODES * C.TP, out, device="cpu",
                      timeout_s=TIMEOUT_S)
    return ref, ranks


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.mark.parametrize("arch", C.ZOO_SERVE)
@pytest.mark.parametrize("phase", ["prefill"] + [f"decode{j}" for j in range(C.EXTRA)])
def test_sharded_serving_matches_repro(zoo, arch, phase):
    ref, ranks = zoo
    key = f"{arch}/{phase}"
    for r, got in enumerate(ranks):  # every rank holds the gathered logits
        assert got[key].shape == ref[key].shape, (r, key)
        assert _rel(got[key], ref[key]) < C.SERVE_RTOL, (r, key, _rel(got[key], ref[key]))


@pytest.mark.parametrize("arch", C.ZOO_SERVE)
def test_cache_is_sharded_as_repros_cache_specs(zoo, arch):
    """The kv cache by sequence, the mLSTM memory on its value columns, the
    SSM state and conv tail on their channels; the rest whole."""
    _, ranks = zoo
    cfg = get_config(arch, smoke=True)
    rows = C.ZOO_B // C.NODES
    groups = T.block_groups(cfg)
    for gi, g in enumerate(groups):
        c = ranks[0][f"{arch}/cache"][f"g{gi}"]
        if "kv" in c:
            tl = C.ZOO_S + C.EXTRA
            cap = min(g.window, tl) if g.window else tl
            assert c["kv"]["k"][1:] == (rows, -(-cap // C.TP), cfg.n_kv_heads, cfg.hd), (gi, c)
        if "mlstm" in c:
            dh = 2 * cfg.d_model // cfg.n_heads
            assert c["mlstm"]["C"][1:] == (rows, cfg.n_heads, dh, dh // C.TP)
            assert c["mlstm"]["n"][1:] == (rows, cfg.n_heads, dh)
        if "slstm" in c:
            assert c["slstm"]["c"][1:] == (rows, cfg.d_model)
        if "ssm" in c:
            ds = cfg.d_ssm_inner // C.TP
            assert c["ssm"]["h"][1:] == (rows, ds, cfg.ssm_state)
            assert c["ssm"]["conv"][1:] == (rows, cfg.ssm_conv - 1, ds)


@pytest.mark.parametrize("arch", [a for a in C.ZOO_SERVE
                                  if get_config(a, smoke=True).xlstm
                                  or get_config(a, smoke=True).ssm])
def test_engine_on_the_grid_matches_one_process(zoo, arch):
    """Every rank completes the same requests with the same tokens as the
    tp = 1 engine (which carries the reference engine's recurrent-state
    fault: the pad tail enters the state; so does every rank's shard)."""
    _, ranks = zoo
    want = ranks[0][f"{arch}/engine1"]
    assert len(want) == 11
    for r in ranks:
        assert r[f"{arch}/engine"] == want


def test_whisper_training_loss_at_tp2_matches_repros_shard_map(zoo):
    ref, ranks = zoo
    want = float(ref["whisper-tiny/loss_tp2"])
    assert abs(want - float(ref["whisper-tiny/loss_tp1"])) < LOSS_RTOL * want
    for r in ranks:
        assert abs(r["whisper-tiny/loss_tp2"] - want) < LOSS_RTOL * want
