"""The channel state across a ``(nodes x tp)`` grid's checkpoint, on gloo
CPU ranks (one spawned group of 4, ``torch_tp_workers.resume_ranks``):

* a 2 x 2 run at ``--gossip-delay 1`` on planes and one with
  ``--compression int8-row-ef`` per leaf, saved at step 2 and resumed, equal
  the unbroken 4 steps bit for bit in every rank's tensors, the channel's
  ring, ``count``, residuals and telemetry included;
* the checkpoint holds the channel in ``repro``'s global form, which
  ``repro``'s ``restore_checkpoint`` reads and its ``ensure_channel_state``
  keeps at tp 2;
* a tp 2 checkpoint resumed at tp 1 and at tp 2 keeps or re-initializes
  each channel leaf exactly where ``repro.train.train_state.
  ensure_channel_state`` (with ``repro``'s channel from ``build_channel``)
  keeps or re-initializes it.
"""

import os

import jax
import numpy as np
import pytest

import torch_tp_workers as W
from repro_torch.core.optimizers import make_optimizer
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import run_ranks

TIMEOUT_S = 240
N = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_resume"))
    return root, run_ranks(W.resume_ranks, 4, root, device="cpu", timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("case", sorted(W.RESUME_CASES))
def test_resume_at_tp2_equals_the_unbroken_run(runs, case):
    _, ranks = runs
    res = ranks[0][case]
    unbroken, resumed = res["losses"]
    assert res["start"] == 2 and resumed == unbroken[2:]
    for r in ranks:  # every rank's parameters, optimizer and channel state
        assert r[case]["differ"] == [], r[case]["differ"][:5]
    chan = res["channel"]
    assert any(k.startswith("channel/t/") for k in chan)
    if "delay" in case:
        assert any(k.endswith("/count") for k in chan) and any("/hist/" in k for k in chan)
    else:
        assert any(k.startswith("channel/comp/") for k in chan)
    # the resumed run's last checkpoint equals the unbroken run's
    root = os.path.join(runs[0], case)
    za = np.load(os.path.join(root, "a", "step_00000004", "state.npz"))
    zb = np.load(os.path.join(root, "b", "step_00000004", "state.npz"))
    assert sorted(za.files) == sorted(zb.files)
    assert any(k.startswith("channel/") for k in za.files)
    for k in za.files:
        assert za[k].tobytes() == zb[k].tobytes(), k


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", sorted(W.RESUME_CASES))
def test_cross_tp_resume_keeps_what_repro_keeps(runs, case):
    """Each channel leaf of the tp 2 checkpoint: kept (the ranks hold their
    part of it) or re-initialized (zeros) at tp 1 and at tp 2, as
    ``repro``'s ``ensure_channel_state`` decides on the global state; at
    tp 1 a kept leaf is the node's row bit for bit."""
    from repro.configs import get_config
    from repro.core.gossip import build_channel
    from repro.core.topology import build_topology
    from repro.train import checkpoint as jckpt
    from repro.train.train_state import ensure_channel_state, model_plane_layout

    root, ranks = runs
    host, manifest = jckpt.restore_checkpoint(os.path.join(root, case, "a"))
    args = cli._parse(W.RESUME_ARGV + W.RESUME_CASES[case])
    assert manifest.get("plane_tp") == (2 if args.flat_planes else None)
    assert manifest["channel_layout"] == "per-node"
    stored = _flat(host["channel"])
    assert stored
    tcfg = cli._train_config(args)
    channel = build_channel("ppermute", build_topology(args.topology, N), ("data",),
                            compression=args.compression, delay=args.gossip_delay,
                            calls_per_step=make_optimizer(tcfg.opt_config()).gossips_per_step,
                            telemetry=True)
    cfg = get_config(args.arch, smoke=True)
    mine_all = [r[case] for r in ranks]
    for tp, key, holders in ((2, "at2", mine_all), (1, "at1", mine_all[:2])):
        layout = model_plane_layout(cfg, tp) if args.flat_planes else None
        ref = _flat(ensure_channel_state(host, channel, N, layout)["channel"])
        assert sorted(ref) == sorted(holders[0][key]), (tp, sorted(ref))
        decided = {}
        for path, leaf in stored.items():
            if not leaf.any():
                continue  # zeros kept and zeros re-initialized look alike
            kept = path in ref and np.array_equal(ref[path], leaf)
            assert kept or not ref[path].any(), (tp, path)
            mine = [r[key][path] for r in holders]
            assert all(m.any() for m in mine) == kept, (tp, path, kept)
            assert kept or not any(m.any() for m in mine), (tp, path)
            if kept and tp == 1:
                for i, m in enumerate(mine):
                    assert m.tobytes() == leaf[i:i + 1].tobytes(), (path, i)
            decided[path] = kept
        if tp == 2:  # repro keeps the tp 2 checkpoint's channel at tp 2
            assert decided and all(decided.values()), decided
        elif args.flat_planes:  # the global plane rows differ between tp 1 and tp 2
            assert not any(v for p, v in decided.items() if "/hist/" in p), decided
        else:  # tree-form residuals have the global parameters' shapes at every tp
            assert all(decided.values()), decided
