"""The distributed trainer: one process per node over ``torch.distributed``
(4 gloo CPU ranks).  The distributed step against the port's stacked step
(itself held against ``repro`` on the CPU) at the reference's
distributed-vs-oracle tolerances, the bitwise claims within the distributed
path, the ``--simulate-nodes`` CLI with checkpoint, resume and the failure
drill, a distributed checkpoint read by ``repro``, and ``launch/elastic.py``
against ``repro.launch.elastic``."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_workers as W
from repro.launch import elastic as jelastic
from repro.train import checkpoint as jckpt
from repro_torch.core import topology as ttopo
from repro_torch.launch import elastic as telastic
from repro_torch.launch import train
from repro_torch.launch.mesh import run_ranks

N = 4
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def cases():
    return run_ranks(W.train_cases, N, device="cpu", timeout_s=TIMEOUT_S)[0]


@pytest.mark.parametrize("name,tol", [(c[0], c[3]) for c in W.TRAIN_CASES if c[3] is not None])
def test_distributed_step_matches_stacked_step(name, tol, cases):
    """Losses to 1e-6 relative; the final parameters within the reference's
    distributed-vs-oracle tolerance (2e-5, 5e-2 with bf16 messages), the
    optimizer state within it over lr (the momentum is the mix's difference
    over lr); int8-row-ef and top-k finite with their residuals populated;
    the telemetry counts every round on every node."""
    res = cases[name]
    losses = [m["loss"] for m in res["metrics"]]
    assert all(np.isfinite(losses)) and res["finite"], name
    bytes_, rounds = res["tele"]
    # pmsgd means (psum) and never gossips; da-dmsgd gossips twice a step
    gossips = 0 if "pmsgd" in name or "lars" in name else 2 if "da-dmsgd" in name else 1
    assert list(rounds) == [W.TRAIN_STEPS * gossips] * N
    assert (bytes_ == bytes_[0]).all() and (bytes_[0] > 0) == (gossips > 0)
    if tol == "finite":
        assert res["comp_nonzero"] > 0.0
        return
    want = [m["loss"] for m in res["stacked_metrics"]]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    assert res["err"]["params"] < tol and res["err"]["opt"] < tol / W.TRAIN_LR, res["err"]
    for key in ("gossip_gap", "skipped_nonfinite", "consensus_sq"):
        if key in res["metrics"][0]:
            np.testing.assert_allclose([m[key] for m in res["metrics"]],
                                       [m[key] for m in res["stacked_metrics"]], rtol=1e-5)


def test_gossip_gap_and_consensus_are_fleet_wide(cases):
    """gossip_gap is the fleet maximum (0 then 1 at delay 1, 0 then 1 then 2
    at delay 2); the consensus distance is reported every step."""
    assert [m["gossip_gap"] for m in cases["smoke-sa-delay1-planes"]["metrics"]] == [0, 1, 1]
    assert [m["gossip_gap"] for m in cases["tiny-sa-delay2"]["metrics"]] == [0, 1, 2]
    assert all(m["consensus_sq"] > 0 for m in cases["smoke-grad-accum-consensus"]["metrics"])


def test_sparse_and_resilient_steps_account_and_guard(cases):
    """The sparse steps' volume: exact mode ships fewer bytes than dense
    (an untied embedding's untouched rows stay home), equal on every node;
    delta mode trains finite; the resilient step quarantines node 2's NaN
    round on every receiver, and its parameters stay finite."""
    for name in ("smoke-sparse-exact-planes", "moe-sparse-exact-planes",
                 "smoke-sparse-exact-sa-delay1", "smoke-sparse-delta-planes"):
        vol = cases[name]["vol"]
        assert (vol["rounds"] == W.TRAIN_STEPS).all(), name
        assert (vol["sparse"] < vol["dense"]).all() and (vol["sparse"] > 0).all(), name
        if "exact" in name:
            assert (vol["sparse"] == vol["sparse"][0]).all(), name
    delta = cases["smoke-sparse-delta-planes"]
    assert delta["finite"] and all(np.isfinite(m["loss"]) for m in delta["metrics"])
    res = cases["smoke-chaos-resilient-planes"]
    assert res["finite"] and (res["quarantined"] > 0).all()


@pytest.mark.parametrize("pair", [f"{a} == {b}" for a, b in W.TRAIN_BITWISE])
def test_bitwise_claims_within_the_distributed_path(pair, cases):
    """Planes == per leaf and the stage executor == its plain version, on the
    final parameters and optimizer state bit for bit."""
    assert cases["bitwise"][pair]


def test_delay_zero_equals_the_undelayed_channel_for_every_algorithm(cases):
    from repro_torch.core.optimizers import ALGORITHMS

    assert cases["delay0"] == {a: True for a in ALGORITHMS}


CLI = ["--simulate-nodes", str(N), "--device", "cpu", "--arch", "qwen3-0.6b", "--smoke",
       "--seq-len", "16", "--per-node-batch", "2", "--fused-update", "--log-every", "1",
       "--timeout", str(TIMEOUT_S)]


@pytest.mark.parametrize("extra", [
    ["--gossip-impl", "allgather", "--track-consensus"],
    ["--compression", "int8-row-ef", "--flat-planes"],
])
def test_cli_trains_one_process_per_node(extra):
    res = train.main(CLI + ["--steps", "3"] + extra)
    assert res["processes"] and res["n_nodes"] == N and res["backend"] == "gloo"
    assert res["devices"] == ["cpu"] * N
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))


def test_cli_matches_the_stacked_cli():
    """The same flags on --nodes 4 (stacked) give the same losses."""
    a = train.main(CLI + ["--steps", "3"])
    b = train.main([x for x in CLI[2:] if x not in ("--timeout", str(TIMEOUT_S))]
                   + ["--nodes", str(N), "--steps", "3"])
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)


DELAYED = CLI + ["--algorithm", "decentlam-sa", "--gossip-delay", "1", "--flat-planes"]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """4 steps unbroken (checkpoints at 2 and 4) and 2 steps resumed from the
    step-2 checkpoint in another directory."""
    root = tmp_path_factory.mktemp("dist_ckpt")
    a, b = str(root / "a"), str(root / "b")
    ra = train.main(DELAYED + ["--steps", "4", "--ckpt-dir", a, "--ckpt-every", "2"])
    shutil.copytree(os.path.join(a, "step_00000002"), os.path.join(b, "step_00000002"))
    rb = train.main(DELAYED + ["--steps", "4", "--ckpt-dir", b, "--resume"])
    return ra, rb, a, b


def _npz(path):
    with np.load(os.path.join(path, "state.npz")) as z:
        return {k: z[k] for k in z.files}


def test_cli_resume_equals_unbroken_run(resumed):
    ra, rb, a, b = resumed
    assert rb["start_step"] == 2 and rb["losses"] == ra["losses"][2:]
    za, zb = _npz(os.path.join(a, "step_00000004")), _npz(os.path.join(b, "step_00000004"))
    assert sorted(za) == sorted(zb)
    assert any(k.startswith("channel/delay/") for k in za)
    for k in za:
        assert za[k].tobytes() == zb[k].tobytes(), k
    assert rb["restore_s"] > 0 and len(ra["save_s"]) == 2


def test_distributed_checkpoint_is_repros_trainer_layout(resumed):
    """``repro``'s restore_checkpoint reads it; its channel leaves have the
    names, shapes and dtypes of ``repro``'s DelayedPpermuteChannel state
    stacked over the nodes (the per-node telemetry and ring count)."""
    from repro.configs import get_config
    from repro.core.gossip import DelayedPpermuteChannel
    from repro.core.topology import build_topology
    from repro.models import transformer as T
    from repro.train.train_state import model_plane_layout

    _, _, a, _ = resumed
    state, manifest = jckpt.restore_checkpoint(a)
    assert manifest["n_nodes"] == N and int(state["step"]) == 4
    cfg = get_config("qwen3-0.6b", smoke=True)
    layout = model_plane_layout(cfg)
    ch = DelayedPpermuteChannel(build_topology("exp", N), ("data",), 1, telemetry=True)
    abstract = jax.eval_shape(
        lambda k: ch.init(layout.pack_global(T.init_params(k, cfg, 1), dtype=jnp.float32)),
        jax.random.key(0))
    want = {"/".join(str(p.key) for p in path): ((N,) + leaf.shape, np.dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = {"/".join(str(p.key) for p in path): (leaf.shape, leaf.dtype)
           for path, leaf in jax.tree_util.tree_flatten_with_path(state["channel"])[0]}
    assert got == want


STACKED = [x for x in DELAYED if x not in ("--simulate-nodes", "--timeout", str(N),
                                           str(TIMEOUT_S))] + ["--nodes", str(N)]


@pytest.mark.parametrize("first,then", [(STACKED, DELAYED), (DELAYED, STACKED)],
                         ids=["stacked-to-distributed", "distributed-to-stacked"])
def test_cli_resumes_across_the_two_trainers(first, then, tmp_path):
    """A checkpoint of either trainer resumes in the other: parameters and
    optimizer state carry over, the delay ring (laid out otherwise) starts
    afresh, and training goes on."""
    a = train.main(first + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    b = train.main(then + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--resume"])
    assert b["start_step"] == 2 and len(b["losses"]) == 2 and all(np.isfinite(b["losses"]))
    # the ring restarts, so step 2 mixes fresh payloads: gap 0, then 1
    assert b["gossip_gaps"] == [0, 1] and a["gossip_gaps"] == [0, 1]


def test_cli_failure_drill_shrinks_to_half_and_trains_on(tmp_path):
    res = train.main(DELAYED + ["--steps", "4", "--failure-drill", "--ckpt-dir",
                                str(tmp_path)], on_shrink=W.check_shrink)
    assert res["drill"] == {"step": 2, "from": N, "to": N // 2}
    assert res["n_nodes"] == N // 2 and len(res["losses"]) == 4
    assert all(np.isfinite(res["losses"]))
    n_tensors, differ, fresh = res["on_shrink"]
    assert n_tensors > 0 and differ == [] and fresh
    state, manifest = jckpt.restore_checkpoint(str(tmp_path))
    assert manifest["n_nodes"] == N // 2 and int(state["step"]) == 4


def test_cli_never_falls_back_to_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--simulate-nodes", str(N), "--arch", "qwen3-0.6b", "--smoke",
                    "--steps", "1"])


def test_cli_rejects_what_is_not_ported():
    # serving while training, tp > 1 for every family and the drill at tp > 1
    # run now (tests/test_torch_tp_cli.py, tests/test_torch_tp_zoo_*.py,
    # tests/test_torch_tp_drill.py); the stacked trainer stays at tp = 1, the
    # drill with it
    stacked = [x for x in CLI if x not in ("--simulate-nodes", str(N), "--timeout",
                                           str(TIMEOUT_S))]
    with pytest.raises(NotImplementedError, match="--simulate-nodes"):
        train.main(stacked + ["--nodes", str(N), "--steps", "1", "--tp", "2",
                              "--failure-drill"])


# --- launch/elastic.py against repro.launch.elastic --------------------------

TOPOS = ["ring", "exp", "one-peer-exp", "torus", "full"]
DEAD = [(), (0,), (3,), (0, 1), (1, 5), (0, 2, 4, 6)]


@pytest.mark.parametrize("family", TOPOS)
def test_survivors_connected_matches_repro(family):
    from repro.core.topology import build_topology as jbuild

    for dead in DEAD:
        assert (telastic.survivors_connected(ttopo.build_topology(family, 8), dead)
                == jelastic.survivors_connected(jbuild(family, 8), dead)), (family, dead)


@pytest.mark.parametrize("family", TOPOS)
@pytest.mark.parametrize("n", [6, 8])
def test_plan_recovery_matches_repro(family, n):
    for dead in DEAD:
        for allow in (True, False):
            try:
                want = jelastic.plan_recovery(family, n, dead, allow_reroute=allow)
            except (AssertionError, ValueError) as e:
                with pytest.raises(type(e)):
                    telastic.plan_recovery(family, n, dead, allow_reroute=allow)
                continue
            got = telastic.plan_recovery(family, n, dead, allow_reroute=allow)
            assert (got.mode, got.n_nodes, got.dead) == (want.mode, want.n_nodes, want.dead)
            for t in range(max(got.topology.period, want.topology.period)):
                np.testing.assert_array_equal(got.topology.W(t), want.topology.W(t))


@pytest.mark.parametrize("mode", ["reroute", "rescale"])
def test_apply_recovery_matches_repro(mode):
    import torch

    from repro_torch.interop import from_numpy

    rng = np.random.default_rng(3)
    state = {"step": 5,
             "params": {"w": rng.standard_normal((8, 4, 3)).astype(np.float32)},
             "opt": {"m": {"w": rng.standard_normal((8, 4, 3)).astype(np.float32)}},
             "channel": {}}
    dead = (2,) if mode == "reroute" else (0, 1, 2, 3)
    jplan = jelastic.plan_recovery("ring", 8, dead)
    tplan = telastic.plan_recovery("ring", 8, dead)
    assert jplan.mode == tplan.mode == mode
    want = jelastic.apply_recovery(jax.tree.map(jnp.asarray, {k: v for k, v in state.items()
                                                              if k != "step"}), jplan)
    got = telastic.apply_recovery({k: from_numpy(v) if k != "step" else v
                                   for k, v in state.items()}, tplan)
    for part in ("params", "opt"):
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want[part])[0],
                                jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got[part],
                                                             is_leaf=torch.is_tensor))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-7, atol=1e-7,
                                       err_msg=str(path))
