"""The port's checkpoints against the JAX package's: the V3 format written
by either package and restored by the other, bit for bit; atomic overwrite;
elastic reshape; the channel and plane reconciliation on resume; and a
resumed CLI run equal to an unbroken one, per leaf and on planes, with a
delay ring and an error-feedback residual in the state."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.planes import PlaneLayout as JPlaneLayout
from repro.train import checkpoint as jckpt
from repro.train import train_state as jts
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import tiny_lm
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopo
from repro_torch.core.optimizers import OptimizerConfig, make_optimizer
from repro_torch.core.planes import PlaneLayout
from repro_torch.interop import to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_state as tts
from repro_torch.utils import tree_leaves, tree_map, tree_paths

N = 4
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
# non-native numpy dtypes: (torch dtype, ml_dtypes type, integer view)
ODD = {"bfloat16": (torch.bfloat16, ml_dtypes.bfloat16, np.uint16),
       "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, np.uint8),
       "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2, np.uint8)}


def _bits(shape, itype, seed):
    info = np.iinfo(itype)
    return np.random.default_rng(seed).integers(0, info.max, size=shape,
                                                dtype=itype, endpoint=True)


def _state_numpy():
    """A train-state tree as the reference holds it (numpy leaves): stacked
    f32 and bf16 parameters, optimizer buckets in f32, bf16 and both fp8
    types (plane-dict style), telemetry and a ring slot."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": {"table": f32(N, 11, 8)}, "lm_head": {"w": f32(N, 8, 11)},
              "norm": {"scale": _bits((N, 8), np.uint16, 1).view(ml_dtypes.bfloat16)}}
    opt = {"m": {name: _bits((N, 3, 16), itype, i).view(mld)
                 for i, (name, (_, mld, itype)) in enumerate(ODD.items())}}
    opt["m"]["float32"] = f32(N, 3, 16)
    channel = {"t": {"bytes": np.float32(1234.5), "rounds": np.int32(7)},
               "delay": {"s0": {"hist": {"float32": f32(2, N, 3, 16)},
                                "count": np.int32(5)}}}
    return {"step": np.int32(7), "params": params, "opt": opt, "channel": channel}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name in ODD:
        dt, _, itype = ODD[a.dtype.name]
        return torch.from_numpy(a.view(itype).copy()).view(dt)
    return torch.from_numpy(a.copy())


def _port_state(ref):
    return {**tree_map(_to_torch, {k: v for k, v in ref.items() if k != "step"}),
            "step": int(ref["step"])}


def _same_bits(got, want, what):
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, what
        if want.dtype.name in ODD:
            got = got.view(torch.uint16 if got.element_size() == 2 else torch.uint8).numpy()
        else:
            got = got.numpy()
    got = np.asarray(got)
    assert got.dtype.itemsize == want.dtype.itemsize and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _walk_pairs(got, want, prefix=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (prefix, sorted(got), sorted(want))
        for k in want:
            yield from _walk_pairs(got[k], want[k], f"{prefix}/{k}")
    else:
        yield prefix, got, want


def test_port_writes_reference_restores_bitwise(tmp_path):
    ref = _state_numpy()
    tckpt.save_checkpoint(str(tmp_path), _port_state(ref), metadata={"algorithm": "x"})
    got, manifest = jckpt.restore_checkpoint(str(tmp_path))
    for path, g, w in _walk_pairs(jax.device_get(got), ref):
        _same_bits(np.asarray(g), w, path)
    assert manifest["format"] == 3 and manifest["step"] == 7 and manifest["n_nodes"] == N
    assert manifest["algorithm"] == "x"


def test_reference_writes_port_restores_bitwise(tmp_path):
    ref = _state_numpy()
    jckpt.save_checkpoint(str(tmp_path), jax.tree.map(jnp.asarray, ref))
    got, manifest = tckpt.restore_checkpoint(str(tmp_path))
    assert got["step"] == 7 and isinstance(got["step"], int)
    for path, g, w in _walk_pairs({k: v for k, v in got.items() if k != "step"},
                                  {k: v for k, v in ref.items() if k != "step"}):
        _same_bits(g, w, path)


def test_both_packages_write_the_same_manifest_and_arrays(tmp_path):
    """Same keys, dtypes and plane fields; the same bytes in every array."""
    ref = _state_numpy()
    jl = JPlaneLayout.build({"w": jnp.zeros((5, 2000)), "b": jnp.zeros((3,))})
    tl = PlaneLayout.build({"w": torch.zeros(5, 2000), "b": torch.zeros(3)})
    jckpt.save_checkpoint(str(tmp_path / "j"), jax.tree.map(jnp.asarray, ref),
                          metadata={"n_nodes": N}, plane_layout=jl)
    tckpt.save_checkpoint(str(tmp_path / "t"), _port_state(ref), metadata={"n_nodes": N},
                          plane_layout=tl)
    mans, arrays = [], []
    for d in ("j", "t"):
        step_dir = tmp_path / d / "step_00000007"
        mans.append(json.loads((step_dir / "manifest.json").read_text()))
        with np.load(step_dir / "state.npz") as z:
            arrays.append({k: z[k] for k in z.files})
    assert mans[0] == mans[1]
    assert sorted(arrays[0]) == sorted(arrays[1]) == mans[0]["keys"]
    for k in arrays[0]:
        a, b = arrays[0][k], arrays[1][k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_no_ml_dtypes_needed_to_write_or_read(tmp_path):
    """bfloat16 and fp8 go through their bits: the port's checkpoint module
    round-trips them with ``ml_dtypes`` unimportable."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.train import checkpoint as c\n"
        "s = {'step': 3, 'params': {'a': torch.arange(8, dtype=torch.float32)\n"
        "     .to(torch.bfloat16)}, 'opt': {'m': {'e4': torch.ones(4).to(torch.float8_e4m3fn),\n"
        "     'e5': torch.full((4,), -2.0).to(torch.float8_e5m2)}}}\n"
        f"c.save_checkpoint({str(tmp_path)!r}, s)\n"
        f"r, m = c.restore_checkpoint({str(tmp_path)!r})\n"
        "assert r['params']['a'].dtype == torch.bfloat16 and torch.equal(r['params']['a'],"
        " s['params']['a'])\n"
        "for k in ('e4', 'e5'):\n"
        "    assert torch.equal(r['opt']['m'][k].view(torch.uint8), s['opt']['m'][k]"
        ".view(torch.uint8))\n"
        "assert m['dtypes']['opt/m/e5'] == 'float8_e5m2'\n"
        "assert 'ml_dtypes' not in [n for n, v in sys.modules.items() if v is not None]\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_unknown_dtype_and_missing_checkpoint_raise(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), {"step": 1, "params": {"a": torch.zeros(2)}})
    man = tmp_path / "step_00000001" / "manifest.json"
    m = json.loads(man.read_text())
    m["dtypes"]["params/a"] = "float4_e2m1"
    man.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="unknown dtype"):
        tckpt.restore_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"))


def test_v2_manifest_restores_bf16_and_renames_comp(tmp_path):
    """A V2 checkpoint (no dtypes; bf16 as a 2-byte void; compression state
    under "comp") restores as the reference restores it."""
    d = tmp_path / "step_00000002"
    d.mkdir()
    bits = _bits((N, 5), np.uint16, 3)
    np.savez(d / "state.npz", **{"step": np.int32(2), "params/w": bits.view("V2"),
                                 "comp/w": np.ones((N, 5), np.float32)})
    (d / "manifest.json").write_text(json.dumps({"step": 2, "keys": ["comp/w", "params/w",
                                                                      "step"]}))
    got, _ = tckpt.restore_checkpoint(str(tmp_path))
    want, _ = jckpt.restore_checkpoint(str(tmp_path))
    _same_bits(got["params"]["w"], np.asarray(want["params"]["w"]), "params/w")
    assert sorted(got["channel"]) == ["comp"] and "comp" not in got
    _same_bits(got["channel"]["comp"]["w"], np.asarray(want["channel"]["comp"]["w"]), "comp")


def test_atomic_overwrite(tmp_path, monkeypatch):
    s = {"step": 4, "params": {"a": torch.zeros(N, 3)}}
    tckpt.save_checkpoint(str(tmp_path), s)
    s["params"]["a"] = torch.ones(N, 3)
    tckpt.save_checkpoint(str(tmp_path), s)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]
    got, _ = tckpt.restore_checkpoint(str(tmp_path))
    assert torch.equal(got["params"]["a"], torch.ones(N, 3))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", boom)
    s["params"]["a"] = torch.full((N, 3), 2.0)
    with pytest.raises(OSError):
        tckpt.save_checkpoint(str(tmp_path), s)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]  # no tmp dir left
    assert tckpt.latest_step(str(tmp_path)) == 4 and tckpt.latest_step(str(tmp_path / "x")) is None
    got, _ = tckpt.restore_checkpoint(str(tmp_path))
    assert torch.equal(got["params"]["a"], torch.ones(N, 3))


@pytest.mark.parametrize("new_n", [2, 6])
def test_elastic_reshape_matches_reference(new_n):
    ref = _state_numpy()
    ref["opt"]["m"] = {"float32": ref["opt"]["m"]["float32"]}
    ref["params"].pop("norm")
    # the reference's trainer channel state: per-node leaves, node axis first
    ref["channel"] = {"comp": {"float32": np.ones((N, 3, 16), np.float32)}}
    got = tckpt.elastic_reshape(_port_state(ref), new_n)
    want = jax.device_get(jckpt.elastic_reshape(jax.tree.map(jnp.asarray, ref), new_n))
    for bucket in ("params", "opt"):
        for path, g, w in _walk_pairs(to_numpy(got[bucket]), want[bucket]):
            assert g.shape == w.shape == (new_n,) + w.shape[1:], path
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=path)
    # the channel state re-initializes to zeros (the reference's reset)
    assert got["channel"] == {}
    ch = tgossip.DelayedStackedChannel(ttopo.build_topology("ring", new_n), 1, telemetry=True)
    merged = tts.ensure_channel_state(got, ch)["channel"]
    assert all(not v.any() for v in tree_leaves(merged))
    assert sorted(tree_paths(merged)) == sorted(
        tree_paths(ch.init(got["params"])))


def test_ensure_channel_state_keeps_matching_and_reinits_the_rest():
    """A same-shape channel state resumes untouched; a ring slot of another
    shape (the reference trainer's (n, ring, ...) per-node layout, its count
    per node) re-initializes whole; the reference trainer's per-node
    telemetry keeps its value."""
    params = {"w": torch.randn(N, 5, 3)}
    ch = tgossip.DelayedStackedChannel(ttopo.build_topology("exp", N), 1,
                                       compression="int8-row-ef", telemetry=True)
    st = ch.init(params)
    st["comp"]["w"].fill_(0.5)
    st["delay"]["s0"]["hist"]["w"].fill_(2.0)
    st["delay"]["s0"]["count"] = torch.tensor(3, dtype=torch.int32)
    kept = tts.ensure_channel_state({"params": params, "channel": st}, ch)["channel"]
    assert kept["comp"]["w"] is st["comp"]["w"] and kept["delay"]["s0"] is st["delay"]["s0"]

    foreign = {"t": {"bytes": torch.full((N,), 96.0), "rounds": torch.full((N,), 3,
                                                                            dtype=torch.int32)},
               "comp": {"w": torch.full((N, 5, 3), 0.25)},
               "delay": {"s0": {"hist": {"w": torch.ones(N, 2, 5, 3)},
                                "count": torch.full((N,), 3, dtype=torch.int32)}}}
    got = tts.ensure_channel_state({"params": params, "channel": foreign}, ch)["channel"]
    assert float(got["t"]["bytes"]) == 96.0 and int(got["t"]["rounds"]) == 3
    assert got["t"]["bytes"].shape == () and got["t"]["rounds"].dtype == torch.int32
    assert torch.equal(got["comp"]["w"], foreign["comp"]["w"])
    slot = got["delay"]["s0"]
    assert slot["hist"]["w"].shape == (2, N, 5, 3) and not slot["hist"]["w"].any()
    assert int(slot["count"]) == 0
    # no channel: an empty bucket
    assert tts.ensure_channel_state({"params": params, "channel": st}, None)["channel"] == {}


def test_reconcile_plane_state_across_flat_planes_matches_reference():
    """Tree <-> plane conversion of every optimizer bucket, against the
    reference's reconcile at tp = 1; the port's plane form also rebuilds the
    parameter planes with the parameters as views."""
    cfg = tiny_lm(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97)
    layout = tts.model_plane_layout(cfg)
    opt = make_optimizer(OptimizerConfig(algorithm="d2-dmsgd", momentum=0.9))
    state = tts.init_train_state(cfg, opt, N, device=torch.device("cpu"), seed=3)
    gen = torch.Generator().manual_seed(1)
    for v in state["opt"].values():
        for leaf in tree_leaves(v):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    planes = tts.reconcile_plane_state(state, layout, True)
    back = tts.reconcile_plane_state(planes, layout, False)
    jlayout = JPlaneLayout.build(jax.tree.map(lambda x: jnp.zeros(x.shape[1:], x.dtype),
                                              to_numpy(state["params"])))
    jstate = {"opt": jax.tree.map(jnp.asarray, to_numpy(state["opt"]))}
    jplanes = jax.device_get(jts.reconcile_plane_state(jstate, jlayout, True)["opt"])
    for k in state["opt"]:
        for path, g, w in _walk_pairs(to_numpy(planes["opt"][k]), jplanes[k]):
            _same_bits(g, w, f"{k}{path}")
        for a, b in zip(tree_leaves(back["opt"][k]), tree_leaves(state["opt"][k])):
            assert torch.equal(a, b)
    pl = planes["planes"]["float32"]
    for a, b in zip(tree_leaves(planes["params"]), tree_leaves(state["params"])):
        assert torch.equal(a, b) and pl.data_ptr() <= a.data_ptr() < pl.data_ptr() + pl.nbytes
    for a, b in zip(tree_leaves(back["params"]), tree_leaves(state["params"])):
        assert torch.equal(a, b) and not (pl.data_ptr() <= a.data_ptr()
                                          < pl.data_ptr() + pl.nbytes)
    assert "planes" not in back


def test_check_plane_manifest_rejects_a_changed_model(tmp_path):
    cfg = tget_config("qwen3-0.6b", smoke=True)
    layout = tts.model_plane_layout(cfg)
    tckpt.save_checkpoint(str(tmp_path), {"step": 1, "params": {"a": torch.zeros(2)}},
                          plane_layout=layout)
    _, manifest = tckpt.restore_checkpoint(str(tmp_path))
    tckpt.check_plane_manifest(manifest, layout)
    other = tts.model_plane_layout(tiny_lm(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                           d_ff=128, vocab_size=97))
    with pytest.raises(ValueError, match="plane_rows"):
        tckpt.check_plane_manifest(manifest, other)
    with pytest.raises(ValueError, match="model axis"):
        tckpt.check_plane_manifest({**manifest, "plane_model_axis": "tp"}, layout)
    tckpt.check_plane_manifest({"step": 1}, other)  # no plane fields: passes
    # the reference reads the port's plane fields the same way
    jlayout = JPlaneLayout.build({"w": jnp.zeros((5,))})
    with pytest.raises(ValueError, match="plane_rows"):
        jckpt.check_plane_manifest(manifest, jlayout)


CLI = ["--nodes", str(N), "--arch", "qwen3-0.6b", "--smoke", "--seq-len", "16",
       "--per-node-batch", "2",
       "--fused-update", "--device", "cpu", "--algorithm", "decentlam-sa", "--gossip-delay", "1",
       "--compression", "int8-row-ef", "--log-every", "100", "--steps", "4"]


@pytest.mark.parametrize("planes", [False, True], ids=["per-leaf", "planes"])
def test_resumed_cli_run_equals_unbroken_bitwise(tmp_path, planes):
    """4 steps unbroken (saving at step 2 and 4) against 2 steps, a fresh
    state restored from the step-2 checkpoint with ``--resume``, and 2 more:
    the same losses and the same final checkpoint, byte for byte — params,
    optimizer state, the delay ring, the error-feedback residual and the
    telemetry."""
    extra = ["--flat-planes"] if planes else []
    a, b = tmp_path / "unbroken", tmp_path / "resumed"
    straight = tlaunch.main(CLI + extra + ["--ckpt-dir", str(a), "--ckpt-every", "2"])
    b.mkdir()
    shutil.copytree(a / "step_00000002", b / "step_00000002")
    resumed = tlaunch.main(CLI + extra + ["--ckpt-dir", str(b), "--resume"])
    assert resumed["start_step"] == 2 and resumed["losses"] == straight["losses"][2:]
    assert resumed["gossip_gaps"] == straight["gossip_gaps"][2:] == [1.0, 1.0]
    arrays = []
    for d in (a, b):
        with np.load(d / "step_00000004" / "state.npz") as z:
            arrays.append({k: z[k] for k in z.files})
    keys = sorted(arrays[0])
    assert keys == sorted(arrays[1])
    assert any(k.startswith("channel/delay/s0/hist") for k in keys)
    assert any(k.startswith("channel/comp") for k in keys)
    assert ("channel/comp/float32" in keys) == planes
    for k in keys:
        assert arrays[0][k].tobytes() == arrays[1][k].tobytes(), k


def test_resume_with_another_node_count_reshapes(tmp_path, capsys):
    """--resume with another --nodes: the replicas and momentum collapse to
    their mean and re-broadcast (the reference's elastic reshape), the
    channel state starts afresh, and training goes on."""
    four = CLI + ["--flat-planes", "--ckpt-dir", str(tmp_path)]
    tlaunch.main(four)
    state, _ = tckpt.restore_checkpoint(str(tmp_path))
    want = tckpt.elastic_reshape(state, 2)
    capsys.readouterr()
    two = list(four)
    two[two.index("--nodes") + 1], two[two.index("--steps") + 1] = "2", "6"
    res = tlaunch.main(two + ["--resume"])
    assert "elastic reshape 4 -> 2" in capsys.readouterr().out
    assert res["start_step"] == 4 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    got, _ = tckpt.restore_checkpoint(str(tmp_path))
    assert got["step"] == 6 and tree_leaves(got["params"])[0].shape[0] == 2
    assert tree_leaves(want["params"])[0].shape[0] == 2
