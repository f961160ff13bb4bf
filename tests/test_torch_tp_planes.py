"""The port's tensor-parallel layouts against the JAX package's, in one
process:

* ``param_shard_axes`` names the axes ``repro``'s ``param_specs`` shard over
  the model axis (train and serve layouts, padded and windowed configs),
  and ``model_plane_layout(cfg, tp)`` is ``repro``'s at tp 1, 2 and 4:
  local rows, segments, shapes and shard axes;
* sharded planes: ``pack_global`` equals ``repro``'s element for element,
  ``unpack_global`` inverts it bit for bit, rank block ``r`` is the pack of
  ``shard_slice(tree, r)``; the plane tail makes one stage call per bucket
  and stage on every rank's local planes, as at tp 1;
* a plane-form optimizer state written at tp 2 restores at tp 1 and back
  (``global_tree_state``, the manifest's ``plane_tp``), as ``repro``'s
  ``reconcile_plane_state`` converts it; padding that differs raises;
* the cache's global shapes (``abstract_cache``); ``--preset 100m`` is
  ``repro``'s ``lm-100m``.  (The other families' layouts are
  ``test_torch_tp_zoo_layouts.py``'s.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import tiny_lm as jtiny_lm
from repro.core import planes as jplanes
from repro.models import transformer as JT
from repro.train import train_state as jts
from repro_torch.configs import get_config, tiny_lm
from repro_torch.configs.base import reference_fields
from repro_torch.core import optimizers as topt
from repro_torch.core import update_spec as tspec
from repro_torch.core.planes import LANES, ROW_MULTIPLE, PlaneLayout, plane_scalars
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.kernels.fused_update import make_plane_stage
from repro_torch.kernels.fused_update.kernel import stage_plain
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import serve as tserve
from repro_torch.train import train_state as tts
from repro_torch.utils import tree_leaves, tree_map

RNG = np.random.default_rng(0)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
# configs whose shard axes are held: divisible, padded heads and vocab with
# replicated kv (3 heads, 1 kv head), windowed with qk-norm, qwen3's and
# olmo's (parameter-free norms) smoke configs
AXES_CFGS = {
    "tiny": lambda m: m.tiny_lm(**TINY),
    "padded": lambda m: m.tiny_lm(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=64,
                                  vocab_size=13, qk_norm=True),
    "window": lambda m: m.tiny_lm(**TINY, sliding_window=8, qk_norm=True,
                                  tie_embeddings=True),
    "qwen3-smoke": lambda m: m.get_config("qwen3-0.6b", smoke=True),
    "olmo-smoke": lambda m: m.get_config("olmo-1b", smoke=True),
}


class _Mod:
    def __init__(self, tiny, get):
        self.tiny_lm, self.get_config = tiny, get


JAX_MOD, PORT_MOD = _Mod(jtiny_lm, jget_config), _Mod(tiny_lm, get_config)


def _spec_axis(spec):
    if spec is None:
        return None
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return dim
    return None


@pytest.mark.parametrize("name", sorted(AXES_CFGS))
@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_axes_are_repros_param_specs(name, serve, tp):
    jcfg, tcfg = AXES_CFGS[name](JAX_MOD), AXES_CFGS[name](PORT_MOD)
    specs = jax.tree.leaves(JT.param_specs(jcfg, tp, serve=serve),
                            is_leaf=lambda s: isinstance(s, P) or s is None)
    want = [_spec_axis(s) for s in specs]
    assert tree_leaves(T.param_shard_axes(tcfg, tp, serve=serve)) == want


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_model_plane_layout_is_repros(tp):
    jl = jts.model_plane_layout(jtiny_lm(**TINY), tp)
    tl = tts.model_plane_layout(tiny_lm(**TINY), tp)
    assert tl.tp == tp and tl.sharded == (tp > 1)
    assert dict(tl.rows) == dict(jl.rows)
    assert all(v % ROW_MULTIPLE == 0 for v in tl.rows.values())
    for key in jl.segments:
        got = [(s.index, s.shape, s.full_shape, s.shard_axis, s.row_start, s.rows, s.size)
               for s in tl.segments[key]]
        want = [(s.index, tuple(s.shape), tuple(s.full_shape), s.shard_axis, s.row_start,
                 s.rows, s.size) for s in jl.segments[key]]
        assert got == want, key
    assert [tuple(t.shape) for t in tree_leaves(tl.global_template())] == [
        tuple(t.shape) for t in jax.tree.leaves(jl.global_template())]
    assert [tuple(t.shape) for t in tree_leaves(tl.local_template())] == [
        tuple(t.shape) for t in jax.tree.leaves(jl.local_template())]


def _case(seed: int, tp: int):
    """A random global tree (mixed f32/bf16) and its shard axes, the specs
    for repro."""
    rng = np.random.default_rng(seed)
    shapes = {"win": ((8, 16 * tp), 1), "wout": ((8 * tp, 24), 0),
              "emb": ((12 * tp, 33), 0), "w2": ((1500,), None), "ln": ((9,), None),
              "b": ((), None)}
    dtypes = {"emb": jnp.bfloat16, "w2": jnp.bfloat16}
    tree = {k: np.asarray(rng.standard_normal(s), dtypes.get(k, np.float32))
            for k, (s, _) in shapes.items()}
    axes = {k: a for k, (_, a) in shapes.items()}
    specs = {k: P(*[("model" if d == a else None) for d in range(len(s))])
             for k, (s, a) in shapes.items()}
    return tree, axes, specs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_pack_global_roundtrip_matches_repro(seed, tp):
    tree, axes, specs = _case(seed, tp)
    jl = jplanes.PlaneLayout.build(tree, tp=tp, shardings=specs if tp > 1 else None)
    tl = PlaneLayout.build(from_numpy(tree, "cpu"), tp=tp, shardings=axes if tp > 1 else None)
    ttree = from_numpy(tree)
    planes = tl.pack_global(ttree)
    want = jax.device_get(jl.pack_global(tree))
    for key, buf in planes.items():
        assert buf.shape == (tp * tl.rows[key], LANES)
        np.testing.assert_array_equal(to_numpy({"p": buf})["p"].astype(np.float32),
                                      np.asarray(want[key]).astype(np.float32))
    back = tl.unpack_global(planes, like=ttree)
    assert all(torch.equal(a.view(-1).view(torch.uint8) if a.dim() else a.reshape(1),
                           b.view(-1).view(torch.uint8) if b.dim() else b.reshape(1))
               for a, b in zip(tree_leaves(back), tree_leaves(ttree)))
    for r in range(tp):
        local = tl.pack(tl.shard_slice(ttree, r))
        for key, buf in local.items():
            assert torch.equal(buf, planes[key][r * tl.rows[key]:(r + 1) * tl.rows[key]])
    # stacked (node-axis) form, f32 cast, as the optimizer state packs
    stacked = tree_map(lambda x: torch.stack([x, 2 * x]), ttree)
    sp = tl.pack_global(stacked, dtype=torch.float32, leading=1)
    back = tl.unpack_global(sp, dtype=torch.float32, leading=1)
    assert all(torch.equal(a, b.to(torch.float32))
               for a, b in zip(tree_leaves(back), tree_leaves(stacked)))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_plane_tail_stage_calls_match_tp1_collapse(tp):
    """Per-rank stage calls on a sharded local layout = the tp 1 collapse:
    one per bucket and stage (the stage kernel's plain version counts its
    calls on the CPU)."""
    tree, axes, _ = _case(5, 4)
    lay = PlaneLayout.build(from_numpy(tree), tp=tp, shardings=axes if tp > 1 else None)
    local = tree_map(lambda t: torch.randn(t.shape).to(t.dtype), lay.local_template())
    ocfg = topt.OptimizerConfig(algorithm="decentlam", momentum=0.9)
    spec = tspec.update_spec(ocfg)
    g = tree_map(lambda t: torch.randn(t.shape), local)
    state = {k: lay.pack(v, dtype=torch.float32)
             for k, v in topt.make_optimizer(ocfg).init(local).items()}
    before = stage_plain.calls
    tspec.run_update(spec, ocfg, x=lay.pack(local), g=lay.pack(g, dtype=torch.float32),
                     state=state, lr=torch.tensor(0.01), step_idx=0,
                     gossip=lambda t, s, c: (t, c), mean=lambda t: t, comp_state=(),
                     stage=make_plane_stage("triton"),  # its plain version here
                     scalars=plane_scalars(ocfg, lay, local, g))
    assert stage_plain.calls - before == len(lay.buckets) * len(tspec.stage_plan(ocfg))


def test_cross_tp_restore_matches_repro(tmp_path):
    """An optimizer plane state written at tp 2 restores at tp 1 and back
    (through the global tree), as repro's reconcile_plane_state converts
    it; the manifest records plane_tp and the local plane_rows."""
    jcfg, cfg = jtiny_lm(**TINY), tiny_lm(**TINY)
    j1, j2 = jts.model_plane_layout(jcfg, 1), jts.model_plane_layout(jcfg, 2)
    l1, l2 = tts.model_plane_layout(cfg, 1), tts.model_plane_layout(cfg, 2)
    n = 3
    m = jax.tree.map(lambda a: np.asarray(RNG.standard_normal((n,) + a.shape), np.float32),
                     j1.global_template())
    packed2 = jax.device_get(j2.pack_global(m, dtype=jnp.float32, leading=1))
    packed1 = jax.device_get(j1.pack_global(m, dtype=jnp.float32, leading=1))
    params = jax.tree.map(lambda a: np.zeros((n,) + a.shape, np.float32), j1.global_template())
    host = {"step": 5, "params": from_numpy(params), "opt": {"m": from_numpy(packed2)}}
    # tp 2 -> tp 1: the global tree, packed at tp 1, is repro's conversion
    out = tts.global_tree_state(host, l2, l1)
    got = tts.reconcile_plane_state(out, l1, True)["opt"]["m"]
    want = jax.device_get(jts.reconcile_plane_state(
        {"step": 5, "params": {}, "opt": {"m": packed2}}, j1, True, stored_layout=j2)["opt"]["m"])
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(packed1[k]))
    # tp 1 -> tp 2's global stacked form
    out = tts.global_tree_state({**host, "opt": {"m": from_numpy(packed1)}}, l1, l2)
    assert out["opt"]["m"] is not None
    repacked = l2.pack_global(out["opt"]["m"], dtype=torch.float32, leading=1)
    for k in repacked:
        np.testing.assert_array_equal(repacked[k].numpy(), np.asarray(packed2[k]))
    # the manifest carries the layout the checkpoint was written with
    tckpt.save_checkpoint(str(tmp_path), host, plane_layout=l2)
    _, manifest = tckpt.restore_checkpoint(str(tmp_path))
    assert manifest["plane_tp"] == 2
    assert manifest["plane_rows"] == {k: int(v) for k, v in j2.rows.items()}
    # padding that differs between the two tp is refused
    pcfg = tiny_lm(**{**TINY, "vocab_size": 13})
    bad = {"step": 0, "params": from_numpy(jax.tree.map(
        lambda a: np.zeros((1,) + a.shape, np.float32),
        jts.model_plane_layout(jtiny_lm(**{**TINY, "vocab_size": 13}), 2).global_template())),
        "opt": {}}
    with pytest.raises(ValueError, match="padding"):
        tts.global_tree_state(bad, tts.model_plane_layout(pcfg, 2), tts.model_plane_layout(pcfg))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_abstract_cache_has_global_shapes(tp):
    cfg = tiny_lm(**TINY, sliding_window=12)
    rt = T.RuntimeConfig(dtype="float32")
    cache = tserve.abstract_cache(cfg, 8, 36, tp, tserve.ServeConfig(runtime=rt))
    k = cache["g0"]["kv"]["k"]
    assert k.device.type == "meta"
    assert tuple(k.shape) == (2, 8, -(-12 // tp) * tp, cfg.n_kv_heads, cfg.hd)


def test_preset_100m_is_repros():
    from repro_torch.launch.train import preset_config

    want = jtiny_lm("lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                    d_ff=3072, vocab_size=50304)
    got = preset_config("100m")
    assert reference_fields(got) == dataclasses.asdict(want)
    assert (got.n_layers, got.d_model, got.n_heads, got.n_kv_heads, got.d_ff,
            got.vocab_size) == (12, 768, 12, 4, 3072, 50304)
