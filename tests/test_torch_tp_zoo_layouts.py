"""The rest of the zoo's tensor-parallel layouts against the JAX package's,
in one process:

* ``param_shard_axes`` of every family's smoke and published config names
  the axes ``repro``'s ``param_specs`` shard over the model axis, at tp 2,
  4 and 16, in the train and the serve layout, and ``model_plane_layout``
  is ``repro``'s (MoE in expert and ffn mode, xLSTM, the SSM, the VLM, the
  encoder-decoder's encoder and cross-attention);
* a MoE optimizer plane written at tp 2 (expert-sharded) restores at tp 1
  and back, as ``repro``'s ``reconcile_plane_state`` converts it;
* the row tracker on sharded layouts: the port's counterpart of
  ``test_tracker_sharded_layout_slices_rank_block``, and a granite-moe
  layout's sources in both modes;
* ``check_tp`` takes every registry family of the reference at tp 2 but
  the encoder-decoder's serving, which raises naming the reference's fault;
* the dry run of every family on a small meta grid, its model-group
  all-reduces counted at ``TPContext._run`` (MoE, mLSTM and SSM included);
  whisper's serve cells are error records naming the fault and ``main``
  exits 1.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core.planes import PlaneLayout as JPlaneLayout
from repro.models import transformer as JT
from repro.sparse.tracker import RowTracker as JRowTracker
from repro.train import train_state as jts
from repro_torch.configs import ARCHS, ShapeSpec, get_config
from repro_torch.core.planes import LANES, PlaneLayout
from repro_torch.interop import from_numpy
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.sparse import RowTracker
from repro_torch.train import train_state as tts
from repro_torch.utils import tree_leaves

ZOO = ("granite-moe-1b-a400m", "granite-moe-3b-a800m", "xlstm-350m", "hymba-1.5b",
       "internvl2-2b", "whisper-tiny")
RNG = np.random.default_rng(0)


def _spec_axis(spec):
    if spec is None:
        return None
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return dim
    return None


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", ZOO)
def test_shard_axes_are_repros_param_specs(arch, smoke, tp, serve):
    jcfg, tcfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    specs = jax.tree.leaves(JT.param_specs(jcfg, tp, serve=serve),
                            is_leaf=lambda s: isinstance(s, P) or s is None)
    assert tree_leaves(T.param_shard_axes(tcfg, tp, serve=serve)) == [_spec_axis(s)
                                                                     for s in specs]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ZOO)
def test_model_plane_layout_is_repros(arch, tp):
    jl = jts.model_plane_layout(jget_config(arch, smoke=True), tp)
    tl = tts.model_plane_layout(get_config(arch, smoke=True), tp)
    assert dict(tl.rows) == dict(jl.rows)
    for key in jl.segments:
        got = [(s.index, s.shape, s.full_shape, s.shard_axis, s.row_start, s.rows)
               for s in tl.segments[key]]
        want = [(s.index, tuple(s.shape), tuple(s.full_shape), s.shard_axis, s.row_start,
                 s.rows) for s in jl.segments[key]]
        assert got == want, key


def test_cross_tp_restore_of_a_moe_plane():
    """granite-moe-1b's smoke config, expert-sharded at tp 2: a plane-form
    optimizer bucket written at tp 2 restores at tp 1 as repro's
    ``reconcile_plane_state`` converts it, and back."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    j1, j2 = jts.model_plane_layout(jcfg, 1), jts.model_plane_layout(jcfg, 2)
    l1, l2 = tts.model_plane_layout(cfg, 1), tts.model_plane_layout(cfg, 2)
    assert l2.shard_axes()["groups"]["g0"]["moe"]["w_in"] == 1  # by expert
    n = 2
    m = jax.tree.map(lambda a: np.asarray(RNG.standard_normal((n,) + a.shape), np.float32),
                     j1.global_template())
    packed2 = jax.device_get(j2.pack_global(m, dtype=jnp.float32, leading=1))
    packed1 = jax.device_get(j1.pack_global(m, dtype=jnp.float32, leading=1))
    params = jax.tree.map(lambda a: np.zeros((n,) + a.shape, np.float32), j1.global_template())
    host = {"step": 3, "params": from_numpy(params), "opt": {"m": from_numpy(packed2)}}
    got = tts.reconcile_plane_state(tts.global_tree_state(host, l2, l1), l1, True)["opt"]["m"]
    want = jax.device_get(jts.reconcile_plane_state(
        {"step": 3, "params": {}, "opt": {"m": packed2}}, j1, True, stored_layout=j2)["opt"]["m"])
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(packed1[k]))
    out = tts.global_tree_state({**host, "opt": {"m": from_numpy(packed1)}}, l1, l2)
    repacked = l2.pack_global(out["opt"]["m"], dtype=torch.float32, leading=1)
    for k in repacked:
        np.testing.assert_array_equal(repacked[k].numpy(), np.asarray(packed2[k]))


def test_tracker_sharded_layout_slices_rank_block():
    """On a sharded layout the touch inputs stay global (token ids over the
    full vocab, router hits over all experts) and ``step_masks(...,
    shard_rank=r)`` lights exactly rank r's local rows, as repro's tracker
    does; without ``shard_rank`` it refuses."""
    tp, vocab, d = 2, 64, 512
    lg, ne, dm, df = 1, 4, 96, 352
    tmpl = {"embed": {"table": np.zeros((vocab, d), np.float32)},
            "groups": {"g0": {"moe": {"w_in": np.zeros((lg, ne, dm, df), np.float32)}}},
            "final_norm": {"scale": np.zeros((d,), np.float32)}}
    specs = {"embed": {"table": P("model", None)},
             "groups": {"g0": {"moe": {"w_in": P(None, "model", None, None)}}},
             "final_norm": {"scale": None}}
    axes = {"embed": {"table": 0}, "groups": {"g0": {"moe": {"w_in": 1}}},
            "final_norm": {"scale": None}}
    layout = PlaneLayout.build(from_numpy(tmpl), tp=tp, shardings=axes)
    tracker = RowTracker.for_model(layout, tied_embeddings=False)
    jlayout = JPlaneLayout.build(jax.tree.map(jnp.asarray, tmpl), tp=tp, shardings=specs)
    jtracker = JRowTracker.for_model(jlayout, jax.tree.map(jnp.asarray, tmpl),
                                     tied_embeddings=False)
    emb = next(s for s in tracker.sources if s.name == "embed")
    moe = next(s for s in tracker.sources if s.kind == "moe")
    assert emb.unit_grid == (vocab,) and emb.shard_parts == tp and emb.units == vocab // tp
    assert moe.unit_grid == (lg, ne) and moe.shard_dim == 1 and moe.units == lg * ne // tp
    with pytest.raises(ValueError, match="shard_rank"):
        tracker.step_masks({"embed": torch.zeros(1, dtype=torch.int64)})
    hits = np.zeros((lg, ne), np.float32)
    hits[0, 2] = 1.0  # expert 2: rank 1's local unit 0
    for rank in range(tp):
        masks = tracker.step_masks({"embed": torch.tensor([3, 40]),
                                    "moe/g0": torch.from_numpy(hits)}, shard_rank=rank)
        want = jtracker.step_masks({"embed": jnp.asarray([3, 40], jnp.int32),
                                    "moe/g0": jnp.asarray(hits)}, shard_rank=jnp.int32(rank))
        for k in want:
            np.testing.assert_array_equal(masks[k].numpy(), np.asarray(want[k]), err_msg=k)
        got = masks[emb.bucket][emb.row_start:emb.row_start + emb.rows].numpy()
        expect = np.zeros(emb.rows, bool)
        for tok in (3, 40):
            lo = tok - rank * (vocab // tp)
            if 0 <= lo < vocab // tp:
                a, b = lo * emb.unit_size, (lo + 1) * emb.unit_size
                expect[a // LANES:(b - 1) // LANES + 1] = True
        np.testing.assert_array_equal(got, expect)
        got_moe = masks[moe.bucket][moe.row_start:moe.row_start + moe.rows].numpy()
        assert got_moe.any() == (rank == 1)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "granite-moe-3b-a800m"])
def test_tracker_sources_on_a_moe_tp_layout_match_repro(arch):
    """Expert mode splits the (layer, expert) unit grid; ffn mode shrinks
    the unit size and keeps the grid whole: each rank's masks are repro's."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jl, tl = jts.model_plane_layout(jcfg, 2), tts.model_plane_layout(cfg, 2)
    jtr = JRowTracker.for_model(jl, jl.local_template(), tied_embeddings=False)
    ttr = RowTracker.for_model(tl, tied_embeddings=False)
    assert [(s.name, s.rows, s.units, s.unit_size, tuple(s.unit_grid), s.shard_dim)
            for s in ttr.sources] == [(s.name, s.rows, s.units, s.unit_size,
                                       tuple(s.unit_grid), s.shard_dim) for s in jtr.sources]
    hits = (RNG.random((3, cfg.n_experts)) < 0.5).astype(np.float32)
    toks = RNG.integers(0, cfg.vocab_size, 7)
    for rank in range(2):
        got = ttr.step_masks({"embed": torch.from_numpy(toks), "moe/g0": torch.from_numpy(hits)},
                             shard_rank=rank)
        want = jtr.step_masks({"embed": jnp.asarray(toks), "moe/g0": jnp.asarray(hits)},
                              shard_rank=jnp.int32(rank))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# deepseek-v2-lite's latent attention trains at tp = 1 only and does not
# serve (tests/test_torch_deepseek.py holds check_tp's refusals)
@pytest.mark.parametrize("arch", sorted(set(ARCHS) - {"deepseek-v2-lite"}))
def test_check_tp_takes_every_family(arch):
    cfg = get_config(arch, smoke=True)
    T.check_tp(cfg, 2)
    T.check_tp(cfg, 1, serve=True)
    if cfg.arch_kind != "encdec":
        T.check_tp(cfg, 2, serve=True)


def test_whisper_serving_at_tp2_raises_naming_repros_fault():
    cfg = get_config("whisper-tiny", smoke=True)
    for call in (lambda: T.check_tp(cfg, 2, serve=True),
                 lambda: T.init_cache(cfg, 1, 8, T.RuntimeConfig(), device="meta", tp=2),
                 lambda: dryrun.run_cell(cfg, ShapeSpec("s", "prefill", 32, 4), (2, 2))):
        with pytest.raises(NotImplementedError,
                           match=r"src/repro/models/transformer.py:408-418"):
            call()


# model-group all-reduces of one forward on (2, 2): the embedding lookup's,
# then per layer attention's wo, the MLP's or MoE's combine, mLSTM's down,
# and the SSM's x_proj and out_proj (the cost model counts each at
# TPContext._run)
PREFILL_ALL_REDUCES = {"granite-moe-1b-a400m": 1 + 3 * 2, "granite-moe-3b-a800m": 1 + 3 * 2,
                       "xlstm-350m": 1 + 2 * 1, "hymba-1.5b": 1 + 4 * 4,
                       "internvl2-2b": 1 + 3 * 2}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_cells_on_a_small_grid(arch, kind):
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec("s", kind, 32, 4)
    if cfg.arch_kind == "encdec" and kind != "train":
        with pytest.raises(NotImplementedError, match="408-418"):
            dryrun.run_cell(cfg, shape, (2, 2))
        return
    rec = dryrun.run_cell(cfg, shape, (2, 2))
    assert rec["status"] == "ok" and rec["hlo_flops_per_device"] > 0
    counts = rec["collectives"]["counts"]
    if kind == "train":
        assert rec["raw"]["kernel_launches"] == {"fused_update": 2}
        assert counts["all-reduce"] > 0 and counts["collective-permute"] > 0
    if kind == "prefill":
        assert counts["all-reduce"] == PREFILL_ALL_REDUCES[arch]
        launches = rec["raw"]["kernel_launches"]
        if cfg.xlstm:
            assert launches == {"mlstm_chunk": cfg.n_layers - len(cfg.slstm_layers())}
        else:
            assert launches == {"flash_attention": cfg.n_layers}


def test_main_records_whisper_serve_cells_as_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper-tiny", "--shape", "prefill_32k,decode_32k",
                     "--mesh", "pod1", "--out", str(tmp_path)])
    assert e.value.code == 1
    for shape in ("prefill_32k", "decode_32k"):
        rec = json.loads((tmp_path / "baseline" / "pod1" /
                          f"whisper-tiny__{shape}.json").read_text())
        assert rec["status"] == "error"
        assert "NotImplementedError" in rec["error"] and "408-418" in rec["error"]
    assert "FAILED cells" in capsys.readouterr().out


def test_meta_slstm_counts_every_token_once():
    """On meta tensors the sLSTM loop is traced as one step under
    ``costmodel.trips``: its counted FLOPs and bytes stay within 15 % of the
    real loop's on the CPU (the backward recomputes the step, as the
    reference's rematerialized chunks do), and the gradients have the real
    loop's shapes."""
    from repro_torch.launch.costmodel import CostRecorder
    from repro_torch.models import xlstm
    from repro_torch.models.layers import Initializer

    cfg = get_config("xlstm-350m", smoke=True)
    p = xlstm.slstm_init(Initializer(torch.Generator().manual_seed(0)), cfg)

    def run(device):
        pp = {k: v.to(device).requires_grad_() for k, v in p.items()}
        x = torch.randn(2, 24, cfg.d_model).to(device).requires_grad_()
        rec = CostRecorder()
        with rec:
            y, st = xlstm.slstm_forward(x, pp, cfg, return_state=True)
            g = torch.autograd.grad(y.sum() + st["c"].sum(), [x, *pp.values()])
        return rec.costs, [tuple(t.shape) for t in g]

    real, g_real = run("cpu")
    meta, g_meta = run("meta")
    assert g_meta == g_real
    for field in ("flops", "naive_bytes"):
        a, b = getattr(meta, field), getattr(real, field)
        assert abs(a - b) <= 0.15 * b, (field, a, b)
