"""The port's dry run (``repro_torch.launch.dryrun``) and report, on the CPU.

Cells are built on the meta device: one rank's program of a ``(nodes x
tp)`` grid on a dry group, run once under the cost model's recorder.  On a
small config and grid a dense train, prefill and decode cell return ``ok``
with positive terms and memory, each hand-written kernel launch counted as
one unit (2 stage launches on planes, 28 per leaf, one flash launch per
layer of a prefill); ``long_500k`` skips for a full-attention arch; a
kernel entry point on meta tensors runs no plain version; the live-bytes
tracker counts a known program's peak exactly.  (The other families' cells
at tp > 1, and whisper's serve cells recorded as errors, are
``test_torch_tp_zoo_layouts.py``'s.)
"""

import json

import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.costmodel import CostRecorder, MemoryTracker

SMOKE = get_config("qwen3-0.6b", smoke=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ok(rec):
    assert rec["status"] == "ok", rec
    t, m = rec["roofline"], rec["memory"]
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    assert t["dominant"] in ("compute", "memory", "collective")
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0 and m["output_bytes"] > 0
    assert rec["hlo_flops_per_device"] > 0 and rec["model_flops"] > 0
    return rec


@pytest.mark.parametrize("planes", [True, False], ids=["planes", "per-leaf"])
def test_dense_train_cell_on_a_small_grid(planes):
    args = dryrun.parser().parse_args([] if planes else ["--no-flat-planes"])
    rec = _ok(dryrun.run_cell(SMOKE, ShapeSpec("t", "train", 32, 8), (4, 2), args))
    assert rec["grid"] == [4, 2] and rec["chips"] == 8
    assert rec["raw"]["kernel_launches"] == {"fused_update": 2 if planes else 28}
    counts = rec["collectives"]["counts"]
    assert counts["collective-permute"] > 0 and counts["all-reduce"] > 0
    axes = {k.split("@")[1] for k in rec["collectives"]["breakdown_top"]}
    assert axes <= {"node", "model"} and "model" in axes
    assert rec["roofline"]["collective_s"] > 0
    assert rec["knobs"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_serve_cells_on_a_small_grid(kind):
    rec = _ok(dryrun.run_cell(SMOKE, ShapeSpec("s", kind, 64, 4), (2, 2)))
    launches = rec["raw"]["kernel_launches"]
    if kind == "prefill":  # flash, once per layer, on meta
        assert launches == {"flash_attention": SMOKE.n_layers}
        from repro_torch.kernels.flash_attention.kernel import work

        flops, _ = work((2, 64, SMOKE.n_heads // 2, SMOKE.hd),
                        (2, 64, SMOKE.n_kv_heads, SMOKE.hd), torch.bfloat16, True, 0)
        assert rec["raw"]["kernel_flops"]["flash_attention"] == SMOKE.n_layers * flops
    else:
        assert launches == {}


def test_a_one_by_one_grid_runs_phase_15s_program():
    args = dryrun.parser().parse_args(["--dtype", "float32"])
    rec = _ok(dryrun.run_cell(SMOKE, ShapeSpec("t", "train", 32, 2), (1, 1), args))
    assert rec["collectives"]["egress_bytes"] == 0.0  # a group of one moves nothing
    assert rec["hw"]["peak_flops"] == 67e12  # f32 prices at the FFMA peak


def test_long_500k_skips_for_a_full_attention_arch():
    rec = dryrun.run_cell("qwen3-0.6b", "long_500k", "pod1")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_a_moe_cell_at_tp_1_runs():
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    rec = _ok(dryrun.run_cell(cfg, ShapeSpec("t", "train", 32, 4), (2, 1)))
    assert rec["raw"]["kernel_launches"] == {"fused_update": 2}


def test_kernel_entry_points_on_meta_run_no_plain_version(monkeypatch):
    from repro_torch.core.update_spec import MathCtx
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_update import fused_plane_stage
    from repro_torch.kernels.fused_update.kernel import reset_launches, stage_plain
    from repro_torch.kernels.mlstm_chunk import ops as ml_ops

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta tensors")

    monkeypatch.setattr(fa_ops, "reference_attention", refuse)
    monkeypatch.setattr(ml_ops, "mlstm_chunked", refuse)
    meta = dict(device="meta")
    rec = CostRecorder()
    with rec:
        o = fa_ops.flash_attention(torch.empty(2, 8, 4, 64, **meta),
                                   torch.empty(2, 8, 2, 64, **meta),
                                   torch.empty(2, 8, 2, 64, **meta))
        h, st = ml_ops.mlstm(*(torch.empty(1, 2, 16, 32, **meta) for _ in range(3)),
                             *(torch.empty(1, 2, 16, **meta) for _ in range(2)), chunk=8)
        reset_launches()
        plane = {"f": torch.empty(3, 1024, **meta)}
        out = fused_plane_stage("post", "decentlam_post", MathCtx(beta=0.9),
                                {"x": plane, "mix": plane, "m": plane},
                                {"lr": 0.1}, plane)
    assert stage_plain.calls == 0
    assert o.shape == (2, 8, 4, 64) and o.is_meta
    assert h.shape == (1, 2, 16, 32) and st["C"].shape == (1, 2, 32, 32)
    assert out["x"]["f"].is_meta and out["m"]["f"].dtype == torch.float32
    assert rec.costs.kernel_launches == {"flash_attention": 1, "mlstm_chunk": 1,
                                         "fused_update": 1}
    # the units' own work, and nothing of the meta stand-ins' allocations:
    # outside them only the stage's (4,) scalar vector is built
    assert 0 <= rec.costs.flops - sum(rec.costs.kernel_flops.values()) < 16


def test_memory_tracker_counts_a_known_peak():
    x = torch.empty(1024, device="meta")  # 4 KiB argument

    def f(x):
        y = x * 2  # +4 KiB
        z = torch.cat([y, y])  # +8 KiB: 12 KiB live
        del y  # 8 KiB live
        return z + 1  # +8 KiB: 16 KiB live at the peak

    mem = MemoryTracker((x,))
    with CostRecorder(memory=mem):
        out = f(x)
    rep = mem.report(out)
    assert rep == {"argument_bytes": 4096.0, "output_bytes": 8192.0, "temp_bytes": 16384.0,
                   "alias_bytes": 0.0}


def test_report_tables_the_records(tmp_path):
    args = dryrun.parser().parse_args([])
    root = tmp_path / "baseline" / "pod1"
    root.mkdir(parents=True)
    for name, shape in (("t", ShapeSpec("train_4k", "train", 32, 8)),
                        ("d", ShapeSpec("decode_32k", "decode", 64, 4))):
        rec = dryrun.run_cell(SMOKE, shape, (2, 2), args)
        rec["arch"] = "qwen3-0.6b"
        (root / f"{name}.json").write_text(json.dumps(rec))
    (root / "x.json").write_text(json.dumps(dryrun.run_cell("qwen3-0.6b", "long_500k", "pod1")))
    recs = report.load("baseline", "pod1", str(tmp_path))
    table = report.table(recs)
    assert table.count("| qwen3-0.6b |") == 3 and "*skipped*" in table
    assert "fused_update 2" in table
    diff = report.compare("baseline", "baseline", "pod1", str(tmp_path))
    assert "+0.0%" in diff
