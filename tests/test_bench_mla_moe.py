"""The benchmark's readers of the latent-attention MoE cell
(``deepseek-v2-lite.l7.e8.b4k``): ``mla_fwd_ms_per_step`` and
``moe_shared_ms_per_step`` on a recorded trace of two steps
(``bench/tests/data/mla_moe_trace.json``: made-up kernels under the ``mla``
span and its ``mla_latent`` and ``mla_core``, one launched by a
``cuLaunchKernelEx`` call and linked to no CPU event, the ``moe_shared``
span, a forward kernel outside both and backward kernels on autograd's
thread), against the numbers worked out by hand; both find nothing without
a trace or a span.  ``mla_moe_step_mfu_pct``'s FLOP count at the smoke
model's sizes against a count by hand, and its reading."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench.kineto import Trace  # noqa: E402

TRACE = ROOT / "bench" / "tests" / "data" / "mla_moe_trace.json"
CELL = "deepseek-v2-lite.l7.e8.b4k"


class _Program:
    n = 4


def _ctx(trace=TRACE, cell=None):
    cell = cell or harness.load_cell(CELL)
    tr = None if trace is None else Trace.from_json(Path(trace).read_text())
    return harness.Context(cell, _Program(), tr, profiled_steps=2, window_steps=10,
                           window_s=10e-6, stage_launches={})


def test_span_readers():
    ctx = _ctx()
    # step 1: gemm_q 40, gemm_kva 20 (mla_latent), scores 60 (mla_core), the
    # unlinked rope kernel 5 (its cuLaunchKernelEx call lies in mla), gemm_o
    # 20; step 2: gemm_q 50.  Not the add (forward, outside) nor the backward.
    assert harness.read_metric("mla_fwd_ms_per_step", ctx) == pytest.approx(
        (40 + 20 + 60 + 5 + 20 + 50) / 2 / 1e6, rel=1e-12)
    assert harness.read_metric("moe_shared_ms_per_step", ctx) == pytest.approx(
        (30 + 20) / 2 / 1e6, rel=1e-12)


@pytest.mark.parametrize("name", ["mla_fwd_ms_per_step", "moe_shared_ms_per_step"])
def test_span_readers_find_nothing_without_a_trace_or_span(name):
    assert harness.read_metric(name, _ctx(trace=None)) is None
    # a program without the spans (granite's recorded steps)
    other = ROOT / "bench" / "tests" / "data" / "step_trace.json"
    assert harness.read_metric(name, _ctx(trace=other)) is None


def _metric_module():
    import importlib.util

    path = ROOT / "bench" / "metrics" / "mla_moe_step_mfu_pct.py"
    spec = importlib.util.spec_from_file_location("mla_moe_step_mfu_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_cell():
    """The cell at the smoke model's sizes, holding all 8 experts: d 64, 4
    heads of 16 + 8 (q, k) and 12 (v), latent 32, 4 layers (1 dense of
    width 96), experts of width 16 top-3, 2 shared, vocab 256, 2 rows of 32
    tokens a node."""
    cell = harness.load_cell(CELL)
    cell.model = dict(cell.model, hidden_size=64, num_attention_heads=4, intermediate_size=96,
                      moe_intermediate_size=16, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=12, vocab_size=256, num_hidden_layers=4,
                      n_routed_experts=8, num_experts_per_tok=3,
                      run=dict(cell.model["run"], router_width=8))
    cell.traffic = dict(cell.traffic, seq_len=32, rows_per_node=2)
    return cell


def test_flop_count_at_the_smoke_sizes():
    cell = _smoke_cell()
    mla = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 28 + 4 * 12 * 64  # wq, wkv_a, wkv_b, wo: 15,360
    dense = 3 * 64 * 96  # layer 0's SwiGLU
    # router, 2 shared experts, and the held 8 of 8 experts' share 3 * 8 / 8
    moe = 64 * 8 + 2 * 3 * 64 * 16 + 3 * (3 * 64 * 16)
    head = 64 * 256
    params = 4 * mla + dense + 3 * moe + head
    assert params == 143_872
    mod = _metric_module()
    assert mod.product_params(cell.model) == params
    attn = 6 * 4 * 4 * (24 + 12) * 32  # two S x S products, forward and backward, per token
    tokens = 4 * 2 * 32
    assert mod.step_flops(cell.model, cell.traffic, 4) == tokens * (6 * params + attn)
    # a held block of 4: a token's 3 of 8 experts fall in it half the time,
    # 1.5 experts fewer in each of the 3 MoE layers
    half = dict(cell.model, n_routed_experts=4)
    assert mod.product_params(half) == params - 3 * 1.5 * (3 * 64 * 16)


def test_mfu_reading():
    cell = _smoke_cell()
    ctx = _ctx(cell=cell)
    flops = _metric_module().step_flops(cell.model, cell.traffic, 4)
    assert harness.read_metric("mla_moe_step_mfu_pct", ctx) == pytest.approx(
        100 * flops * 10 / 10e-6 / (494.7e12 / 3), rel=1e-12)
    ctx.window_steps = 0
    assert harness.read_metric("mla_moe_step_mfu_pct", ctx) is None


def test_cell_is_declared_as_the_contract_asks():
    """One new config (the catalog's source), one one-chip cell on the
    traffic ``b4k``, three per-layer metrics that list it alone; its limits
    name the block numbers; the configuration's cuts are its ``reduced``."""
    import json

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == "deepseek-v2-lite.l7.e8")
    assert conf["source"] == ("https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/"
                              "config.json")
    model = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == model["reduced"] == sorted(model["published"], key=conf[
        "reduced"].index)
    assert model["published"] == {"num_hidden_layers": 27, "n_routed_experts": 64,
                                  "vocab_size": 102400}
    work = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (work["config"], work["traffic"], work["chips"]) == ("deepseek-v2-lite.l7.e8",
                                                                "b4k", 1)
    assert len(work["why"]) <= 200 and len(conf["why"]) <= 200
    mine = [m for m in spec["per_layer"] if CELL in m["workloads"]]
    assert sorted(m["name"] for m in mine) == ["mla_fwd_ms_per_step", "mla_moe_step_mfu_pct",
                                               "moe_shared_ms_per_step"]
    assert all(m["workloads"] == [CELL] and m["moves"] == "train_tokens_per_s" for m in mine)
    limits = json.loads((ROOT / "bench" / "limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"loss", "grad", "change", "grad_block", "change_block"}
    assert os.path.isfile(ROOT / "bench" / "reference" / "mla_moe.py")
