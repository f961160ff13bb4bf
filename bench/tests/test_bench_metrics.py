"""Each per-layer reader on a small recorded trace (two profiled steps of
made-up kernels, launches and spans, ``data/small_trace.json``), against
the numbers worked out by hand; and each reader finds nothing to read
without a trace."""

from pathlib import Path

import pytest

from bench import harness, yardstick
from bench.kineto import Trace

DATA = Path(__file__).resolve().parent / "data" / "small_trace.json"


class _Program:
    n = 4
    plane_elems = 10

    def gossip_round_ms(self):
        return [3.0, 1.0, 2.0]


def _ctx(trace=True):
    cell = harness.load_cell("granite-moe-1b-a400m.l12.b4k")
    return harness.Context(cell, _Program(), Trace.from_json(DATA.read_text()) if trace else None,
                           profiled_steps=2, window_steps=10, window_s=10e-6,
                           stage_launches={"grad_step": 1, "decentlam_post": 1})


def test_trace_reading():
    tr = _ctx().trace
    assert len(tr.device) == 6  # the span's device copy is no operation
    assert tr.busy_ns() == 300 + 100 + 100 + 300 + 100 + 10
    assert tr.span_ns(("moe_",)) == (1, 300)
    gaps = tr.idle_gaps("bench.")
    assert gaps[0] == ["bench.step / aten::nonzero", 250e-9]
    assert gaps[1] == ["bench.step", 250e-9]
    assert len(gaps) == 5


def test_readers():
    ctx = _ctx()
    step_ms = 10e-6 * 1e3 / 10
    want = {
        "device_idle_pct": 100 * (1 - 910 / 2 / 1e6 / step_ms),
        "launches_per_step": 3.0,
        "gemm_ms_per_step": 600 / 2 / 1e6,
        "moe_fwd_ms_per_step": 300 / 2 / 1e6,
        "gossip_round_ms": 2.0,
        "fused_update_roofline_pct": 100 * (8 * 4 * 10 / 3.35e12) / 200e-9,
        "step_mfu_pct": 100 * ctx.step_flops * 10 / 10e-6 / (494.7e12 / 3),
    }
    assert ctx.step_flops == yardstick.step_flops(ctx.cell.model, ctx.cell.traffic, 4)
    for name, value in want.items():
        assert harness.read_metric(name, ctx) == pytest.approx(value, rel=1e-12), name


@pytest.mark.parametrize("name", ["device_idle_pct", "launches_per_step", "gemm_ms_per_step",
                                  "moe_fwd_ms_per_step", "fused_update_roofline_pct"])
def test_readers_without_a_trace(name):
    assert harness.read_metric(name, _ctx(trace=False)) is None


def test_roofline_reader_refuses_an_unknown_stage():
    ctx = _ctx()
    ctx.stage_launches = {"grad_step": 1, "momentum_step": 1}
    assert harness.read_metric("fused_update_roofline_pct", ctx) is None
