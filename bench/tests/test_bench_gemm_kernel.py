"""``gemm_kernel_share_pct`` on a small recorded trace (two profiled steps:
two launches of the port's 3xTF32 kernel, one cuBLAS sgemm, made-up other
kernels, ``data/gemm_kernel_trace.json``), against the share worked out by
hand; 0.0 on a trace whose products all ran in cuBLAS (``small_trace.json``);
nothing without a trace."""

from pathlib import Path

import pytest

from bench import harness
from bench.kineto import Trace

DATA = Path(__file__).resolve().parent / "data"


class _Program:
    n = 4
    plane_elems = 10


def _ctx(trace):
    cell = harness.load_cell("olmo-1b.l8.b4k")
    return harness.Context(cell, _Program(), trace, profiled_steps=2, window_steps=10,
                           window_s=10e-6, stage_launches={})


def test_share_of_the_products_in_the_kernel():
    ctx = _ctx(Trace.from_json((DATA / "gemm_kernel_trace.json").read_text()))
    # the kernel's 300 + 100 ns of the products' 300 + 100 + 100 ns
    assert harness.read_metric("gemm_ms_per_step", ctx) == pytest.approx(500 / 2 / 1e6)
    assert harness.read_metric("gemm_kernel_share_pct", ctx) == pytest.approx(80.0)


def test_no_product_through_the_kernel_reads_zero():
    ctx = _ctx(Trace.from_json((DATA / "small_trace.json").read_text()))
    assert harness.read_metric("gemm_kernel_share_pct", ctx) == 0.0


def test_nothing_to_read_without_a_trace():
    assert harness.read_metric("gemm_kernel_share_pct", _ctx(None)) is None
