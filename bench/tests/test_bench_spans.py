"""The readers of the program's spans (``bench/spans.py``) on a recorded
trace of two steps (``data/step_trace.json``: made-up kernels under the
step's phase, gossip, codec and sync spans; a backward kernel launched
from a second thread while the step's thread sits in ``train.backward``; a
kernel linked to no CPU event, launched by a ``cuLaunchKernelEx`` call, and
one with no launch call before the next linked launch; a gap that opens
while the host waits in ``sync.finite_guard``'s ``nonzero`` and closes
after the wait, one that closes inside it, and one that opens after the
wait inside the ``nonzero``; two waits in one ``aten::nonzero``; a sync in no sync span whose wait the device drains;
an operation in the step and in no phase), against the numbers worked out
by hand; each span reader finds nothing to read without a trace or a
span, and the sync readers read the host's calls, not the spans."""

from pathlib import Path

import pytest

from bench import harness, spans
from bench.kineto import Trace

DATA = Path(__file__).resolve().parent / "data"
READERS = ["fwd_ms_per_step", "bwd_ms_per_step", "update_ms_per_step", "gossip_step_ms",
           "gossip_codec_ms_per_step", "host_syncs_per_step", "sync_idle_ms_per_step"]
SYNC_READERS = ("host_syncs_per_step", "sync_idle_ms_per_step")


class _Program:
    n = 4
    plane_elems = 10


def _ctx(trace: str | None = "step_trace.json"):
    cell = harness.load_cell("olmo-1b.l8.b1k.int8ef")
    tr = None if trace is None else Trace.from_json((DATA / trace).read_text())
    return harness.Context(cell, _Program(), tr, profiled_steps=2, window_steps=10,
                           window_s=10e-6, stage_launches={})


def test_span_attribution():
    sp = spans.Spans(_ctx().trace)
    assert len(sp.trace.device) == 22  # the span's device copy is no operation
    # the unlinked stage kernel takes its cuLaunchKernelEx call; the split-K
    # kernel the start of the backward launch after it; the orphan after the
    # last linked launch has none
    assert (612, 40) in sp.launched() and (1350, 10) in sp.launched()
    assert len(sp.launched()) == 21
    # the backward kernels (launched on thread 2) belong to train.backward
    assert sp.device_ns("train.backward") == 175 + 25 + 200 + 10
    # the MoE kernel nests in train.forward; update less its gossip round
    assert sp.device_ns("train.forward") == 100 + 50 + 100
    assert sp.device_ns("moe_router") == 50
    assert sp.device_ns("train.update", ("gossip.apply",)) == 40 + 40
    assert sp.device_ns("train.guard") == 10 + 10 + 3
    assert sp.untiled_ns() == 10
    # one sync an aten:: op: step 1's nonzero waits twice; sync.metrics holds no wait
    assert [(s[1], s[3], len(s[4])) for s in sp.syncs()] == [
        (525, "aten::nonzero", 2), (1160, "aten::item", 1), (1525, "aten::nonzero", 1)]
    # the device drained at the sync: from its last operation to the next launch,
    # and again after the nonzero's own kernel; the gap [535, 540] between queued
    # operations opens before the wait
    assert sp.sync_idle_ns() == (620 - 575) + (1360 - 1180) + (1589 - 1570) + (1650 - 1592)
    assert sp.unspanned_syncs() == [["cudaStreamSynchronize", "train.forward", "aten::item", 45]]


def test_readers():
    ctx = _ctx()
    want = {
        "fwd_ms_per_step": 250 / 2 / 1e6,
        "bwd_ms_per_step": 410 / 2 / 1e6,
        "update_ms_per_step": 80 / 2 / 1e6,
        "gossip_step_ms": (30 + 60) * 2 / 2 / 1e6,
        "gossip_codec_ms_per_step": 30 * 2 / 2 / 1e6,
        "host_syncs_per_step": 3 / 2,
        "sync_idle_ms_per_step": 302 / 2 / 1e6,
    }
    for name, value in want.items():
        assert harness.read_metric(name, ctx) == pytest.approx(value, rel=1e-12), name


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("trace", [None, "small_trace.json"])
def test_readers_without_a_trace_or_a_span(name, trace):
    """No trace: nothing to read.  A trace of a program without the step's
    spans: the span readers find nothing; the sync readers read its host
    calls, of which none waits for the device."""
    want = 0.0 if trace and name in SYNC_READERS else None
    assert harness.read_metric(name, _ctx(trace)) == want


def test_sync_readers_ignore_the_spans():
    """The same trace without its ``sync.*`` spans reads the same syncs."""
    ctx = _ctx()
    bare = _ctx()
    bare.trace = Trace(ctx.trace.device, ctx.trace.ops,
                       [c for c in ctx.trace.cpu if not c[0].startswith(spans.SYNC)])
    for name in SYNC_READERS:
        assert harness.read_metric(name, bare) == harness.read_metric(name, ctx), name


def test_audit_of_a_tiny_cell():
    """``bench/audit.py`` on a tiny int8-row-ef cell on the CPU: the step's
    spans per step, and no host sync outside a sync span."""
    import torch

    from bench import audit
    from bench.tests.tiny import tiny_cell

    out = audit.audit(tiny_cell("olmo-1b.l8.b1k.int8ef"), 5, torch.device("cpu"), impl="torch")
    per = out["spans_per_step"]
    assert per["train.forward"] == per["train.backward"] == 4
    assert per["train.guard"] == per["train.update"] == per["gossip.apply"] == 1
    assert per["gossip.codec"] == 4 and per["sync.finite_guard"] == 1
    assert out["unspanned_syncs"] == [] and out["untiled_ms"] == 0
