"""The port's profiler spans (``repro_torch.trace``) on the CPU.

* Under a profiler, the stacked step on flat planes, with plain and
  int8-row-ef gossip, at one and two microbatches (and a tiny MoE model):
  per step ``n x accum`` ``train.forward`` and ``train.backward`` spans, one
  ``train.guard`` holding the step's one host sync ``sync.finite_guard``,
  one ``train.update`` holding one ``gossip.apply`` (holding ``n``
  ``gossip.codec`` with int8-row-ef); every ``aten::`` op of a step lies
  inside exactly one ``train.*`` phase span; and the losses and planes equal
  an unprofiled run's bit for bit.
* Without a profiler a step enters ``record_function`` zero times (the
  MoE, SSM and sLSTM spans included), and under one it does enter it.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core.optimizers import make_optimizer
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import from_numpy
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.train_state import init_train_state, model_plane_layout
from repro_torch.utils import tree_leaves

N, SEQ, ROWS, STEPS = 4, 16, 2, 2
STEP_SPAN = "test.step"
CASES = {
    "plain-accum1": ("qwen3-0.6b", None, 1),
    "plain-accum2": ("qwen3-0.6b", None, 2),
    "int8ef-accum1": ("qwen3-0.6b", "int8-row-ef", 1),
    "int8ef-accum2": ("qwen3-0.6b", "int8-row-ef", 2),
    "moe-accum1": ("granite-moe-1b-a400m", None, 1),
}


def _trainer(arch, compression, accum):
    cfg = get_config(arch, smoke=True)
    tc = TrainConfig(compression=compression, grad_accum=accum, fused_update=True,
                     fused_impl="torch", flat_planes=True,
                     schedule=ScheduleConfig(kind="warmup_cosine", peak_lr=0.05,
                                             warmup_steps=1, total_steps=STEPS))
    step_fn, channel = build_train_step(cfg, tc, N)
    state = init_train_state(cfg, make_optimizer(tc.opt_config()), N,
                             device=torch.device("cpu"), channel=channel,
                             plane_layout=model_plane_layout(cfg))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                         per_node_batch=ROWS * accum, n_nodes=N))
    return step_fn, state, data


def _run(case, profiled):
    """``STEPS`` steps: (losses, final state, the profile's CPU events as
    ``(name, thread, start ns, end ns)``, or None unprofiled)."""
    step_fn, state, data = _trainer(*CASES[case])
    losses = []
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext()
    with prof:
        for k in range(STEPS):
            batch = from_numpy(data.batch(k))
            with record_function(STEP_SPAN) if profiled else contextlib.nullcontext():
                state, met = step_fn(state, batch)
            losses.append(met["loss"].clone())
    if not profiled:
        return losses, state, None
    events = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU and not e.is_async()]
    return losses, state, events


def _inside(events, outer, prefix):
    """The events whose name starts with ``prefix`` starting inside ``outer``'s
    interval, on any thread."""
    _, _, s, e = outer
    return [ev for ev in events if ev[0].startswith(prefix) and s <= ev[2] <= e]


def _named(events, name):
    return [ev for ev in events if ev[0] == name]


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_spans(case):
    arch, compression, accum = CASES[case]
    losses, state, events = _run(case, profiled=True)
    steps = _named(events, STEP_SPAN)
    assert len(steps) == STEPS
    for step in steps:
        inside = _inside(events, step, "")
        assert len(_named(inside, "train.forward")) == N * accum
        assert len(_named(inside, "train.backward")) == N * accum
        (guard,) = _named(inside, "train.guard")
        assert [ev[0] for ev in _inside(inside, guard, "sync.")] == ["sync.finite_guard"]
        assert len(_inside(inside, step, "sync.")) == 1  # the step's one host sync
        (update,) = _named(inside, "train.update")
        (apply,) = _inside(inside, update, "gossip.apply")
        codecs = _inside(inside, apply, "gossip.codec")
        assert len(codecs) == (N if compression else 0)
        assert _inside(inside, apply, "gossip.mix")
        if arch.startswith("granite"):
            fwd = _named(inside, "train.forward")
            moe = _inside(inside, step, "moe_")
            assert moe and all(any(f[2] <= m[2] and m[3] <= f[3] for f in fwd) for m in moe)
        # the phases tile the step: every op in exactly one phase span
        phases = [ev for ev in inside if ev[0].startswith("train.")]
        ops = [ev for ev in inside if ev[0].startswith("aten::")]
        assert ops
        for op in ops:
            holders = [p for p in phases if p[2] <= op[2] and op[3] <= p[3]]
            assert len(holders) == 1, (op, holders)

    # the spans change nothing the step computes
    plain_losses, plain_state, _ = _run(case, profiled=False)
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)
    for part in ("planes", "opt", "channel"):
        got, want = tree_leaves(state[part]), tree_leaves(plain_state[part])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), part
            else:
                assert a == b, part


@pytest.mark.parametrize("case", list(CASES) + ["ssm", "slstm"])
def test_no_record_function_without_a_profiler(case, monkeypatch):
    calls = []

    def counting(name):
        calls.append(name)
        return record_function(name)

    monkeypatch.setattr(trace, "record_function", counting)
    if case in CASES:
        step_fn, state, data = _trainer(*CASES[case])
        batches = [from_numpy(data.batch(k)) for k in range(2)]
        state, _ = step_fn(state, batches[0])
        assert calls == []
        with profile(activities=[ProfilerActivity.CPU]):
            step_fn(state, batches[1])
    else:
        # the SSM and sLSTM spans sit in their models' forward
        from repro_torch.models import transformer as T

        cfg = get_config("hymba-1.5b" if case == "ssm" else "xlstm-350m", smoke=True)
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        batch = from_numpy(SyntheticLM(SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=SEQ, per_node_batch=ROWS, n_nodes=1)).batch(0))
        T.forward_loss(params, batch, cfg)
        assert calls == []
        with profile(activities=[ProfilerActivity.CPU]):
            T.forward_loss(params, batch, cfg)
    assert calls, "the patched helper was not reached under the profiler"
    if case == "moe-accum1":
        assert {"moe_router", "moe_dispatch", "moe_experts", "moe_combine"} <= set(calls)
    if case in ("ssm", "slstm"):
        assert ("ssm_forward" if case == "ssm" else "slstm_recurrence") in calls
