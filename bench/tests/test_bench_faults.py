"""The whole run on the CPU at a small size (the look for a card skipped),
with the program's timed path broken underneath: ``correct`` comes out false
for each fault a training cell can have, and true for the sound program."""

import time

import pytest
import torch

import repro_torch.core.gossip as gossip
import repro_torch.models.transformer as T
import repro_torch.train.step as step_mod
from bench import harness
from bench.tests.tiny import tiny_cell

CELLS = ["olmo-1b.l8.b4k", "granite-moe-1b-a400m.l12.b4k", "olmo-1b.l8.b1k.int8ef"]


def _unchanged(monkeypatch):
    """The step returns its state unchanged."""
    monkeypatch.setattr(step_mod, "run_update", lambda spec, ocfg, *, x, state, comp_state,
                        **kw: (x, state, comp_state))


def _half_batch(monkeypatch):
    """Half of each node's rows left out, the mean taken over the rest."""
    orig = T.forward_loss

    def half(params, batch, cfg, rt=T.RuntimeConfig(dtype="float32"), **kw):
        b = batch["tokens"].shape[0]
        return orig(params, {k: v[: b // 2] for k, v in batch.items()}, cfg, rt, **kw)

    monkeypatch.setattr(T, "forward_loss", half)


def _no_exchange(monkeypatch):
    """The gossip returns each node's own payload."""
    monkeypatch.setattr(gossip.StackedChannel, "apply",
                        lambda self, state, tree, step: (state, tree))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "no_exchange": _no_exchange}


def _run(name):
    cell = tiny_cell(name)
    return harness.run_cell(cell, 2**31 + 3, 0.2, False, t0=time.perf_counter(),
                            device=torch.device("cpu"), impl="torch")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # every end-to-end metric but the allocator's peak, which the CPU has not
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_run_incorrect(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]
