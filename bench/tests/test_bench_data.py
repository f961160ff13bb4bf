"""A cell is found from its files by name: the program's configuration and
trainer are built from the configuration's ``run.port_fields`` and the
traffic's ``trainer`` as given, the references are chosen by the trainer's
algorithm, topology and compressor, and a setting that the program or the
reference does not implement is refused before a run."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from bench import harness, reference


def _cell(name="olmo-1b.l8.b1k.int8ef"):
    return harness.load_cell(name)


def test_train_config_takes_the_trainer_as_given():
    tr = _cell().traffic["trainer"]
    tcfg = harness.train_config(tr, "torch")
    assert (tcfg.algorithm, tcfg.topology, tcfg.compression) == ("decentlam", "exp",
                                                                 "int8-row-ef")
    assert (tcfg.momentum, tcfg.grad_accum) == (0.9, 1)
    assert (tcfg.schedule.kind, tcfg.schedule.peak_lr, tcfg.schedule.warmup_steps,
            tcfg.schedule.total_steps) == ("warmup_cosine", 0.003, 20, 10000)
    assert (tcfg.fused_update, tcfg.fused_impl, tcfg.flat_planes) == (True, "torch", True)
    delayed = harness.train_config(dict(tr, gossip_delay=1), "torch")
    assert delayed.gossip_delay == 1  # a TrainConfig field reaches the program


@pytest.mark.parametrize("extra", [{"no_such_field": 1}, {"flat_planes": False},
                                   {"schedule": {"kind": "warmup_cosine", "no_such": 1}}])
def test_train_config_refuses_what_it_does_not_take(extra):
    tr = dict(_cell().traffic["trainer"], **extra)
    with pytest.raises(ValueError):
        harness.train_config(tr, "torch")


@pytest.mark.parametrize("name", ["olmo-1b.l8.b4k", "granite-moe-1b-a400m.l12.b4k"])
def test_program_config_from_port_fields(name):
    model = _cell(name).model
    cfg = harness.program_config(model)
    for field, key in model["run"]["port_fields"].items():
        assert getattr(cfg, field) == harness._lookup(model, key), field
    assert cfg.n_layers == model["num_hidden_layers"] and cfg.d_model == model["hidden_size"]


@pytest.mark.parametrize("change", [
    {"topology": "no-such-graph"}, {"algorithm": "no-such-algorithm"},
    {"compression": "no-such-compressor"}, {"gossip_delay": 1}, {"weight_decay": 0.1},
    {"schedule": {"kind": "constant", "peak_lr": 0.003}}])
def test_a_cell_the_reference_does_not_follow_is_refused(change, monkeypatch):
    cell = _cell()
    traffic = copy.deepcopy(cell.traffic)
    traffic["trainer"].update(change)
    orig = harness._load
    monkeypatch.setattr(harness, "_load",
                        lambda path: traffic if "traffic" in str(path) else orig(path))
    with pytest.raises(ValueError):
        harness.load_cell(cell.name)


def test_references_are_found_by_name():
    assert reference.load("algorithm", "decentlam") is reference.load("algorithm", "decentlam")
    W = reference.load("topology", "exp").mixing(8)
    assert np.allclose(W, W.T) and np.allclose(W.sum(1), 1.0)
    assert (W[0] > 0).sum() == 1 + 5  # itself and hops 1, 2, 4 either way (4 once)
    assert np.allclose(reference.load("topology", "exp").mixing(4), 0.25)
    comp = reference.load("compression", "int8-row-ef")
    p = torch.randn(3000, generator=torch.Generator().manual_seed(0))
    q, e = comp.send(p, comp.init(p))
    assert torch.equal(q + e, p) and 0 < float(e.abs().max()) < float(p.abs().max()) / 100
    for kind, name in (("family", "nope"), ("topology", "../dense"), ("compression", "")):
        with pytest.raises(ValueError):
            reference.load(kind, name)


def test_end_to_end_readers():
    cell = _cell()

    class _Program:
        tokens_per_step = 4096

    ctx = harness.Context(cell, _Program(), None, profiled_steps=0, window_steps=20,
                          window_s=10.0, stage_launches={}, setup_s=12.5,
                          peak_bytes=3 * 2**30)
    want = {"train_tokens_per_s": 20 * 4096 / 10.0, "peak_mem_gib": 3.0, "setup_s": 12.5}
    assert {m["name"] for m in cell.end_to_end} == set(want)
    for name, value in want.items():
        assert harness.read_metric(name, ctx) == value, name
    empty = dataclasses.replace(ctx, window_steps=0, peak_bytes=0)
    assert harness.read_metric("train_tokens_per_s", empty) is None
    assert harness.read_metric("peak_mem_gib", empty) is None
