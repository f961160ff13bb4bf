"""The slice end to end: the port's stacked train step and CLI against a
JAX oracle, plus the port's import and device contracts."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import schedules as jsched
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro.kernels import fused_update as jfused
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.core import schedules as tsched
from repro_torch.core.optimizers import make_optimizer
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.train.step import TrainConfig, build_train_step

N_NODES, SEQ, PER_NODE, STEPS = 4, 32, 2, 3
SCHEDULE = dict(kind="warmup_cosine", peak_lr=0.05, warmup_steps=1, total_steps=STEPS)
# per-step losses: XLA and torch sum in different orders
LOSS_RTOL = 1e-5
# parameters and momentum after 3 steps: (x - mix) / lr amplifies roundoff
# by 1/lr per step (the JAX package's own fused-vs-reference tolerance)
STATE_RTOL, STATE_ATOL = 2e-3, 2e-5
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _jax_oracle(cfg, params, batches):
    """vmapped value_and_grad of the JAX forward_loss + run_update with the
    stacked channel, the stacked mean and the Pallas stage kernel (interpret
    mode), one jitted step."""
    ocfg = jopt.OptimizerConfig(algorithm="decentlam", momentum=0.9)
    spec, stage = jspec.update_spec(ocfg), jfused.make_stage("pallas_interpret")
    gossip = jgossip.StackedChannel(jtopo.build_topology("exp", N_NODES), telemetry=True)
    mean = jgossip.make_stacked_mean(N_NODES)
    lr_fn = jsched.build_schedule(jsched.ScheduleConfig(**SCHEDULE))
    rt = jT.RuntimeConfig(dtype="float32", remat=False)
    vg = jax.vmap(jax.value_and_grad(
        lambda p, b: jT.forward_loss(p, b, cfg, jlayers.TPContext(), rt)[0]
    ))

    @jax.jit
    def step(x, m, chan, batch, k):
        b = {n: v.reshape(N_NODES, PER_NODE, SEQ) for n, v in batch.items()}
        loss, g = vg(x, b)
        x, st, chan = jspec.run_update(
            spec, ocfg, x=x, g=g, state={"m": m}, lr=lr_fn(k), step_idx=k,
            gossip=gossip, mean=mean, comp_state=chan, stage=stage,
        )
        return x, st["m"], chan, jnp.mean(loss)

    x = jax.tree.map(jnp.asarray, params)
    m = jax.tree.map(jnp.zeros_like, x)
    chan = gossip.init(x)
    losses = []
    for k, batch in enumerate(batches):
        x, m, chan, loss = step(x, m, chan, jax.tree.map(jnp.asarray, batch), jnp.int32(k))
        losses.append(float(loss))
    return losses, jax.device_get(x), jax.device_get(m), jax.device_get(chan)


def test_train_step_matches_jax_oracle():
    """4 nodes, qwen3-0.6b SMOKE, exp, decentlam, 3 steps, fused update tail
    (the plain kernel on the CPU, in place) vs the JAX oracle."""
    jcfg, tcfg = jget_config("qwen3-0.6b", smoke=True), tget_config("qwen3-0.6b", smoke=True)
    one = jT.init_params(jax.random.key(0), jcfg)
    params = jax.device_get(jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (N_NODES,) + a.shape), one
    ))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ,
                                         per_node_batch=PER_NODE, n_nodes=N_NODES,
                                         heterogeneity=0.2))
    batches = [data.batch(k) for k in range(STEPS)]
    want_losses, want_x, want_m, want_chan = _jax_oracle(jcfg, params, batches)

    train = TrainConfig(algorithm="decentlam", topology="exp", momentum=0.9,
                        schedule=tsched.ScheduleConfig(**SCHEDULE), fused_update=True)
    step_fn, channel = build_train_step(tcfg, train, N_NODES)
    x = from_numpy(params)
    state = {"step": 0, "params": x, "opt": make_optimizer(train.opt_config()).init(x),
             "channel": channel.init(x)}
    losses = []
    for batch in batches:
        state, metrics = step_fn(state, from_numpy(batch))
        losses.append(float(metrics["loss"]))
        assert metrics["skipped_nonfinite"] == 0.0

    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for name, got, want in (("x", state["params"], want_x), ("m", state["opt"]["m"], want_m)):
        got = to_numpy(got)
        for leaf in jax.tree_util.tree_leaves_with_path(want):
            path, w = leaf
            g = got
            for key in path:
                g = g[key.key]
            np.testing.assert_allclose(g, w, rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"{name}{jax.tree_util.keystr(path)}")
    chan = to_numpy(state["channel"])
    assert int(chan["t"]["rounds"]) == int(want_chan["t"]["rounds"]) == STEPS
    assert float(chan["t"]["bytes"]) == float(want_chan["t"]["bytes"])


def test_finite_guard_skips_a_poisoned_node(monkeypatch):
    """A node whose gradient goes non-finite keeps its momentum and gossips
    its g = 0 iterate; the other nodes update normally."""
    from repro_torch.train import step as step_mod
    from repro_torch.train.train_state import init_train_state

    cfg = tget_config("qwen3-0.6b", smoke=True)
    train = TrainConfig(algorithm="decentlam", schedule=tsched.ScheduleConfig(**SCHEDULE),
                        fused_update=True)
    step_fn, channel = build_train_step(cfg, train, N_NODES)
    state = init_train_state(cfg, make_optimizer(train.opt_config()), N_NODES,
                             device=torch.device("cpu"), channel=channel)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                         per_node_batch=PER_NODE, n_nodes=N_NODES))
    state, _ = step_fn(state, from_numpy(data.batch(0)))
    m_before = state["opt"]["m"]["lm_head"]["w"].clone()

    clean = step_mod._node_grads

    def poisoned(*args):
        grads, losses = clean(*args)
        grads["lm_head"]["w"][2, 0, 0] = float("nan")
        return grads, losses

    monkeypatch.setattr(step_mod, "_node_grads", poisoned)
    state, metrics = step_fn(state, from_numpy(data.batch(1)))
    assert metrics["skipped_nonfinite"] == 1.0
    m_after = state["opt"]["m"]["lm_head"]["w"]
    torch.testing.assert_close(m_after[2], m_before[2], rtol=0, atol=0)
    for i in (0, 1, 3):
        assert not torch.equal(m_after[i], m_before[i])
    for t in (state["params"]["lm_head"]["w"], m_after):
        assert torch.isfinite(t).all()


CLI = ["--nodes", "4", "--arch", "qwen3-0.6b", "--smoke", "--steps", "2", "--seq-len", "16",
       "--per-node-batch", "2", "--log-every", "1"]


def test_cli_on_cpu_fused_matches_reference(tmp_path):
    out = tmp_path / "m.json"
    fused = tlaunch.main(CLI + ["--fused-update", "--device", "cpu",
                                "--measure-json", str(out)])
    ref = tlaunch.main(CLI + ["--device", "cpu"])
    assert len(fused["losses"]) == 2 and np.all(np.isfinite(fused["losses"]))
    np.testing.assert_allclose(fused["losses"], ref["losses"], rtol=1e-6)
    assert out.exists() and fused["device"] == "cpu" and fused["peak_mem_bytes"] is None


def test_cli_without_cpu_flag_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(CLI)


def test_port_imports_neither_jax_nor_repro():
    # every module but the Triton kernel body, which the launcher imports
    # at the first launch on the card
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')\n"
        "        if m.name != 'repro_torch.kernels.fused_update._triton']\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'triton'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
