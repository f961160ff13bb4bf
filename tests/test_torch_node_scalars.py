"""Per-node clip and LARS scalars in the stacked step, against the JAX
package.

``repro``'s shard_map step calls ``grad_scalars`` inside each node's shard,
so each node clips by its own gradient norm and takes its own LARS norms.
The port's stacked step computes the same per node
(``node_grad_scalars``): an ``(n,)`` clip scale and a tree of ``(n,)`` LARS
ratios, which the stage math broadcasts over the node axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import optimizers as jopt
from repro.core import topology as jtopo
from repro.core import update_spec as jspec
from repro_torch.configs import get_config as tget_config
from repro_torch.core import gossip as tgossip
from repro_torch.core import optimizers as topt
from repro_torch.core import topology as ttopo
from repro_torch.core import update_spec as tspec
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.kernels import fused_update as tfused
from repro_torch.train.step import TrainConfig, _node_grads, build_train_step
from repro_torch.train.train_state import init_train_state
from repro_torch.utils import tree_leaves, tree_map

N = 4
TAIL_RTOL, TAIL_ATOL = 2e-3, 2e-5  # as test_torch_core.py
SHAPES = {"w": (5, 7), "b": (3,), "e": (11, 2)}
CASES = {
    "clip": dict(grad_clip=0.8),
    "lars": dict(lars=True, lars_trust=0.02),
    "lars-clip-wd": dict(lars=True, grad_clip=0.8, weight_decay=1e-2, lars_trust=0.02),
    "pmsgd-lars-clip-wd": dict(algorithm="pmsgd-lars", grad_clip=0.8, weight_decay=1e-2),
}


def _trees(seed):
    rng = np.random.default_rng(seed)
    # node i's gradient scaled by 0.5 * (i + 1): per-node norms differ
    x = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SHAPES.items()}
    g = {k: (rng.standard_normal((N,) + s) * (0.5 * (1 + np.arange(N)))
             .reshape((N,) + (1,) * len(s))).astype(np.float32) for k, s in SHAPES.items()}
    return x, g


def _cfgs(name):
    kw = {"algorithm": "decentlam", "momentum": 0.9, **CASES[name]}
    return jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_node_scalars_equal_jax_grad_scalars_per_node(name):
    jcfg, tcfg = _cfgs(name)
    x, g = _trees(1)
    s = tspec.node_grad_scalars(tcfg, from_numpy(x), from_numpy(g))
    clip, lars = tcfg.grad_clip > 0, tcfg.lars or tcfg.algorithm == "pmsgd-lars"
    assert tuple(s["gs"].shape) == ((N,) if clip else ())
    assert isinstance(s["r"], dict) == lars
    for i in range(N):
        want = jspec.grad_scalars(jcfg, {k: jnp.asarray(v[i]) for k, v in x.items()},
                                  {k: jnp.asarray(v[i]) for k, v in g.items()})
        if clip:
            np.testing.assert_allclose(float(s["gs"][i]), float(want["gs"]), rtol=1e-6)
        if lars:
            for k in SHAPES:
                np.testing.assert_allclose(float(s["r"][k][i]), float(want["r"][k]),
                                           rtol=1e-6)
    if clip:  # the per-node scales differ: one norm over all nodes would not
        assert len(set(s["gs"].tolist())) == N


def test_node_scalars_are_grad_scalars_without_clip_or_lars():
    """Unstacked and single-node callers are unchanged: with neither feature
    the stacked step's scalars are ``grad_scalars``' scalar ones."""
    x, g = _trees(2)
    cfg = topt.OptimizerConfig(algorithm="decentlam", weight_decay=1e-2)
    s = tspec.node_grad_scalars(cfg, from_numpy(x), from_numpy(g))
    assert set(s) == {"gs", "r"} and s["gs"].ndim == 0 and s["r"].ndim == 0
    assert float(s["gs"]) == float(s["r"]) == 1.0


def _jax_tail(jcfg, x, grads, scalars):
    """2 steps of the reference's stacked ``run_update`` (its reference stage)
    fed the port's per-node scalars (:func:`_jax_scalars`)."""
    topo = jtopo.build_topology("exp", N)
    gossip, mean = jgossip.StackedChannel(topo), jgossip.make_stacked_mean(N)
    spec, opt = jspec.update_spec(jcfg), jopt.make_optimizer(jcfg)
    xj = jax.tree.map(jnp.asarray, x)
    st = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (N,) + a.shape),
                      opt.init(jax.tree.map(lambda a: a[0], xj)))
    for k, g in enumerate(grads):
        sc, gj = _jax_scalars(scalars[k], g)
        xj, st, _ = jspec.run_update(
            spec, jcfg, x=xj, g=gj, state=st, lr=0.05, step_idx=jnp.int32(k),
            gossip=gossip, mean=mean, comp_state=(), scalars=sc)
    return jax.device_get(xj), jax.device_get(st)


def _jax_scalars(s, g):
    """The port's per-node scalars in a form the reference's stage math
    broadcasts: the clip scale folded into g first (``gs_i * g_i``, the
    multiply the stage does first; gs then 1.0), each leaf's ``(n,)`` LARS
    ratio reshaped to ``(n, 1, ...)`` against its leaf."""
    def node_axis(v, like):
        return jnp.asarray(v.numpy()).reshape((N,) + (1,) * (like.ndim - 1))

    gs = s["gs"]
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    if gs.ndim:
        gj = {k: node_axis(gs, v) * v for k, v in gj.items()}
    r = s["r"]
    r = ({k: node_axis(v, gj[k]) for k, v in r.items()} if isinstance(r, dict)
         else jnp.float32(float(r)))
    return {"gs": jnp.float32(1.0), "r": r}, gj


@pytest.mark.parametrize("fused", [False, True], ids=["reference", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_tail_with_node_scalars_matches_jax(name, fused):
    """2 steps of the port's stacked tail with per-node scalars == the
    reference's stacked ``reference_stage`` fed the same per-node scalars."""
    jcfg, tcfg = _cfgs(name)
    x, _ = _trees(3)
    grads = [_trees(4 + k)[1] for k in range(2)]
    topo = ttopo.build_topology("exp", N)
    gossip, mean = tgossip.StackedChannel(topo), tgossip.make_stacked_mean(N)
    spec = tspec.update_spec(tcfg)
    stage = tfused.make_stage("triton", inplace=True) if fused else tspec.reference_stage
    xt = from_numpy(x)
    st = topt.make_optimizer(tcfg).init(xt)
    used = []
    for k, g in enumerate(grads):
        s = tspec.node_grad_scalars(tcfg, xt, from_numpy(g))
        used.append(s)
        xt, st, _ = tspec.run_update(spec, tcfg, x=xt, g=from_numpy(g), state=st, lr=0.05,
                                     step_idx=k, gossip=gossip, mean=mean, comp_state={},
                                     stage=stage, scalars=s)
    want_x, want_s = _jax_tail(jcfg, x, grads, used)
    for k in SHAPES:
        np.testing.assert_allclose(to_numpy(xt)[k], want_x[k], rtol=TAIL_RTOL, atol=TAIL_ATOL)
        np.testing.assert_allclose(to_numpy(st["m"])[k], want_s["m"][k], rtol=TAIL_RTOL,
                                   atol=TAIL_ATOL)


def test_fused_engine_takes_per_node_scalars_bitwise():
    """The fused engine's per-leaf stage with (n,) gs and r (the kernel's
    per-node mode; its plain version on the CPU) == ``reference_stage``."""
    _, tcfg = _cfgs("lars-clip-wd")
    ctx = tspec.phase_ctx(tcfg, tspec.update_spec(tcfg), 0)
    x, g = _trees(5)
    s = tspec.node_grad_scalars(tcfg, from_numpy(x), from_numpy(g))
    s["lr"] = torch.tensor(0.05)
    ops = {"x": from_numpy(x), "g": from_numpy(g)}
    want = tspec.reference_stage("pre", "grad_step", ctx, ops, s, ops["x"])
    got = tfused.make_stage("triton")("pre", "grad_step", ctx, ops, s, ops["x"])
    for k in SHAPES:
        assert torch.equal(got["payload"][k], want["payload"][k])
    # a per-node (n,) staleness damping takes the kernel's SG_COL mode
    sg = torch.tensor([1.0, 0.5, 0.25, 0.5])[:N]
    post = {"x": ops["x"], "mix": from_numpy(g), "m": from_numpy(x), "g": ops["g"]}
    want = tspec.reference_stage("post", "decentlam_sa_post", ctx, post, {**s, "sg": sg},
                                 post["x"])
    got = tfused.make_stage("triton")("post", "decentlam_sa_post", ctx, post, {**s, "sg": sg},
                                      post["x"])
    for k in SHAPES:
        assert torch.equal(got["x"][k], want["x"][k])
        assert torch.equal(got["m"][k], want["m"][k])


def test_trainer_clips_each_node_by_its_own_norm():
    """The stacked trainer with pmsgd-lars + grad_clip + weight decay: its
    step equals the tail fed per-node scalars, and differs from the tail fed
    the old single norm over all nodes together."""
    cfg = tget_config("qwen3-0.6b", smoke=True)
    tc = TrainConfig(algorithm="pmsgd-lars", grad_clip=0.5, weight_decay=1e-2,
                     schedule=ScheduleConfig(kind="constant", peak_lr=0.05, total_steps=2))
    assert tc.opt_config().grad_clip == 0.5 and tc.opt_config().weight_decay == 1e-2
    step_fn, channel = build_train_step(cfg, tc, N)
    ocfg = tc.opt_config()
    state = init_train_state(cfg, topt.make_optimizer(ocfg), N, device=torch.device("cpu"),
                             channel=channel)
    x0 = tree_map(lambda a: a.clone(), state["params"])
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         per_node_batch=2, n_nodes=N, heterogeneity=0.5))
    batch = from_numpy(data.batch(0))
    grads, _ = _node_grads(x0, batch, cfg, N,
                           tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32), x0))
    state, _ = step_fn(state, batch)

    def tail(scalars):
        x, _, _ = tspec.run_update(
            tspec.update_spec(ocfg), ocfg, x=tree_map(lambda a: a.clone(), x0), g=grads,
            state=topt.make_optimizer(ocfg).init(x0), lr=0.05, step_idx=0,
            gossip=tgossip.StackedChannel(ttopo.build_topology("exp", N)),
            mean=tgossip.make_stacked_mean(N), comp_state={}, scalars=scalars)
        return x

    per_node = tail(tspec.node_grad_scalars(ocfg, x0, grads))
    all_nodes = tail(tspec.grad_scalars(ocfg, x0, grads))
    gs = tspec.node_grad_scalars(ocfg, x0, grads)["gs"]
    assert (gs < 1.0).any() and len(set(gs.tolist())) == N  # the clip bites, per node
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(per_node)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(tree_leaves(state["params"]), tree_leaves(all_nodes)))
    assert worst > 1e-4, worst
