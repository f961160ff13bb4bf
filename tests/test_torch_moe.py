"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the CPU: the layer's output and router terms for both granite
smoke configs, the routing itself (top-k with ties, the capacity drops),
the expert-hit mask, gradients against ``jax.grad``, and the combine's
summation order pinned against the reference's scatter-add."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import from_numpy
from repro_torch.models import moe as tmoe

ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
B, S = 2, 24
# f32 outputs: the two libraries' matmuls and softmax sum in other orders
RTOL = 2e-5
GRAD_RTOL = 1e-4  # of each gradient leaf's max |value|


def _case(arch, seed, **overrides):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **overrides)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **overrides)
    params = jax.device_get(jmoe.moe_init(jlayers.Initializer(jax.random.key(seed)), jcfg))
    x = np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, params, x


def _jax_forward(jcfg, params, x):
    out, aux = jax.jit(lambda p, x: jmoe.moe_forward(x, p, jcfg, jlayers.TPContext()))(
        params, jnp.asarray(x))
    return np.asarray(out), jax.device_get(aux)


def _jax_routing(jcfg, params, x):
    """The reference's routing, by its own expressions (``moe_forward`` keeps
    them inside): top-k experts per token and the kept mask."""
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xt @ jnp.asarray(params["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    C = jmoe.moe_capacity(jcfg, xt.shape[0])
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < C)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_and_router_terms_match_jax(arch):
    jcfg, tcfg, params, x = _case(arch, 0)
    want, waux = _jax_forward(jcfg, params, x)
    out, aux = tmoe.moe_forward(torch.from_numpy(x), from_numpy(params), tcfg)
    assert _rel(out, want) < RTOL
    for k in ("moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(aux["moe_expert_hits"].numpy(), waux["moe_expert_hits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_capacity_drops_match_jax(arch):
    """At capacity_factor 1.25 with skewed routing some assignments drop:
    the same top-k experts per token and the same kept/dropped set as the
    reference, the capacity rounded to a multiple of 8 with a floor of 8."""
    jcfg, tcfg, params, x = _case(arch, 1)
    params = dict(params)
    # skew the router so that the first experts overflow their capacity
    params["router"] = params["router"] + np.linspace(2.0, 0.0, jcfg.n_experts,
                                                      dtype=np.float32)[None]
    x = x + 1.0
    want_idx, want_keep = _jax_routing(jcfg, params, x)
    xt = torch.from_numpy(x).reshape(-1, tcfg.d_model)
    _, _, idx, gates = tmoe.route(xt, torch.from_numpy(params["router"]), tcfg)
    tabs = tmoe.dispatch_tables(idx, gates, tcfg)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(tabs["keep"].numpy(), want_keep)
    assert 0 < int((~tabs["keep"]).sum()) < want_keep.size  # some, not all, dropped
    assert tabs["capacity"] == jmoe.moe_capacity(jcfg, B * S)
    assert tabs["capacity"] % 8 == 0 and tabs["capacity"] >= 8
    # a dropped assignment has no slot; each kept one holds its token there
    slots = tabs["slots"].numpy()
    E, C = tcfg.n_experts, tabs["capacity"]
    table = tabs["table"].numpy()
    for t in range(B * S):
        kept = sorted(int(e) for e, k in zip(want_idx[t], want_keep[t * tcfg.top_k:
                                                                    (t + 1) * tcfg.top_k])
                      if k)
        live = [int(s) for s in slots[t] if s != E * C]
        assert [s // C for s in live] == kept  # ascending expert order
        assert all(table[s] == t for s in live)
    want, waux = _jax_forward(jcfg, params, x)
    out, aux = tmoe.moe_forward(torch.from_numpy(x), from_numpy(params), tcfg)
    assert _rel(out, want) < RTOL
    np.testing.assert_array_equal(aux["moe_expert_hits"].numpy(), waux["moe_expert_hits"])


def test_tied_router_takes_the_lower_experts():
    """All-zero router weights: every prob ties, and the reference's top_k
    takes experts 0..k-1 for every token; so does the port's stable sort."""
    arch = ARCHS[1]
    jcfg, tcfg, params, x = _case(arch, 2)
    params = {**params, "router": np.zeros_like(params["router"])}
    want_idx, want_keep = _jax_routing(jcfg, params, x)
    xt = torch.from_numpy(x).reshape(-1, tcfg.d_model)
    _, _, idx, gates = tmoe.route(xt, torch.zeros(tcfg.d_model, tcfg.n_experts), tcfg)
    np.testing.assert_array_equal(want_idx, np.tile(np.arange(tcfg.top_k), (B * S, 1)))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    tabs = tmoe.dispatch_tables(idx, gates, tcfg)
    np.testing.assert_array_equal(tabs["keep"].numpy(), want_keep)
    want, waux = _jax_forward(jcfg, params, x)
    out, aux = tmoe.moe_forward(torch.from_numpy(x), from_numpy(params), tcfg)
    assert _rel(out, want) < RTOL
    np.testing.assert_array_equal(aux["moe_expert_hits"].numpy(), waux["moe_expert_hits"])
    assert aux["moe_expert_hits"].tolist() == [1.0] * tcfg.top_k + [0.0] * (
        tcfg.n_experts - tcfg.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(arch):
    """The gradient of <out, r> + the router terms with respect to x and
    every parameter, through the dispatch and combine (whose backward passes
    are each other's forward), against ``jax.grad``."""
    jcfg, tcfg, params, x = _case(arch, 3)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_forward(x, p, jcfg, jlayers.TPContext())
        return jnp.sum(out * r) + aux["moe_load_balance"] + aux["moe_router_z"]

    wgp, wgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in from_numpy(params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_forward(tx, tp, tcfg)
    loss = torch.sum(out * torch.from_numpy(r)) + aux["moe_load_balance"] + aux["moe_router_z"]
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    wants = [np.asarray(wgx)] + [np.asarray(wgp[k]) for k in sorted(tp)]
    for name, g, w in zip(["x"] + sorted(tp), grads, wants):
        assert _rel(g, w) < GRAD_RTOL, (name, _rel(g, w))


def test_combine_sums_each_token_in_ascending_expert_order():
    """The combine equals the reference's scatter-add into (T + 1, d) f32 on
    the CPU bit for bit — updates applied in slot order, so each token's
    kept outputs summed in ascending expert order from 0.0 — on values where
    any other order rounds differently; and the same inputs give the same
    bits twice (no atomics)."""
    cfg = dataclasses.replace(tget_config(ARCHS[0], smoke=True), n_experts=4, top_k=3)
    T, d = 6, 5
    rng = np.random.default_rng(4)
    # each token's experts in a shuffled order, so the sort is exercised
    idx = np.stack([rng.permutation(cfg.n_experts)[:cfg.top_k] for _ in range(T)])
    gates = np.full((T, cfg.top_k), 1.0 / cfg.top_k, np.float32)
    tabs = tmoe.dispatch_tables(torch.from_numpy(idx), torch.from_numpy(gates), cfg)
    E, C = cfg.n_experts, tabs["capacity"]
    # magnitudes 1e8, 1 and -1e8 mixed: f32 addition is far from associative
    y = (rng.choice([1e8, 1.0, -1e8, 3.0], (E * C, d)) * rng.uniform(0.5, 1.5, (E * C, d))
         ).astype(np.float32)
    got = tmoe._Combine.apply(torch.from_numpy(y), tabs["table"], tabs["slots"]).numpy()
    table = tabs["table"].numpy()
    want = np.asarray(jnp.zeros((T + 1, d), jnp.float32).at[jnp.asarray(table)].add(
        jnp.asarray(y), mode="drop"))[:T]
    np.testing.assert_array_equal(got, want)
    # the same sum by hand, ascending expert order from 0.0
    by_hand = np.zeros((T, d), np.float32)
    for s in range(E * C):
        if table[s] < T:
            by_hand[table[s]] = by_hand[table[s]] + y[s]
    np.testing.assert_array_equal(got, by_hand)
    again = tmoe._Combine.apply(torch.from_numpy(y), tabs["table"], tabs["slots"]).numpy()
    np.testing.assert_array_equal(again, got)
