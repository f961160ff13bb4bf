"""ResNet-20 in the port against the JAX package, on the CPU: the parameter
tree (HWIO weights, NHWC images, as in the reference), logits, loss,
accuracy and gradients from the same parameters and images, XLA's "SAME"
padding at stride 2 pinned on its own, group norm, the reference's
overfit test, and 4 nodes of DecentLaM through ``run_stacked``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.models import resnet_cifar as jR
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.models import resnet_cifar as tR
from repro_torch.utils import tree_leaves, tree_map, tree_paths, tree_unflatten

# logits, loss and each gradient leaf, of their max |value|: XLA's and
# torch's convolutions sum the same f32 products in their own orders
RTOL = 1e-4
# ten plain SGD steps (lr 0.05) amplify those differences
SGD_RTOL = 1e-3
N_NODES, PER_NODE = 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.device_get(jR.resnet20_init(jax.random.key(0)))


def _data(seed, b=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (b,)).astype(np.int32)
    return x, y


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _paths(tree):
    return [("/".join(str(k.key) for k in p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def test_param_tree_matches_jax():
    """Same paths, shapes (HWIO convs, projections only where a block
    changes width or stride) and count: 272,272 with a 10-class head."""
    want = jax.tree.map(lambda s: tuple(s.shape),
                        jax.eval_shape(lambda k: jR.resnet20_init(k), jax.random.key(0)))
    tp = tR.resnet20_init(torch.Generator().manual_seed(0))
    assert tree_map(lambda t: tuple(t.shape), tp) == want
    assert sum(t.numel() for t in tree_leaves(tp)) == sum(
        int(np.prod(s)) for s in jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)))
    assert sum(t.numel() for t in tree_leaves(tp)) == 272_272
    assert tp["stem_gn"]["scale"].eq(1).all() and tp["stem_gn"]["bias"].eq(0).all()
    assert "proj" in tp["s1b0"] and "proj" not in tp["s1b1"] and "proj" not in tp["s0b0"]


def test_logits_loss_accuracy_and_grads_match_jax():
    params = _params()
    x, y = _data(0)
    want_logits = np.asarray(jR.resnet20_apply(params, jnp.asarray(x)))
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(jR.resnet20_loss, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(y))
    tp = from_numpy(params)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    logits = tR.resnet20_apply(tp, torch.from_numpy(x))
    assert tuple(logits.shape) == (8, 10)
    assert _rel(logits.detach(), want_logits) < RTOL
    loss, m = tR.resnet20_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert _rel(loss.detach(), want_loss) < RTOL
    assert float(m["accuracy"]) == float(want_m["accuracy"])
    grads = torch.autograd.grad(loss, leaves)
    for (path, w), g in zip(_paths(want_g), grads):
        assert _rel(g, w) < RTOL, path


@pytest.mark.parametrize("size,k,stride", [(32, 3, 1), (32, 3, 2), (16, 3, 2), (7, 3, 2),
                                           (32, 1, 2), (16, 1, 2), (8, 1, 1)])
def test_same_padding_is_xlas(size, k, stride):
    """``_conv`` pads as XLA's "SAME": at stride 2 a 3x3 conv over an even
    size pads (0, 1), one 1x1 pads nothing; torch's symmetric padding=1
    would shift every output of the stride-2 3x3 conv by a pixel."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tR._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape == (2, -(-size // stride), -(-size // stride), 5)
    assert _rel(got, want) < 1e-6
    if k == 3 and stride == 2 and size % 2 == 0:
        assert tR._same_pads(size, k, stride) == (0, 1)
        sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                         torch.from_numpy(w).permute(3, 2, 0, 1),
                                         stride=stride, padding=1).permute(0, 2, 3, 1)
        assert _rel(sym, want) > 0.1


def test_group_norm_matches_jax():
    """``min(8, c)`` groups, population variance in f32, eps 1e-5, then the
    per-channel scale and bias."""
    rng = np.random.default_rng(1)
    for c in (3, 16, 64):
        x = (3.0 + 2.0 * rng.standard_normal((2, 5, 5, c))).astype(np.float32)
        gp = {"scale": rng.standard_normal(c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
        want = np.asarray(jR._gn(jnp.asarray(x), jax.tree.map(jnp.asarray, gp)))
        got = tR._gn(torch.from_numpy(x), from_numpy(gp))
        assert _rel(got, want) < 1e-6


def test_overfits_the_fixed_batch():
    """The reference's test (tests/test_elastic_and_resnet.py): plain SGD
    at lr 0.05 on one fixed batch of 8 lowers the loss within 9 steps; the
    trajectory beside the reference's from the same parameters."""
    x, y = _data(0)

    @jax.jit
    def jstep(p):
        (loss, _), g = jax.value_and_grad(jR.resnet20_loss, has_aux=True)(
            p, jnp.asarray(x), jnp.asarray(y))
        return loss, jax.tree.map(lambda a, b: a - 0.05 * b, p, g)

    jp, want = _params(), []
    for _ in range(9):
        loss, jp = jstep(jp)
        want.append(float(loss))
    tp, got = from_numpy(_params()), []
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(9):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
        tp = tree_unflatten(tp, leaves)
        loss, _ = tR.resnet20_loss(tp, xt, yt)
        grads = torch.autograd.grad(loss, leaves)
        tp = tree_unflatten(tp, [a.detach() - 0.05 * g for a, g in zip(leaves, grads)])
        got.append(float(loss.detach()))
    assert got[-1] < got[0]
    assert _rel(got, want) < SGD_RTOL


def _port_grad_fn(images, labels, n, dtype=torch.float32):
    """Per-node gradients of the mean cross entropy, node i on rows
    [i * b, (i + 1) * b) of the images, computed in ``dtype`` and returned
    in f32."""
    b = images.shape[0] // n

    def grad_fn(params, _step):
        out = []
        for i in range(n):
            leaves = [t[i].detach().to(dtype).requires_grad_() for t in tree_leaves(params)]
            loss, _ = tR.resnet20_loss(tree_unflatten(params, leaves),
                                       images[i * b:(i + 1) * b].to(dtype),
                                       labels[i * b:(i + 1) * b])
            out.append(torch.autograd.grad(loss, leaves))
        return tree_unflatten(params, [torch.stack(g).to(torch.float32) for g in zip(*out)])

    return grad_fn


def _stacked_run_inputs():
    x, y = _data(2, N_NODES * PER_NODE)
    stacked = jax.tree.map(lambda a: np.broadcast_to(a[None], (N_NODES,) + a.shape).copy(),
                           _params())
    return x, y, stacked


# the reference's f32 gradient of node 2's four images (seed 2) stands 2.6e-3
# of its leaf's max |value| off a float64 run (the forward agrees to 1.5e-7;
# the other nodes' gradients to 5e-6), where the port's stands 1.4e-6 off: the
# port is held to a float64 run tightly and to the reference at this bound
REF_GRAD_RTOL = 5e-3
F64_RTOL = 1e-5


def test_per_node_gradients_match_a_float64_run_and_the_reference():
    x, y, stacked = _stacked_run_inputs()
    params = from_numpy(stacked)
    got = _port_grad_fn(torch.from_numpy(x), torch.from_numpy(y), N_NODES)(params, 0)
    f64 = _port_grad_fn(torch.from_numpy(x), torch.from_numpy(y), N_NODES,
                        torch.float64)(params, 0)
    jgrad = jax.vmap(jax.grad(lambda p, a, b: jR.resnet20_loss(p, a, b)[0]))
    want = jgrad(jax.tree.map(jnp.asarray, stacked),
                 jnp.asarray(x.reshape(N_NODES, PER_NODE, 32, 32, 3)),
                 jnp.asarray(y.reshape(N_NODES, PER_NODE)))
    for (path, w), g, g64 in zip(_paths(want), tree_leaves(got), tree_leaves(f64)):
        for i in range(N_NODES):
            assert _rel(g[i], g64[i]) < F64_RTOL, (path, i)
            assert _rel(g[i], w[i]) < REF_GRAD_RTOL, (path, i)


def test_decentlam_through_run_stacked():
    """4 nodes of DecentLaM on exp through the stacked oracle, each node on
    its own 4 images, 2 steps at lr 0.05: the final parameters against the
    same run on float64 gradients (tightly), and against the reference's
    run_stacked with the vmapped gradient (whose node-2 gradient drifts,
    above); the run equals its repeat bit for bit.  (At a third step the
    f32 and float64 runs part by 7e-4: parameters 1e-6 apart put an
    activation on the other side of a ReLU's kink, so the comparison stops
    at 2.)"""
    x, y, stacked = _stacked_run_inputs()
    jx = jnp.asarray(x.reshape(N_NODES, PER_NODE, 32, 32, 3))
    jy = jnp.asarray(y.reshape(N_NODES, PER_NODE))
    jgrad = jax.vmap(jax.grad(lambda p, a, b: jR.resnet20_loss(p, a, b)[0]))
    jopt = jcore.make_optimizer(jcore.OptimizerConfig(algorithm="decentlam", momentum=0.9))
    want, _, _ = jcore.run_stacked(jopt, jcore.build_topology("exp", N_NODES),
                                   jax.tree.map(jnp.asarray, stacked),
                                   lambda p, _s: jgrad(p, jx, jy), lr=0.05, n_steps=2)
    topt = tcore.make_optimizer(tcore.OptimizerConfig(algorithm="decentlam", momentum=0.9))

    def run(dtype):
        grad_fn = _port_grad_fn(torch.from_numpy(x), torch.from_numpy(y), N_NODES, dtype)
        return tcore.run_stacked(topt, tcore.build_topology("exp", N_NODES),
                                 from_numpy(stacked), grad_fn, lr=0.05, n_steps=2)[0]

    got, again, f64 = run(torch.float32), run(torch.float32), run(torch.float64)
    assert tree_paths(to_numpy(got)) == [p for p, _ in _paths(want)]
    for (path, w), g, g64 in zip(_paths(want), tree_leaves(got), tree_leaves(f64)):
        assert _rel(g, g64) < F64_RTOL, path
        assert _rel(g, w) < REF_GRAD_RTOL, path
    for a, b in zip(tree_leaves(got), tree_leaves(again)):
        assert torch.equal(a, b)
