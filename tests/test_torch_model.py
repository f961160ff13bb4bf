"""The port's dense LM against the JAX package: ``forward_loss`` and its
gradients in float32 from the same (JAX-initialized) parameters, plus the
layers whose conventions are easy to get wrong (half-split RoPE, the
padded-vocab cross entropy)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import tiny_lm as jtiny_lm
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import reference_fields
from repro_torch.configs import tiny_lm as ttiny_lm
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tT
from repro_torch.utils import tree_leaves, tree_paths

# summation order differs between XLA and torch: loss to ~1e-5, grads to
# ~1e-4 of each leaf's scale
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

CONFIGS = {
    "tiny-lm": (jtiny_lm(n_layers=2, vocab_size=512), ttiny_lm(n_layers=2, vocab_size=512)),
    "qwen3-0.6b-smoke": (jget_config("qwen3-0.6b", smoke=True),
                         tget_config("qwen3-0.6b", smoke=True)),
}


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_and_grads_match_jax(name):
    jcfg, tcfg = CONFIGS[name]
    assert dataclasses.asdict(jcfg) == reference_fields(tcfg)
    params = jax.device_get(jT.init_params(jax.random.key(1), jcfg))
    batch = _batch(jcfg)
    rt = jT.RuntimeConfig(dtype="float32", remat=False)

    def jloss(p, b):
        return jT.forward_loss(p, b, jcfg, jlayers.TPContext(), rt)[0]

    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(
        params, jax.tree.map(jnp.asarray, batch)
    )

    tparams = from_numpy(params)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = tT.forward_loss(tparams, from_numpy(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()

    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert float(metrics["xent"].detach()) == float(loss)
    for path, g, w in zip(tree_paths(tparams), grads, tree_leaves(jax.device_get(want_g))):
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_shapes_and_scales(name):
    """Same tree paths and shapes as the JAX init; same draw scales (the two
    RNGs never agree, so values are compared by their spread only)."""
    jcfg, tcfg = CONFIGS[name]
    want = jax.device_get(jT.init_params(jax.random.key(0), jcfg))
    got = to_numpy(tT.init_params(tcfg, torch.Generator().manual_seed(0)))
    assert tree_paths(got) == tree_paths(from_numpy(want))
    for path, a, b in zip(tree_paths(got), tree_leaves(got), tree_leaves(from_numpy(want))):
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.all(b == 0):
            assert np.all(a == 0), path
        else:
            # truncated (+-2 sigma) normal: same std within sampling noise
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.25, err_msg=path)
            # truncated at 2 sigma = 2 / 0.88 standard deviations
            assert np.abs(a).max() / b.std() < 2.5, path
    assert tT.count_params(from_numpy(want)) == sum(x.size for x in jax.tree.leaves(want))


def test_full_width_qwen3_param_count():
    """qwen3-0.6b at full width: 14 leaves, 663,548,416 parameters (counted
    from the JAX init's abstract shapes; nothing is allocated)."""
    cfg = jget_config("qwen3-0.6b")
    shapes = jax.eval_shape(lambda k: jT.init_params(k, cfg), jax.random.key(0))
    assert len(jax.tree.leaves(shapes)) == 14
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 663_548_416
    assert dataclasses.asdict(cfg) == reference_fields(tget_config("qwen3-0.6b"))


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_padded_vocab_xent_matches_jax():
    """Columns past vocab_size are masked out of the softmax, as in the
    reference (there they come from padding the vocab to the tp degree)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 40)).astype(np.float32) * 3
    logits[:, 37:] = 50.0  # padded columns would dominate if not masked
    targets = rng.integers(0, 37, 12).astype(np.int32)
    want = jlayers.softmax_xent_sharded(
        jnp.asarray(logits), jnp.asarray(targets), jlayers.TPContext(),
        vocab_size=37, vocab_padded=40,
    )
    got = tlayers.softmax_xent_sharded(torch.from_numpy(logits), torch.from_numpy(targets),
                                       vocab_size=37)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
