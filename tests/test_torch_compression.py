"""The port's gossip compressors against the JAX package's on the same
numpy inputs: encode, decode and ``wire_bytes``; the stateful ones over
three rounds of error feedback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch.core import compression as tcomp

# leaves of the shapes a payload carries: a matrix (rows), a plane of
# 1024-wide rows, a vector and a scalar
SHAPES = [(6, 33), (5, 1024), (257,), ()]
EXACT = ["bf16", "int8", "int8-row", "int8-row-ef"]


def _x(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), np.float32)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _msg_equal(tm, jm):
    if isinstance(jm, dict):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _msg_equal(tm[k], jm[k])
        return
    np.testing.assert_array_equal(_np(tm), _jnp(jm))
    assert str(tm.dtype).removeprefix("torch.") == np.asarray(jm).dtype.name


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("spec", EXACT)
def test_encode_decode_bitwise(spec, shape):
    """Three rounds: each message, decoded payload and residual equal the
    reference's bit for bit (a stateless compressor threads ``()``)."""
    jc, tc = jcomp.get_compressor(spec), tcomp.get_compressor(spec)
    x0 = _x(shape, 0, scale=3.0)
    jst, tst = jc.init(jnp.asarray(x0)), tc.init(torch.from_numpy(x0))
    for r in range(3):
        x = _x(shape, r + 1, scale=3.0)
        jmsg, jst = jc.encode(jnp.asarray(x), jst)
        tmsg, tst = tc.encode(torch.from_numpy(x), tst)
        _msg_equal(tmsg, jmsg)
        jdec = jc.decode(jmsg, jnp.asarray(x))
        tdec = tc.decode(tmsg, torch.from_numpy(x))
        assert tdec.dtype == torch.float32
        np.testing.assert_array_equal(_np(tdec), np.asarray(jdec))
        if isinstance(jst, tuple):
            assert tst == ()
        else:
            np.testing.assert_array_equal(_np(tst), np.asarray(jst))


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_topk_same_indices_values_and_residual(rate):
    """Tie-free data (distinct magnitudes): the same index set and values,
    and the same residual, over three rounds of error feedback."""
    jc, tc = jcomp.get_compressor(f"topk:{rate}"), tcomp.get_compressor(f"topk:{rate}")
    shape = (7, 149)
    rng = np.random.default_rng(3)
    jst, tst = jc.init(jnp.zeros(shape)), tc.init(torch.zeros(shape))
    for _ in range(3):
        mags = rng.permutation(np.prod(shape)).reshape(shape) + 1.0
        x = (mags * rng.choice([-1.0, 1.0], size=shape) / 64.0).astype(np.float32)
        jmsg, jst = jc.encode(jnp.asarray(x), jst)
        tmsg, tst = tc.encode(torch.from_numpy(x), tst)
        ji, ti = np.asarray(jmsg["i"]), tmsg["i"].numpy()
        assert ti.dtype == np.int32 and sorted(ji.tolist()) == sorted(ti.tolist())
        jv = dict(zip(ji.tolist(), np.asarray(jmsg["v"]).tolist()))
        tv = dict(zip(ti.tolist(), tmsg["v"].numpy().tolist()))
        assert jv == tv
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tc.decode(tmsg, torch.from_numpy(x)).numpy(),
                                      np.asarray(jc.decode(jmsg, jnp.asarray(x))))


@pytest.mark.parametrize("spec", [None, "none", "bf16", "int8", "int8-row", "int8-row-ef",
                                  "topk", "topk:0.01", "topk:0.25"])
@pytest.mark.parametrize("nbytes", [4.0, 4096.0, 2.65e9])
def test_wire_bytes_and_names(spec, nbytes):
    assert tcomp.wire_bytes(nbytes, spec) == jcomp.wire_bytes(nbytes, spec)
    assert tcomp.get_compressor(spec).name == jcomp.get_compressor(spec).name


def test_unknown_specs_raise():
    for bad in ("int4", "fp8"):
        with pytest.raises(ValueError):
            tcomp.get_compressor(bad)
        with pytest.raises(ValueError):
            tcomp.wire_bytes(4.0, bad)
    with pytest.raises(ValueError):
        tcomp.get_compressor("topk:1.5")
