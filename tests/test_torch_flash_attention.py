"""The port's flash attention against the JAX package: the plain version
(what a CPU tensor takes) against the Pallas kernel in interpret mode and
against the jnp reference, on unexpanded (GQA) kv and ragged lengths.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.  Here: its wrapper refuses CPU tensors,
and its build raises when no ``nvcc`` is found."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import reference_attention as jref
from repro_torch.kernels.flash_attention import flash_attention, reference_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel

# the JAX package's own tolerances for its kernel (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HKV, HD = 2, 32


def _inputs(b, sq, sk, group, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.standard_normal((b, sq, HKV * group, HD)).astype(npdt)
    k = rng.standard_normal((b, sk, HKV, HD)).astype(npdt)
    v = rng.standard_normal((b, sk, HKV, HD)).astype(npdt)
    return q, k, v


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret_and_reference(causal, window, group, dtype):
    # ragged lengths (not a multiple of any block): Sq == Sk at group 1,
    # Sq < Sk at group 2; every row has a live key, where the Pallas kernel
    # and the full softmax agree
    sq, sk = (75, 75) if group == 1 else (33, 75)
    q, k, v = _inputs(2, sq, sk, group, dtype, group)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=causal, window=window)
    assert got.dtype == _torch(q).dtype and tuple(got.shape) == q.shape
    kern = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  window=window, interpret=True)
    ref = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])


def test_rows_without_live_keys_match_reference():
    """Causal, window 4, Sq = 40 > Sk = 9: rows 12.. see no key.  The full
    softmax over all-masked scores is uniform (the mean of v), and the port
    keeps that semantics (its kernel too)."""
    q, k, v = _inputs(1, 40, 9, 2, "float32", 7)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=True, window=4)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"])
    np.testing.assert_allclose(got.numpy()[0, 20], np.repeat(v[0].mean(0), 2, axis=0),
                               atol=1e-6)


def test_reference_q_offset_matches_jax():
    q, k, v = _inputs(2, 6, 20, 2, "float32", 3)
    got = reference_attention(_torch(q), _torch(k), _torch(v), causal=True, window=8,
                              q_offset=14)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=8,
                q_offset=14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.zeros(1, 8, n, 64) for n in (4, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_launch(q, k, v, causal=True, window=0)
    assert fa_kernel.flash_attention_launch.launches == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(fa_kernel, "_build_dir", lambda: tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        fa_kernel.build()
