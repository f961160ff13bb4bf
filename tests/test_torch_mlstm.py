"""The port's chunked mLSTM against the JAX package, in float32 on the CPU:
the plain version (what a CPU tensor takes) against JAX ``mlstm_chunked``,
against the Pallas kernel in interpret mode and against the sequential cell,
with and without a carried state, and the one-token decode step.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.  Here: its wrapper refuses CPU tensors and
shapes it does not take, and its build raises when no ``nvcc`` is found."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ops import mlstm as jmlstm
from repro.kernels.mlstm_chunk.ref import mlstm_chunked as jchunked
from repro.kernels.mlstm_chunk.ref import mlstm_decode_step as jdecode
from repro.kernels.mlstm_chunk.ref import mlstm_sequential as jsequential
from repro_torch.kernels.mlstm_chunk import mlstm, mlstm_chunked, mlstm_decode_step
from repro_torch.kernels.mlstm_chunk import kernel as ml_kernel
from repro_torch.kernels.mlstm_chunk.ref import (init_state, mlstm_chunk_gates,
                                                  mlstm_chunk_states, mlstm_sequential)

# the JAX package's own mLSTM tolerance (tests/test_kernels.py), f32
TOL = 2e-4
# bf16 q/k/v: both packages compute in f32 from the same bf16 inputs and
# round h to bf16 once; one bf16 ulp of h (|h| < 8 here) is 2**-5
BF16_TOL = 2e-2
# (B, H, S, dk, dv, chunk): the JAX package's MLSTM_CASES
CASES = [
    (2, 3, 128, 32, 48, 32),
    (1, 2, 256, 64, 64, 64),
    (1, 1, 64, 16, 16, 64),
]


def _inputs(B, H, S, dk, dv, seed, f_shift=2.0, i_scale=1.0, dtype=np.float32):
    """q, k, v ~ N(0, 1); input gates N(0, i_scale^2); forget gates
    f_shift + N(0, 1) (the JAX package's test uses 2 + N(0, 1))."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(dtype)
    k = r.standard_normal((B, H, S, dk)).astype(dtype)
    v = r.standard_normal((B, H, S, dv)).astype(dtype)
    i = (i_scale * r.standard_normal((B, H, S))).astype(np.float32)
    f = (f_shift + r.standard_normal((B, H, S))).astype(np.float32)
    return q, k, v, i, f


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want, tol=TOL):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=tol, rtol=0)


def _close_state(got, want, tol=TOL):
    for name in ("C", "n", "m"):
        _close(got[name], want[name], tol)


@pytest.mark.parametrize("case", CASES)
def test_plain_chunked_matches_jax_pallas_and_sequential(case):
    B, H, S, dk, dv, chunk = case
    arrs = _inputs(B, H, S, dk, dv, seed=S + dk)
    h, st = mlstm_chunked(*map(_torch, arrs), chunk=chunk)
    assert h.shape == (B, H, S, dv) and h.dtype == torch.float32
    jin = [jnp.asarray(a) for a in arrs]
    for want_h, want_st in (jchunked(*jin, chunk=chunk),
                            jmlstm(*jin, chunk=chunk, impl="pallas_interpret"),
                            jsequential(*jin)):
        _close(h, want_h)
        _close_state(st, want_st)
    h_seq, st_seq = mlstm_sequential(*map(_torch, arrs))
    _close(h, h_seq.numpy())
    _close_state(st, {n: t.numpy() for n, t in st_seq.items()})


@pytest.mark.parametrize("case", CASES[:2])
def test_plain_chunked_with_state_matches_jax(case):
    """A carried state in (as prefill after a first segment, or decode)."""
    B, H, S, dk, dv, chunk = case
    arrs = _inputs(B, H, S, dk, dv, seed=7)
    r = np.random.default_rng(8)
    state = {"C": r.standard_normal((B, H, dk, dv)).astype(np.float32),
             "n": np.abs(r.standard_normal((B, H, dk))).astype(np.float32),
             "m": r.standard_normal((B, H)).astype(np.float32)}
    h, st = mlstm_chunked(*map(_torch, arrs), state={n: _torch(a) for n, a in state.items()},
                          chunk=chunk)
    want_h, want_st = jchunked(*map(jnp.asarray, arrs),
                               state={n: jnp.asarray(a) for n, a in state.items()}, chunk=chunk)
    _close(h, want_h)
    _close_state(st, want_st)


# (B, H, S, dk, dv, chunk, f_shift, i_scale): the reference's gates at chunk
# 32, and the stress gates at chunk 20 (not a multiple of 16: the kernel's
# 16-row mma tiles mask the ragged chunk)
PASS_CASES = [(2, 3, 128, 32, 48, 32, 2.0, 1.0), (1, 2, 120, 16, 32, 20, -4.0, 6.0)]


@pytest.mark.parametrize("case", PASS_CASES)
def test_plain_passes_match_jax_chunked_states(case):
    """The plain gate scan and chunk-state recurrence (the CUDA kernel's
    first two passes): the state after chunk c is JAX ``mlstm_chunked``'s
    final state over the first c + 1 chunks, M is its m, and the last state
    is this package's ``mlstm_chunked`` final state, bit for bit."""
    B, H, S, dk, dv, chunk, f_shift, i_scale = case
    arrs = _inputs(B, H, S, dk, dv, seed=S + chunk, f_shift=f_shift, i_scale=i_scale)
    q, k, v, i, f = map(_torch, arrs)
    nc = S // chunk
    gates = mlstm_chunk_gates(i, f, chunk=chunk)
    states = mlstm_chunk_states(k, v, i, f, chunk=chunk)
    for key in ("b", "m_t", "inter", "k_scale"):
        assert gates[key].shape == (B, H, S) and gates[key].dtype == torch.float32
    assert gates["old"].shape == gates["M"].shape == (B, H, nc)
    assert states["C"].shape == (B, H, nc, dk, dv) and states["n"].shape == (B, H, nc, dk)
    # b restarts at every chunk; the key scales and old are at most 1
    first = torch.nn.functional.logsigmoid(f[:, :, ::chunk])
    assert torch.equal(gates["b"][:, :, ::chunk], first)
    assert float(gates["k_scale"].max()) <= 1.0 and float(gates["old"].max()) <= 1.0
    for c in range(nc):
        end = (c + 1) * chunk
        _, jst = jchunked(*(jnp.asarray(a[:, :, :end]) for a in arrs), chunk=chunk)
        _close(states["C"][:, :, c], jst["C"])
        _close(states["n"][:, :, c], jst["n"])
        _close(gates["M"][:, :, c], jst["m"])
    _, st = mlstm_chunked(q, k, v, i, f, chunk=chunk)
    assert torch.equal(states["C"][:, :, -1], st["C"])
    assert torch.equal(states["n"][:, :, -1], st["n"])
    assert torch.equal(gates["M"][:, :, -1], st["m"])


def test_stabilizer_regime_matches_sequential():
    """Strongly negative forget pre-activations (-4 + N(0, 1)) and large input
    gates (N(0, 36)), so the stabilizer m jumps with the input gate: the
    chunked form equals the cell step by step, in both packages."""
    arrs = _inputs(1, 2, 128, 32, 32, seed=11, f_shift=-4.0, i_scale=6.0)
    h, st = mlstm_chunked(*map(_torch, arrs), chunk=32)
    h_seq, st_seq = mlstm_sequential(*map(_torch, arrs))
    jh, jst = jsequential(*map(jnp.asarray, arrs))
    scale = max(1.0, float(np.abs(np.asarray(jh)).max()))
    for got_h, got_st in ((h, st), (h_seq, st_seq)):
        _close(got_h, jh, TOL * scale)
        _close_state(got_st, jst)
    assert float(st["m"].abs().max()) > 1.0  # the stabilizer left its zero start


@pytest.mark.parametrize("f_shift, i_scale", [(2.0, 1.0), (-4.0, 6.0)])
def test_plain_float64_witness(f_shift, i_scale):
    """Float64 inputs run the plain version in float64 (the witness
    ``chip_smoke.py`` holds the kernel and the f32 plain version against):
    chunked == sequential to 1e-10 of scale, and both f32 forms of the cell
    (this package's and JAX's sequential) lie within TOL of it."""
    arrs = _inputs(1, 2, 128, 32, 32, seed=12, f_shift=f_shift, i_scale=i_scale)
    wide = [torch.from_numpy(a.astype(np.float64)) for a in arrs]
    h, st = mlstm_chunked(*wide, chunk=32)
    h_seq, st_seq = mlstm_sequential(*wide)
    assert h.dtype == torch.float64 and all(t.dtype == torch.float64 for t in st.values())
    for got, want in ((h, h_seq), *((st[n], st_seq[n]) for n in ("C", "n", "m"))):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-10 * scale
    scale = max(1.0, float(h.abs().max()))
    h32, st32 = mlstm_chunked(*map(_torch, arrs), chunk=32)
    jh, jst = jsequential(*map(jnp.asarray, arrs))
    for got_h, got_st in ((h32, st32), (jh, jst)):
        _close(h.numpy(), got_h, TOL * scale)
        _close_state({n: t.numpy() for n, t in st.items()}, got_st)


def test_plain_chunked_bf16_matches_jax():
    B, H, S, dk, dv, chunk = CASES[0]
    arrs = list(_inputs(B, H, S, dk, dv, seed=3))
    for j in range(3):
        arrs[j] = arrs[j].astype(ml_dtypes.bfloat16)
    h, st = mlstm_chunked(*map(_torch, arrs), chunk=chunk)
    want_h, want_st = jchunked(*map(jnp.asarray, arrs), chunk=chunk)
    assert h.dtype == torch.bfloat16
    _close(h, want_h, BF16_TOL)
    _close_state(st, want_st)


def test_decode_step_matches_jax():
    B, H, dk, dv = 2, 3, 32, 48
    r = np.random.default_rng(5)
    q, k = (r.standard_normal((B, H, dk)).astype(np.float32) for _ in range(2))
    v = r.standard_normal((B, H, dv)).astype(np.float32)
    i, f = r.standard_normal((B, H)).astype(np.float32), (2 + r.standard_normal((B, H))).astype(
        np.float32)
    state = {"C": r.standard_normal((B, H, dk, dv)).astype(np.float32),
             "n": np.abs(r.standard_normal((B, H, dk))).astype(np.float32),
             "m": r.standard_normal((B, H)).astype(np.float32)}
    h, st = mlstm_decode_step(*map(_torch, (q, k, v, i, f)),
                              {n: _torch(a) for n, a in state.items()})
    want_h, want_st = jdecode(*map(jnp.asarray, (q, k, v, i, f)),
                              {n: jnp.asarray(a) for n, a in state.items()})
    assert h.shape == (B, H, dv)
    _close(h, want_h)
    _close_state(st, want_st)
    zero = init_state(B, H, dk, dv)
    assert all(t.shape == state[n].shape and not t.any() for n, t in zero.items())


def test_ops_mlstm_takes_min_chunk_and_refuses_ragged_lengths():
    arrs = [_torch(a) for a in _inputs(1, 2, 48, 16, 16, seed=2)]
    h, st = mlstm(*arrs, chunk=128)  # chunk = min(128, 48) = 48
    want_h, want_st = jchunked(*(jnp.asarray(a.numpy()) for a in arrs), chunk=48)
    _close(h, want_h)
    _close_state(st, want_st)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mlstm(*arrs, chunk=32)  # 48 % 32 != 0
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mlstm_chunked(*arrs, chunk=32)


def test_kernel_wrapper_refuses_cpu_tensors_and_unsupported_shapes():
    B, H, S = 1, 2, 64

    def args(dk=64, dv=64):
        return (torch.zeros(B, H, S, dk), torch.zeros(B, H, S, dk), torch.zeros(B, H, S, dv),
                torch.zeros(B, H, S), torch.zeros(B, H, S))

    with pytest.raises(ValueError, match="CUDA"):
        ml_kernel.mlstm_chunk_launch(*args(), chunk=64)
    with pytest.raises(ValueError, match="multiples of 16"):
        ml_kernel.mlstm_chunk_launch(*args(dk=24), chunk=64)
    with pytest.raises(ValueError, match="dk in 16"):
        ml_kernel.mlstm_chunk_launch(*args(dk=1024), chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ml_kernel.mlstm_chunk_launch(*args(), chunk=256)
    with pytest.raises(ValueError, match="chunk"):
        ml_kernel.mlstm_chunk_launch(*args(), chunk=48)
    q, k, v, i, f = args()
    with pytest.raises(ValueError, match="float32"):
        ml_kernel.mlstm_chunk_launch(q, k, v, i.double(), f, chunk=64)
    assert ml_kernel.mlstm_chunk_launch.launches == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ml_kernel, "_build_dir", lambda: tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        ml_kernel.build()
