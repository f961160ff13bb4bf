"""Build, load and launch the chunked-mLSTM CUDA kernel
(``csrc/mlstm_chunk.cu``; its header note says what it replaces, what
bounds it and how it is designed).

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (:mod:`..cuda_build`) and loaded with :mod:`ctypes`, at
the first launch (never at import): this module imports on hosts without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from .. import cuda_build

__all__ = ["MAX_CHUNK", "SOURCES", "build", "mlstm_chunk_launch", "recurrent_flops",
           "reset_launches", "work"]

MAX_CHUNK = 128  # rows per chunk the kernel's shared-memory tiles hold
MAX_DK = 576  # the largest dk whose carried n the outputs pass holds in shared memory
SOURCES = (Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build_dir() -> Path:
    return cuda_build.default_build_dir()


def build() -> Path:
    """Compile the kernel's source into ``build/cuda/mlstm_chunk-<hash>.so``
    unless it is built already; returns the library's path."""
    return cuda_build.build_library("mlstm_chunk", SOURCES, _build_dir())


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mlstm_chunk_fwd.argtypes = (
                [ptr] * 10 + [i32] * 7 + [i64] * 15 + [ctypes.c_float, i32, ptr]
            )
            lib.mlstm_chunk_fwd.restype = i32
            lib.mlstm_chunk_scratch_layout.argtypes = [i32] * 6 + [ctypes.POINTER(i64)]
            lib.mlstm_chunk_scratch_layout.restype = i64
            lib.mlstm_chunk_max_dk.restype = i32
            lib.mlstm_chunk_error_string.argtypes = [i32]
            lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
            if lib.mlstm_chunk_max_dk() != MAX_DK:
                raise RuntimeError(f"the built kernel takes dk <= {lib.mlstm_chunk_max_dk()}, "
                                   f"the launcher checks dk <= {MAX_DK}")
            _lib = lib
    return _lib


def _check(q, k, v, i_raw, f_raw, chunk: int) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"want q, k (B, H, S, dk) and v (B, H, S, dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, dk = q.shape
    dv = v.shape[3]
    for name, g in (("i_raw", i_raw), ("f_raw", f_raw)):
        if g.shape != (B, H, S) or g.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (B, H, S) = {(B, H, S)}, got "
                             f"{g.dtype} {tuple(g.shape)}")
    if dk % 16 or dv % 16 or not 16 <= dk <= MAX_DK or dv < 16:
        raise ValueError(f"the mlstm_chunk kernel takes dk in 16..{MAX_DK} and dv >= 16, both "
                         f"multiples of 16; got dk {dk}, dv {dv}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"the mlstm_chunk kernel takes a chunk in 1..{MAX_CHUNK} that divides "
                         f"S = {S}; got {chunk}")
    if B * H * S >= 2**31:
        raise ValueError(f"B * H * S = {B * H * S} is too large for the launch grids")
    for name, t in (("q", q), ("k", k), ("v", v), ("i_raw", i_raw), ("f_raw", f_raw)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}; the kernel takes CUDA tensors on "
                             f"one device (q is on {q.device})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} is {t.dtype}; want float32 or bfloat16, as q ({q.dtype})")
        # rows are read 4 elements at a time (16 B in f32, 8 B in bf16)
        if (t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % (4 * t.element_size())):
            raise ValueError(f"{name}: the last dim must be contiguous, the other strides "
                             f"multiples of 4 and the data aligned to 4 elements "
                             f"(strides {t.stride()})")


def _scratch(lib, B, H, S, dk, dv, chunk, device):
    """The float32 scratch of one call, and its regions as views: the gate
    scan's "b", "m_t", "inter", "k_scale" (B, H, S) and "old" (B, H, NC); the
    states entering chunks 1..NC-1, "C" (B, H, NC - 1, dk, dv) and "n"
    (B, H, NC - 1, dk).  The library lays it out
    (``mlstm_chunk_scratch_layout``: each region 256-byte aligned)."""
    nc = S // chunk
    off = (ctypes.c_longlong * 7)()
    total = lib.mlstm_chunk_scratch_layout(B, H, S, dk, dv, chunk, off)
    scratch = torch.empty(total, dtype=torch.float32, device=device)
    shapes = {"b": (B, H, S), "m_t": (B, H, S), "inter": (B, H, S), "k_scale": (B, H, S),
              "old": (B, H, nc), "C": (B, H, nc - 1, dk, dv), "n": (B, H, nc - 1, dk)}
    views = {}
    for o, (key, shape) in zip(off, shapes.items()):
        views[key] = scratch[o:o + math.prod(shape)].view(shape)
    return scratch, views


def mlstm_chunk_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_raw: torch.Tensor, f_raw: torch.Tensor, *, chunk: int,
                       passes: bool = False):
    """Run the kernel on CUDA tensors q, k ``(B, H, S, dk)`` and v
    ``(B, H, S, dv)`` (float32 or bfloat16, read by strides) with float32
    gates ``(B, H, S)``, from a zero state.  Returns ``h`` ``(B, H, S, dv)``
    in v's dtype and the final ``C`` ``(B, H, dk, dv)``, ``n`` ``(B, H, dk)``
    and ``m`` ``(B, H)`` in float32, all new and contiguous; with
    ``passes``, also the gate scan's and the states pass's results
    (:func:`_scratch`), to hold each pass against its plain version.  The
    three launches share one float32 scratch of about
    ``B*H*(4*S + NC + (NC - 1)*(dk*dv + dk))`` elements, NC = S / chunk.
    Raises on what the kernel does not take and when a launch fails.  Counts
    its calls in ``mlstm_chunk_launch.launches``."""
    _check(q, k, v, i_raw, f_raw, chunk)
    B, H, S, dk = q.shape
    dv = v.shape[3]
    dev = q.device
    h = torch.empty((B, H, S, dv), dtype=v.dtype, device=dev)
    C = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, dk), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _load()
    scratch, views = _scratch(lib, B, H, S, dk, dv, chunk, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mlstm_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(), f_raw.data_ptr(),
        h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), scratch.data_ptr(),
        _DTYPES[q.dtype], B, H, S, dk, dv, chunk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *i_raw.stride(), *f_raw.stride(), 1.0 / math.sqrt(dk),
        dev.index if dev.index is not None else torch.cuda.current_device(), stream,
    )
    if err != 0:
        msg = lib.mlstm_chunk_error_string(err).decode()
        raise RuntimeError(f"mlstm_chunk kernel launch failed: CUDA error {err} ({msg})")
    mlstm_chunk_launch.launches += 1
    state = {"C": C, "n": n, "m": m}
    if passes:
        return h, state, views
    return h, state


def work(q_shape, v_shape, dtype: torch.dtype, chunk: int) -> tuple[int, int]:
    """``(flops, bytes)`` of one call on q, k ``(B, H, S, dk)`` and v
    ``(B, H, S, dv)``.  Multiply-adds per (batch, head) and chunk of L rows:
    the causal lower triangle of the scores and of w.v, L(L+1)/2 * (dk +
    dv), + 2*L*dk*dv (q.C and the state update) + L*dk (q.n); each of q, k,
    v, h and the two f32 gates moved once, the final f32 C, n and m written
    once.  The cost model counts a launch with this work; ``chip_smoke.py``
    bounds the kernel by it."""
    B, H, S, dk = q_shape
    dv = v_shape[-1]
    L = chunk
    macs = B * H * (S // L) * (L * (L + 1) // 2 * (dk + dv) + 2 * L * dk * dv + L * dk)
    nbytes = (dtype.itemsize * B * H * S * (2 * dk + 2 * dv) + 4 * 2 * B * H * S
              + 4 * B * H * (dk * dv + dk + 1))
    return 2 * macs, nbytes


def recurrent_flops(q_shape, v_shape) -> int:
    """The recurrent form's operations: 2*S*dk*dv multiply-adds per (batch,
    head), C updated and read once per token: the least work the cell can
    be done in."""
    B, H, S, dk = q_shape
    return 2 * 2 * B * H * S * dk * v_shape[-1]


def reset_launches() -> None:
    """Set the launch count to 0."""
    mlstm_chunk_launch.launches = 0


reset_launches()
