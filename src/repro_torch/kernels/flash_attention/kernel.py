"""Build, load and launch the flash-attention CUDA kernel
(``csrc/flash_attention.cu``; its header note says what it replaces, what
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

import numpy as np
import torch

from .. import cuda_build

__all__ = [
    "HEAD_DIMS", "SOURCES", "build", "flash_attention_launch", "live_pairs", "reset_launches",
    "work",
]

HEAD_DIMS = (32, 64, 80, 128)
SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build_dir() -> Path:
    return cuda_build.default_build_dir()


def build() -> Path:
    """Compile the kernel's source into ``build/cuda/flash_attention-<hash>.so``
    unless it is built already; returns the library's path."""
    return cuda_build.build_library("flash_attention", SOURCES, _build_dir())


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.flash_attention_fwd.argtypes = (
                [ptr] * 4 + [i32] * 7 + [i64] * 12 + [i32, i32, ctypes.c_float, i32, ptr]
            )
            lib.flash_attention_fwd.restype = i32
            lib.flash_attention_error_string.argtypes = [i32]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, hd) and k = v (B, Sk, Hkv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} (same B and "
                         "hd, H a multiple of Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes hd in {HEAD_DIMS}, got {hd}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the launch grid's {_MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}; the kernel takes CUDA tensors on "
                             f"one device (q is on {q.device})")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} is {t.dtype}; want float32 or bfloat16, as q ({q.dtype})")
        # rows are read 4 elements at a time (16 B in f32, 8 B in bf16)
        if (t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: hd must be contiguous, the other strides multiples "
                             f"of 4 and the data 16-byte aligned (strides {t.stride()})")


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool, window: int) -> torch.Tensor:
    """Run the kernel on CUDA tensors q ``(B, Sq, H, hd)``, k and v
    ``(B, Sk, Hkv, hd)`` (float32 or bfloat16, read by strides); returns a new
    contiguous ``(B, Sq, H, hd)`` tensor in q's dtype.  Raises on what the
    kernel does not take and when the launch fails.  Counts its launches in
    ``flash_attention_launch.launches``."""
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    if Sk == 0:
        raise ValueError("attention over zero keys")
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], hd,
        B, H, Hkv, Sq, Sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {err} ({msg})")
    flash_attention_launch.launches += 1
    return out


def live_pairs(b: int, sq: int, sk: int, h: int, causal: bool, window: int) -> int:
    """Live (q, k) pairs of the mask over the batch and heads, counted row
    by row: query ``i`` sees keys ``[max(i - window + 1, 0), min(i + 1, Sk))``
    when causal (``[0, Sk)`` otherwise, cut by the window the same way)."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum()) * b * h


def work(q_shape, k_shape, dtype: torch.dtype, causal: bool, window: int) -> tuple[int, int]:
    """``(flops, bytes)`` of one call on q ``(B, Sq, H, hd)`` and k = v
    ``(B, Sk, Hkv, hd)``: 4 * hd operations per live pair (the scores and
    p.v, a multiply-add each), and q, k, v read once and the output written
    once.  The cost model counts a launch with this work; ``chip_smoke.py``
    bounds the kernel by it (:func:`~repro_torch.launch.roofline.kernel_bound`)."""
    b, sq, h, hd = q_shape
    sk, hkv = k_shape[1], k_shape[2]
    flops = 4 * hd * live_pairs(b, sq, sk, h, causal, window)
    nbytes = dtype.itemsize * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)
    return flops, nbytes


def reset_launches() -> None:
    """Set the launch count to 0."""
    flash_attention_launch.launches = 0


reset_launches()
