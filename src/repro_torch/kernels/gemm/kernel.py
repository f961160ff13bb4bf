"""Build, load and launch the 3xTF32 ``wgmma`` GEMM (``csrc/gemm_tf32x3.cu``;
its header note says why it exists, what bounds it and how it is designed),
and its plain version.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (:mod:`..cuda_build`) and loaded with :mod:`ctypes`, at
the first launch (never at import): this module imports on hosts without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .. import cuda_build

__all__ = [
    "BLOCK_K", "SOURCES", "build", "gemm_launch", "gemm_plain", "operand_ok", "tf32_round", "work",
]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "gemm_tf32x3.cu",)
BLOCK_K = 32  # the k-block whose three products are summed before the f32 total

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}


def build() -> Path:
    """Compile the kernel's source into ``build/cuda/gemm_tf32x3-<hash>.so``
    unless it is built already; returns the library's path."""
    return cuda_build.build_library("gemm_tf32x3", SOURCES, cuda_build.default_build_dir())


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tf32x3_gemm.argtypes = [ptr, i64, i64, ptr, i64, i64, ptr, i64,
                                        i32, i32, i32, i32, i32, ptr]
            lib.tf32x3_gemm.restype = i32
            lib.tf32x3_gemm_error_string.argtypes = [i32]
            lib.tf32x3_gemm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def operand_ok(t: torch.Tensor) -> bool:
    """What the kernel's TMA loads take of a 2-D f32 operand: one unit stride,
    the other a multiple of 4 elements (16 bytes) and no smaller than the
    rows it steps over, and a 16-byte aligned base."""
    s0, s1 = t.stride()
    n0, n1 = t.shape
    if s1 == 1:
        ok = s0 % 4 == 0 and s0 >= n1
    elif s0 == 1:
        ok = s1 % 4 == 0 and s1 >= n0
    else:
        return False
    return ok and t.data_ptr() % 16 == 0


def gemm_launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for CUDA f32 ``a`` (M, K) and ``b`` (K, N), read by strides
    (each K- or MN-major, :func:`operand_ok`); returns a new contiguous (M, N)
    f32 tensor.  Raises on what the kernel does not take and when the launch
    fails.  Counts its launches in ``gemm_launch.launches`` (set to 0 by
    :func:`.ops.reset_counts`)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel takes float32 "
                             f"CUDA tensors on one device (a is on {a.device})")
        if not operand_ok(t):
            raise ValueError(f"{name}: one stride must be 1, the other a multiple of 4, and the "
                             f"data 16-byte aligned (strides {t.stride()}, "
                             f"address {t.data_ptr():#x})")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _load()
    err = lib.tf32x3_gemm(a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
                          b.stride(1), out.data_ptr(), N, M, N, K, sms, dev,
                          torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = lib.tf32x3_gemm_error_string(err).decode()
        raise RuntimeError(f"tf32x3 GEMM launch failed: error {err} ({msg})")
    gemm_launch.launches += 1
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's ``tf32x3::to_tf32`` on the bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: each operand split into big =
    tf32(x) and small = tf32(x - big); per k-block of :data:`BLOCK_K`, the
    cross terms small_a.big_b and big_a.small_b, then big_a.big_b, summed from
    zero and added to the f32 total (f32 products of TF32 values are exact;
    the sums round to nearest here, where the tensor cores truncate)."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], BLOCK_K):
        ks = slice(k0, k0 + BLOCK_K)
        part = a_small[:, ks] @ b_big[ks]
        part += a_big[:, ks] @ b_small[ks]
        part += a_big[:, ks] @ b_big[ks]
        total += part
    return total


def work(m: int, n: int, k: int) -> tuple[int, int]:
    """``(flops, bytes)`` of one (M, N, K) product: 2MNK (the f32 product's;
    the kernel's bound takes three TF32 products of it), A and B read once
    and C written once in f32."""
    return 2 * m * n * k, 4 * (m * k + k * n + m * n)

