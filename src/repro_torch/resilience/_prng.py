"""The counter hash that ``repro``'s fault schedules draw from.

``repro.resilience.chaos`` draws its fires and its per-entry masks with
``jax.random``: the threefry2x32 hash in the partitionable layout
(``jax_threefry_partitionable``, on by default in the jax releases that
``repro`` runs on).  A port run replays the same faults only if it draws the
same bits, so this module keeps its own copy of the hash:

* :func:`prng_key`, :func:`fold_in` and :func:`bernoulli` on the host, in
  numpy ``uint32`` (the ``(n,)`` fire vectors);
* :func:`bernoulli_torch`, the same draw over a large shape in int64 torch
  ops on any device, a chunk at a time (the per-entry masks of
  ``BitCorrupt`` and ``NaNInject``).

The layout: a key is a pair of uint32 ``(k1, k2)``; ``prng_key(seed)`` is
``(0, seed)``; ``fold_in(key, d)`` hashes the counts ``(0, d)``; the bits
of a shape hash the counts ``(0, i)`` of each flat index ``i`` and xor the
two output words; ``uniform`` puts the bits' top 23 in the mantissa of a
float in [1, 2) and subtracts 1; ``bernoulli(p)`` is ``uniform < p`` in
float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prng_key", "fold_in", "bernoulli", "bernoulli_torch"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# int64 elements per chunk of a device draw (each temporary 64 MiB)
_CHUNK = 1 << 23


def _threefry_np(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """threefry2x32 (20 rounds) of the count pairs ``(x0, x1)``, uint32."""
    ks = [np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA)]
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, int(seed))


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    with np.errstate(over="ignore"):
        a, b = _threefry_np(key[0], key[1], np.zeros(1, np.uint32),
                            np.asarray([int(data) & _M32], np.uint32))
    return (int(a[0]), int(b[0]))


def _bits_np(key: tuple[int, int], size: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        a, b = _threefry_np(key[0], key[1], np.zeros(size, np.uint32),
                            np.arange(size, dtype=np.uint32))
    return a ^ b


def bernoulli(key: tuple[int, int], p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` as a numpy bool array."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    u = ((_bits_np(key, size) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return ((u - np.float32(1.0)) < np.float32(p)).reshape(shape)


def _threefry_torch(k1: int, k2: int, x1: torch.Tensor) -> torch.Tensor:
    """The xor of threefry2x32's two words at counts ``(0, x1)``: int64
    tensors holding uint32 values."""
    ks = [k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32]
    a = torch.full_like(x1, ks[0])
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a ^ b


def bernoulli_torch(key: tuple[int, int], p: float, shape, device) -> torch.Tensor:
    """:func:`bernoulli` over ``shape`` as a bool tensor on ``device``,
    drawn a chunk of flat indices at a time (the layout is positional, so a
    chunk's bits do not depend on the others)."""
    shape = tuple(int(d) for d in shape)
    size = 1
    for d in shape:
        size *= d
    if size >= 1 << 32:
        raise ValueError("draws of 2**32 entries or more have a second count word")
    out = torch.empty(size, dtype=torch.bool, device=device)
    thresh = float(np.float32(p))
    for lo in range(0, size, _CHUNK):
        hi = min(size, lo + _CHUNK)
        bits = _threefry_torch(key[0], key[1],
                               torch.arange(lo, hi, dtype=torch.int64, device=device))
        u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        torch.lt(u, thresh, out=out[lo:hi])
    return out.reshape(shape)
