"""Message compression for gossip payloads.

The port carries the identity compressor only; ``bf16``, ``int8``,
``int8-row[-ef]`` and ``topk`` (``repro.core.compression``) come with a
later slice.  Asking for one of them raises, so a run never silently
gossips uncompressed payloads it was told to compress.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

Tree = Any

__all__ = ["Compressor", "get_compressor", "wire_bytes"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    init: Callable[[Any], Tree]  # leaf -> state leaf
    encode: Callable[[Any, Tree], tuple[Tree, Tree]]  # (leaf, st) -> (msg, st)
    decode: Callable[[Tree, Any], Any]  # (msg, like) -> leaf


def _identity() -> Compressor:
    return Compressor(
        name="none",
        init=lambda x: (),
        encode=lambda x, s: (x, s),
        decode=lambda m, like: m,
    )


def get_compressor(spec: str | None) -> Compressor:
    """Parse ``None | "none"``; other compressors are not ported yet."""
    if spec is None or spec == "none":
        return _identity()
    raise NotImplementedError(
        f"compressor {spec!r} is not ported yet; the port gossips uncompressed"
    )


def wire_bytes(nbytes_fp32: float, spec: str | None) -> float:
    """Analytic bytes-on-the-wire for one payload (comm-volume model)."""
    get_compressor(spec)
    return float(nbytes_fp32)
