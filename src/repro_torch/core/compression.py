"""Message compression for gossip payloads (the port of
``repro.core.compression``).

* ``bf16``        — stateless downcast (2x fewer bytes, f32 accumulation).
* ``int8``        — stateless per-tensor absmax quantization (4x).
* ``int8-row``    — stateless per-*row* absmax quantization: one scale per
  leading-axis row (on a plane payload, one per ``LANES``-wide plane row,
  which belongs to exactly one leaf).
* ``int8-row-ef`` — the same quantizer with an error-feedback residual,
  re-injected next round.
* ``topk:<rate>`` — top-k magnitude sparsification with error feedback
  (Stich et al.).

A compressor is a triple of plain functions on one node's payload; state
(a residual, or ``()``) is threaded through the gossip channel.  They are
plain torch, as the reference computes them in plain ``jnp`` outside any
kernel, and keep its arithmetic order: the absmax scale is
``max(amax, 1e-12) / 127``, quantizing is ``round(x / scale)`` with ties
to even (``torch.round``, as ``jnp.round``) clipped to +-127, and the
error feedback is ``x32 + err`` then ``x32 - decoded``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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


def _bf16() -> Compressor:
    return Compressor(
        name="bf16",
        init=lambda x: (),
        encode=lambda x, s: (x.to(torch.bfloat16), s),
        decode=lambda m, like: m.to(like.dtype),
    )


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequantize(m: dict, like) -> torch.Tensor:
    return (m["q"].to(torch.float32) * m["scale"]).to(like.dtype)


def _int8() -> Compressor:
    def encode(x, s):
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
        return {"q": _quantize(x, scale), "scale": scale.to(torch.float32)}, s

    return Compressor(name="int8", init=lambda x: (), encode=encode, decode=_dequantize)


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax scale: one per leading-axis row for ndim >= 2 (shape
    ``x.shape[:1] + (1,) * rest``), the per-tensor scale for 1-D and 0-d
    leaves."""
    if x.ndim >= 2:
        amax = torch.amax(torch.abs(x), dim=tuple(range(1, x.ndim)), keepdim=True)
    else:
        amax = torch.max(torch.abs(x))
    return torch.clamp(amax, min=1e-12) / 127.0


def _int8_row() -> Compressor:
    def encode(x, s):
        scale = _row_scale(x)
        return {"q": _quantize(x, scale), "scale": scale.to(torch.float32)}, s

    return Compressor(name="int8-row", init=lambda x: (), encode=encode, decode=_dequantize)


def _residual(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _int8_row_ef() -> Compressor:
    base = _int8_row()

    def encode(x, err):
        x32 = x.to(torch.float32) + err
        msg, _ = base.encode(x32, ())
        decoded = msg["q"].to(torch.float32) * msg["scale"]
        return msg, x32 - decoded

    return Compressor(name="int8-row-ef", init=_residual, encode=encode, decode=base.decode)


def _topk(rate: float) -> Compressor:
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"topk rate {rate} is not in (0, 1]")

    def encode(x, err):
        flat = x.to(torch.float32).reshape(-1) + err.reshape(-1)
        k = max(1, int(rate * flat.numel()))
        _, idx = torch.topk(torch.abs(flat), k)
        sel = flat[idx]
        decoded = torch.zeros_like(flat).index_put_((idx,), sel)
        new_err = (flat - decoded).reshape(x.shape)
        return {"v": sel, "i": idx.to(torch.int32)}, new_err

    def decode(m, like):
        flat = torch.zeros(like.numel(), dtype=torch.float32, device=m["v"].device)
        flat[m["i"].to(torch.int64)] = m["v"]
        return flat.reshape(like.shape).to(like.dtype)

    return Compressor(name=f"topk{rate}", init=_residual, encode=encode, decode=decode)


def _topk_rate(spec: str) -> float:
    return float(spec.split(":", 1)[1]) if ":" in spec else 0.01


def get_compressor(spec: str | None) -> Compressor:
    """Parse ``None | "none" | "bf16" | "int8" | "int8-row" | "int8-row-ef"
    | "topk:<rate>"``."""
    if spec is None or spec == "none":
        return _identity()
    if spec == "bf16":
        return _bf16()
    if spec == "int8":
        return _int8()
    if spec == "int8-row":
        return _int8_row()
    if spec == "int8-row-ef":
        return _int8_row_ef()
    if spec.startswith("topk"):
        return _topk(_topk_rate(spec))
    raise ValueError(f"unknown compressor {spec!r}")


def wire_bytes(nbytes_fp32: float, spec: str | None) -> float:
    """Analytic bytes-on-the-wire for one payload (comm-volume model)."""
    if spec is None or spec == "none":
        return float(nbytes_fp32)
    if spec == "bf16":
        return nbytes_fp32 / 2.0
    if spec == "int8":
        return nbytes_fp32 / 4.0 + 4.0
    if spec in ("int8-row", "int8-row-ef"):
        # one int8 per element + one f32 scale per 1024-lane (4 KiB) row
        return nbytes_fp32 / 4.0 + max(4.0, nbytes_fp32 / 1024.0)
    if spec.startswith("topk"):
        return _topk_rate(spec) * (nbytes_fp32 / 4.0) * (4.0 + 4.0)  # f32 values + i32 indices
    raise ValueError(spec)
