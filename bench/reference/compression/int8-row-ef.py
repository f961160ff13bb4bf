"""int8 row quantization with error feedback.

A sender holds a residual ``e`` (zero at the start) and sends
``q = Q(p + e)``, keeping ``e <- p + e - q``.  ``Q`` quantizes each run of
1024 elements of the flattened leaf (zero padded at its end) to
``round(v / s)`` clipped to +-127, ``s = max(absmax, 1e-12) / 127``,
rounding half to even, and the receiver decodes ``q * s``.
"""

from __future__ import annotations

import torch

ROW = 1024  # elements per quantization row


def quantize_rows(v: torch.Tensor) -> torch.Tensor:
    """``v`` as the receiver decodes it after int8 row quantization."""
    flat = v.reshape(-1)
    pad = (-flat.numel()) % ROW
    rows = torch.cat([flat, flat.new_zeros(pad)]).view(-1, ROW)
    scale = torch.clamp(rows.abs().amax(1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(rows / scale), -127, 127)
    return (q * scale).reshape(-1)[: flat.numel()].view(v.shape)


def init(p: torch.Tensor) -> torch.Tensor:
    """The residual of one node's leaf before the first round."""
    return torch.zeros_like(p)


def send(p: torch.Tensor, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What a node sends of its payload ``p``, and its new residual."""
    v = p + residual
    q = quantize_rows(v)
    return q, v - q
