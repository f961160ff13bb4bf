"""Public flash-attention entry point (the port of
``repro/kernels/flash_attention/ops.py``), in the JAX package's layout.

A tensor on the CPU takes the plain version (:func:`.ref.reference_attention`);
a CUDA tensor launches the CUDA kernel (:func:`.kernel.flash_attention_launch`)
or raises; a meta tensor (the dry run) gets the kernel's output, unwritten.
The kernel masks the ragged edge itself, so nothing is padded to a block
multiple here.  Under a cost recorder every call is one
``flash_attention`` unit (:func:`~repro_torch.launch.costmodel.kernel_unit`)
with :func:`.kernel.work`'s FLOPs and bytes.
"""

from __future__ import annotations

import torch

from ...launch.costmodel import kernel_unit
from .kernel import flash_attention_launch, work
from .ref import reference_attention

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Causal and/or sliding-window softmax attention with GQA (q head ``h``
    reads kv head ``h // (H / Hkv)``); f32 inside, the output in q's dtype."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    with kernel_unit("flash_attention",
                     lambda: work(q.shape, k.shape, q.dtype, causal, window)):
        if q.device.type == "cpu":
            return reference_attention(q, k, v, causal=causal, window=window)
        if q.device.type == "meta":
            return torch.empty(q.shape, dtype=q.dtype, device="meta")
        return flash_attention_launch(q, k, v, causal=causal, window=window)
