"""Public chunked-mLSTM entry point (the port of
``repro/kernels/mlstm_chunk/ops.py``), in the JAX package's layout.

A tensor on the CPU takes the plain version (:func:`.ref.mlstm_chunked`); a
CUDA tensor launches the CUDA kernel (:func:`.kernel.mlstm_chunk_launch`) or
raises; a meta tensor (the dry run) gets the kernel's outputs, unwritten.
Both start from a zero state, as the reference's kernel does.  Under a cost
recorder every call is one ``mlstm_chunk`` unit
(:func:`~repro_torch.launch.costmodel.kernel_unit`) with
:func:`.kernel.work`'s FLOPs and bytes.
"""

from __future__ import annotations

import torch

from ...launch.costmodel import kernel_unit
from .kernel import mlstm_chunk_launch, work
from .ref import mlstm_chunked

__all__ = ["mlstm"]


def mlstm(
    q: torch.Tensor,  # (B, H, S, dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, S, dv)
    i_raw: torch.Tensor,  # (B, H, S) float32
    f_raw: torch.Tensor,
    *,
    chunk: int = 128,
):
    """Returns ``(h (B, H, S, dv) in v's dtype, {"C", "n", "m"})``; the chunk
    is ``min(chunk, S)`` and must divide ``S``."""
    S = q.shape[2]
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mlstm runs on CPU or CUDA tensors, got {q.device}")
    with kernel_unit("mlstm_chunk", lambda: work(q.shape, v.shape, q.dtype, chunk)):
        if q.device.type == "cpu":
            return mlstm_chunked(q, k, v, i_raw, f_raw, chunk=chunk)
        if q.device.type == "meta":
            B, H, _, dk = q.shape
            f32 = dict(dtype=torch.float32, device="meta")
            return (torch.empty(v.shape, dtype=v.dtype, device="meta"),
                    {"C": torch.empty((B, H, dk, v.shape[3]), **f32),
                     "n": torch.empty((B, H, dk), **f32), "m": torch.empty((B, H), **f32)})
        return mlstm_chunk_launch(q, k, v, i_raw, f_raw, chunk=chunk)
