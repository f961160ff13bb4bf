"""Roofline terms on the H100's constants (the port of ``repro.launch.roofline``).

Three terms per program and device:

    compute    = FLOPs / peak FLOP/s
    memory     = device-memory bytes / HBM bytes/s
    collective = link egress bytes / link bytes/s

The hardware model is one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, no sparsity, at the full 700 W): 989 TFLOP/s bf16 on the tensor
cores (the default peak: the dry run computes in bf16, as the
reference's), 494.7 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s of HBM3, and 450 GB/s of NVLink 4 egress per direction.
An f32 program is priced with ``HW(peak_flops=F32_FLOP_PER_S)``.

Collective egress follows the reference's ring rules
(:func:`collective_egress`).  The reference also parses collective bytes
out of XLA's optimized HLO text (``parse_collective_bytes``); the port has
no HLO, and counts its collectives where they are issued instead
(:mod:`repro_torch.launch.costmodel`).

:func:`kernel_bound` is the least time of one hand-written kernel call:
the larger of its bytes over the memory rate and its operations over the
rate of the units that run them.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "BF16_FLOP_PER_S",
    "CollectiveStats",
    "F32_FLOP_PER_S",
    "HBM_BYTES_PER_S",
    "HW",
    "NVLINK_BYTES_PER_S",
    "TF32_FLOP_PER_S",
    "collective_egress",
    "kernel_bound",
    "model_flops",
    "roofline_terms",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores (FFMA)
TF32_FLOP_PER_S = 494.7e12  # dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores, f32 accumulation
NVLINK_BYTES_PER_S = 450e9  # NVLink 4: 900 GB/s both ways, egress per direction


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = BF16_FLOP_PER_S  # FLOP/s per card
    hbm_bw: float = HBM_BYTES_PER_S  # bytes/s per card
    link_bw: float = NVLINK_BYTES_PER_S  # egress bytes/s per card


def collective_egress(op: str, nbytes: float, group: int) -> float:
    """Per-device link egress of one collective over ``group`` devices (the
    reference's ring models): an all-reduce sends ``2 (g-1)/g`` of its
    operand, an all-gather ``(g-1)/g`` of its result, a reduce-scatter and
    an all-to-all ``(g-1)/g`` of their operand, a permute its operand once.
    A group of one moves nothing."""
    if group <= 1:
        return 0.0
    frac = (group - 1) / group
    if op == "all-reduce":
        return 2.0 * frac * nbytes
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    egress_bytes: float  # per-device bytes put on links

    def as_dict(self):
        return {"counts": dict(self.counts), "egress_bytes": self.egress_bytes}


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_egress: float,
    hw: HW = HW(),
) -> dict:
    compute_s = flops_per_device / hw.peak_flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = collective_egress / hw.link_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_time_lower_bound_s": bound,
        "roofline_fraction": (bound / total) if total > 0 else 0.0,
    }


def model_flops(n_active_params: int, tokens: int, *, training: bool) -> float:
    """MODEL_FLOPS = 6 N D for training, 2 N D for inference forward."""
    return (6.0 if training else 2.0) * n_active_params * tokens


def kernel_bound(nbytes: float, flops: float, dtype: torch.dtype = torch.float32, *,
                 tensor_cores: bool = False) -> tuple[float, str]:
    """The least time (ms) one kernel call could take on the card, and
    which term sets it (``"bytes"`` or ``"operations"``): the larger of
    ``nbytes`` over the memory rate and ``flops`` over the compute rate.
    Without ``tensor_cores`` the operations run as float32 FFMA; with them,
    an f32 product is three TF32 products (3xTF32: a third of the TF32
    rate) and a bf16 product runs at the bf16 rate."""
    if tensor_cores:
        rate = TF32_FLOP_PER_S / 3 if dtype == torch.float32 else BF16_FLOP_PER_S
    else:
        rate = F32_FLOP_PER_S
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
