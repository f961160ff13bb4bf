"""Serve step builders (prefill / decode) on one device (the port of
``repro.train.serve`` at tensor-parallel degree 1).

Serving uses the consensus model: one parameter tree, on one device.  The
reference wraps the same two functions in ``shard_map`` over its mesh (batch
over the node axes, cache sequence-sharded over the model axis); the mesh,
``serve_specs`` and ``abstract_cache`` come with the distributed slice.
Both steps run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T

Tree = Any

__all__ = ["ServeConfig", "build_prefill_step", "build_decode_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    runtime: T.RuntimeConfig = T.RuntimeConfig()
    target_len: int = 0  # cache capacity target (0 -> prefill length)


def build_prefill_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """``(params, batch) -> (last-token logits (B, Vp), cache)``."""

    def step(params: Tree, batch: dict):
        with torch.inference_mode():
            return T.prefill(params, batch, cfg, scfg.runtime,
                             target_len=scfg.target_len or batch["tokens"].shape[1])

    return step


def build_decode_step(cfg: ModelConfig, scfg: ServeConfig, *, target_len: int,
                      per_slot_t: bool = False) -> Callable:
    """``(params, tokens (B, 1), cache, t) -> (logits (B, Vp), cache)``; the
    cache is updated in place.  With ``per_slot_t`` the position argument is
    a ``(B,)`` vector (the continuous-batching scheduler runs slots whose
    request timelines are independent) instead of a shared scalar."""

    def step(params: Tree, tokens: torch.Tensor, cache: Tree, t):
        t = torch.as_tensor(t)
        want = (tokens.shape[0],) if per_slot_t else ()
        if tuple(t.shape) != want:
            raise ValueError(f"t has shape {tuple(t.shape)}, want {want} "
                             f"(per_slot_t={per_slot_t})")
        with torch.inference_mode():
            return T.decode_step(params, tokens, cache, t, cfg, scfg.runtime,
                                 target_len=target_len)

    return step
