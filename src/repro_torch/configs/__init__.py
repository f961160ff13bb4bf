"""Architecture registry: ``--arch <id>`` resolves here.

The port carries the decoder-only architectures of the JAX package's
registry (``repro.configs``); its encoder-decoder (whisper-tiny) comes with
a later slice.
"""

from __future__ import annotations

from . import (
    granite_moe_1b_a400m,
    granite_moe_3b_a800m,
    h2o_danube_1p8b,
    hymba_1p5b,
    internvl2_2b,
    olmo_1b,
    qwen3_0p6b,
    qwen3_8b,
    xlstm_350m,
)
from .base import ModelConfig, pad_to

_MODULES = {
    "xlstm-350m": xlstm_350m,
    "hymba-1.5b": hymba_1p5b,
    "h2o-danube-1.8b": h2o_danube_1p8b,
    "qwen3-8b": qwen3_8b,
    "olmo-1b": olmo_1b,
    "qwen3-0.6b": qwen3_0p6b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "internvl2-2b": internvl2_2b,
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES: dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    try:
        return table[arch]
    except KeyError as e:
        raise ValueError(f"unknown arch {arch!r}; one of {sorted(ARCHS)}") from e


def tiny_lm(name: str = "tiny-lm", **overrides) -> ModelConfig:
    """A small decoder LM for examples/integration tests (~10M params)."""
    base = dict(
        name=name,
        family="dense",
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=1024,
        vocab_size=8192,
        rope_theta=10000.0,
    )
    base.update(overrides)
    return ModelConfig(**base)


__all__ = ["ARCHS", "SMOKES", "ModelConfig", "get_config", "pad_to", "tiny_lm"]
