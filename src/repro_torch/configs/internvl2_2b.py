"""internvl2-2b [vlm]: InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone only (InternLM2-1.8B): 24L d_model=2048 16H (kv=8) d_ff=8192
vocab=92553.  The ViT frontend is a STUB: input_specs() provides 256
precomputed patch embeddings spliced over the first positions.  Full
attention => long_500k skipped; decode shapes run (decoder LM).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    num_patches=256,
    rope_theta=10000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, num_patches=4,
)
