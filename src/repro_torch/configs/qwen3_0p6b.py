"""qwen3-0.6b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (kv=8) d_ff=3072 vocab=151936.  Full attention =>
long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256,
)
