"""qwen3-8b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936.  Pure full attention
=> long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256,
)
