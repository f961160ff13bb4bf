"""granite-moe-1b-a400m [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (kv=8) d_ff=512-per-expert vocab=49155, MoE 32e top-8.
32 % 16 == 0 => true expert parallelism over the model axis.  Full
attention => long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    rope_theta=10000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=4, top_k=2,
)
