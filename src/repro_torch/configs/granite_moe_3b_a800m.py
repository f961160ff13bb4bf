"""granite-moe-3b-a800m [moe]: 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (kv=8) d_ff=512-per-expert vocab=49155, MoE 40e top-8.
40 % 16 != 0 => experts are tensor-parallel on d_ff (512/16) rather than
expert-parallel.  Full attention => long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    rope_theta=10000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=5, top_k=2,
)
