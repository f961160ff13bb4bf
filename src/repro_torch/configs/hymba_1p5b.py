"""hymba-1.5b [hybrid]: parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16.  SWA-1024
on all but 3 global-attention layers (first/middle/last, per the paper);
meta tokens are stubbed out.  SSM state + rolling SWA (plus
the 3 full-cache layers) => long_500k runs.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm=True,
    ssm_state=16,
    d_ssm=1600,
    sliding_window=1024,
    global_layers=(0, 16, 31),
    rope_theta=10000.0,
    long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, d_ssm=64, sliding_window=8, global_layers=(0, 3),
)
