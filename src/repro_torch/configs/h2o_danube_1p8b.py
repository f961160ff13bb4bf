"""h2o-danube-1.8b [dense]: llama+mistral mix with SWA [arXiv:2401.16818; hf].

24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000, sliding window 4096.
The rolling SWA cache bounds decode state => long_500k runs.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, sliding_window=16,
)
