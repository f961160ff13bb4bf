"""olmo-1b [dense]: non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=8192 vocab=50304.  Tied
embeddings, SwiGLU, no-affine LN.  Full attention => long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",
    tie_embeddings=True,
    rope_theta=10000.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
)
