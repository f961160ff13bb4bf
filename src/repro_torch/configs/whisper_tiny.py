"""whisper-tiny [audio]: enc-dec, conv frontend stub [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv
frontend is a STUB: input_specs() provides precomputed (B, 1500, 384) frame
embeddings.  Sinusoidal absolute positions (rope disabled).  Decoder has
self+cross KV-cache decode; full attention => long_500k skipped.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    arch_kind="encdec",
    n_enc_layers=4,
    enc_seq=1500,
    norm_type="layernorm",
    gated_mlp=False,
    act="gelu",
    rope_theta=0.0,
    long_context_ok=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, enc_seq=16,
)
