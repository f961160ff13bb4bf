"""xlstm-350m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: projections live
inside the xLSTM blocks (proj_factor=2).  sLSTM at every 6th layer (the
paper's sparse-sLSTM placement); all other layers are mLSTM.  Constant-state
decode => long_500k runs.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=True,
    slstm_every=6,
    proj_factor=2.0,
    rope_theta=0.0,
    norm_type="rmsnorm",
    long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
    slstm_every=2,
)
