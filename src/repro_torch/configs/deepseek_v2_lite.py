"""deepseek-v2-lite [moe]: latent attention (MLA), 2 shared + 64 routed
experts top-6, one leading dense layer
[hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434].

27L d_model=2048 16H; MLA with no q LoRA: q head 128 (nope) + 64 (rope),
latent kv rank 512 + a shared 64-dim rope key, v head 128; YaRN rope (factor
40 over 4096 positions, theta 1e4, mscale 0.707).  Layer 0 has a SwiGLU MLP of
width 10944; layers 1-26 a softmax router over 64 SwiGLU experts of width
1408 (greedy top-6, gates the raw probabilities), 2 shared experts (one
SwiGLU of width 2816) and the sequence-level aux loss (alpha 0.001, assumed:
the published config.json does not give it).  Untied head, vocab 102400.
The port routes with granite's capacity dispatch (factor 1.25), where the
published model is dropless.  Full attention => long_500k skipped; MLA
trains at tp = 1 only and does not serve (models.transformer.check_tp).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    n_experts=64,
    top_k=6,
    router_aux_weight=0.001,
    moe_d_ff=1408,
    n_shared_experts=2,
    first_dense_layers=1,
    norm_topk_prob=False,
    router_loss="seq_aux",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    long_context_ok=False,
)

# every mechanism at a CPU test's size: a dense layer then three MoE layers,
# 8 experts top-3 of which the chip holds all (tests cut the block)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256,
    n_experts=8, top_k=3, moe_d_ff=16, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=12,
)
