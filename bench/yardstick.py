"""The benchmark's frozen arithmetic: the card's peaks, a training step's
model FLOPs and the DecentLaM tail's bytes.  Copies of the program's
``launch/roofline.py`` constants and of the fused stage's byte rule
(``kernels/fused_update/kernel.py:stage_bytes``: each input read once, each
output written once), kept here so that a change to the program cannot move
the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores (FFMA)
TF32_FLOP_PER_S = 494.7e12
# float32 accuracy on the tensor cores: three TF32 products per product
# (3xTF32, as the program's own flash and mLSTM kernels compute)
F32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3

# planes each stage op of a decentlam step reads and writes, per element:
# grad_step x, g -> payload; decentlam_post x, mix, m -> x, m
STAGE_PLANES = {"grad_step": (2, 1), "decentlam_post": (3, 2)}


def matmul_params(model: dict) -> int:
    """Parameters of one node that enter a matrix product per token: the
    attention and MLP weights (for a MoE, the router and ``k`` experts'), and
    the head (tied or not: the embedding lookup is no product)."""
    d = int(model["hidden_size"])
    h, kv = int(model["num_attention_heads"]), int(model["num_key_value_heads"])
    hd = int(model.get("head_dim") or d // h)
    f, v, L = int(model["intermediate_size"]), int(model["vocab_size"]), \
        int(model["num_hidden_layers"])
    attn = d * h * hd * 2 + d * kv * hd * 2
    if "num_local_experts" in model:
        E, k = int(model["num_local_experts"]), int(model["num_experts_per_tok"])
        mlp = d * E + k * 3 * d * f
    else:
        mlp = 3 * d * f
    return L * (attn + mlp) + d * v


def step_flops(model: dict, traffic: dict, nodes: int) -> float:
    """Model FLOPs of one training step over all nodes: ``6 N`` per token for
    the parameters that enter a product, plus attention's two ``S x S``
    products (``12 L H hd S`` per token, forward and backward)."""
    d = int(model["hidden_size"])
    h = int(model["num_attention_heads"])
    hd = int(model.get("head_dim") or d // h)
    L, S = int(model["num_hidden_layers"]), int(traffic["seq_len"])
    tokens = nodes * int(traffic["rows_per_node"]) * S
    return tokens * (6.0 * matmul_params(model) + 12.0 * L * h * hd * S)


def tail_bytes(plane_elems: int, ops: dict[str, int]) -> float:
    """Bytes the tail must move for ``ops`` (``{op: launches}``) on planes of
    ``plane_elems`` f32 elements (all nodes)."""
    return sum(4.0 * plane_elems * sum(STAGE_PLANES[op]) * count for op, count in ops.items())
