"""The whole step's share of the card's float32-accurate peak in a cell of
latent attention and shared and held experts (``run.family`` ``mla_moe``):
the model FLOPs of the window's unprofiled steps (:func:`step_flops`) over
the window's seconds, against 3xTF32's 164.9 TFLOP/s, as ``step_mfu_pct``
reads a dense or MoE cell (whose count, ``bench/yardstick.py:step_flops``,
knows no latent attention, shared experts, leading dense layers or held
block of experts)."""

from bench import yardstick


def product_params(model: dict) -> float:
    """Parameters of one node that enter a matrix product per token: each
    layer's MLA projections (``wq``, ``wkv_a``, ``wkv_b``, ``wo``), the leading
    dense layers' MLP, each MoE layer's router, shared experts and the held
    block's share ``k held / E`` of an expert (a token takes ``k`` of all
    ``E`` experts), and the head."""
    d, h = int(model["hidden_size"]), int(model["num_attention_heads"])
    nope, rope, dv = (int(model[k]) for k in ("qk_nope_head_dim", "qk_rope_head_dim",
                                              "v_head_dim"))
    r = int(model["kv_lora_rank"])
    dense, layers = int(model["first_k_dense_replace"]), int(model["num_hidden_layers"])
    fe, E = int(model["moe_intermediate_size"]), int(model["run"]["router_width"])
    k, held = int(model["num_experts_per_tok"]), int(model["n_routed_experts"])
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) + h * dv * d
    moe = d * E + 3 * d * fe * int(model["n_shared_experts"]) + k * held / E * 3 * d * fe
    return (layers * mla + dense * 3 * d * int(model["intermediate_size"])
            + (layers - dense) * moe + d * int(model["vocab_size"]))


def step_flops(model: dict, traffic: dict, nodes: int) -> float:
    """Model FLOPs of one training step over all nodes: ``6 N`` per token for
    :func:`product_params`, plus attention's two ``S x S`` products (scores
    over ``nope + rope``, values over ``v``): ``6 L H (nope + rope + v) S``
    per token, forward and backward."""
    h, S = int(model["num_attention_heads"]), int(traffic["seq_len"])
    qk = int(model["qk_nope_head_dim"]) + int(model["qk_rope_head_dim"])
    tokens = nodes * int(traffic["rows_per_node"]) * S
    attn = 6.0 * int(model["num_hidden_layers"]) * h * (qk + int(model["v_head_dim"])) * S
    return tokens * (6.0 * product_params(model) + attn)


def read(ctx):
    if not ctx.window_steps or ctx.window_s <= 0:
        return None
    flops = step_flops(ctx.cell.model, ctx.cell.traffic, ctx.program.n)
    return 100.0 * flops * ctx.window_steps / ctx.window_s / yardstick.F32_ACCURATE_FLOP_PER_S
