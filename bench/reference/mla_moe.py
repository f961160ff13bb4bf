"""Plain reference of a DeepSeek-V2 decoder LM's training loss (latent
attention, shared and routed experts after leading dense layers;
DeepSeek-V2-Lite as run).

Written from the published architecture (DeepSeek-AI, arXiv:2405.04434; the
model's ``config.json`` and ``modeling_deepseek.py``) in float32 with plain
``torch`` operations and autograd and a Python loop over the experts, no
kernel, cache or batching of the program under test; nothing here imports
it.  The embedding, the norms, the dense layers' SwiGLU and the head are
:mod:`.dense`'s.  The configuration file in ``bench/configs`` states what is
run; this module reads the numbers from it.

* **Multi-head latent attention** (no q LoRA), per layer: ``q = h Wq`` split
  per head into ``q_nope`` and ``q_rope``; ``[c | k_rope] = h Wkv_a``, ``c``
  RMS-normed (eps 1e-6, scale ``1 + kv_norm``), ``[k_nope | v] = c Wkv_b``
  per head; ``q_rope`` and the one ``k_rope`` that every head shares are
  rotated, each adjacent pair ``(2i, 2i + 1)`` by position times YaRN's
  frequency ``i`` (cos and sin times YaRN's factor ratio); the scores are
  ``(q_nope . k_nope + q_rope . k_rope)`` times ``(nope + rope)^-1/2 m^2``,
  ``m`` YaRN's ``0.1 mscale_all_dim ln(factor) + 1``; a causal softmax, the
  heads' ``v`` sums, ``Wo``.
* **YaRN** frequencies: theta's ``f_i = theta^(-2i / rope)``, and ``f_i /
  factor``, mixed as ``(f_i / factor) ramp_i + f_i (1 - ramp_i)`` with
  ``ramp`` linear from ``floor(c(beta_fast))`` to ``ceil(c(beta_slow))``,
  ``c(r) = rope ln(orig / (2 pi r)) / (2 ln theta)`` clamped to ``[0, rope -
  1]``.
* The first ``first_k_dense_replace`` layers have a SwiGLU MLP of width
  ``intermediate_size`` (group ``groups.g0``); the rest a **MoE block**
  (group ``groups.g1``): router ``softmax(h W_r)`` over all
  ``run.router_width`` experts in float32, the top ``k`` experts of each
  token (greedy, the lower index first on a tie) with their raw
  probabilities as gates (``norm_topk_prob`` false); the capacity ``C =
  max(8, 8 ceil(c / 8))``, ``c = ceil(k T capacity_factor / E)``, over the
  ``T`` tokens of one node's microbatch, assignments taken in token order
  (token ``t``'s ``j``-th choice is assignment ``t k + j``) and those past an
  expert's first ``C`` dropped; this chip holds experts ``0 ..
  n_routed_experts - 1`` (SwiGLU of width ``moe_intermediate_size`` each) and
  adds only their kept assignments' ``gate * expert(h)``; plus the shared
  experts, one SwiGLU of width ``n_shared_experts * moe_intermediate_size``.
* The loss: the mean cross entropy over the (sliced) vocabulary plus
  ``aux_loss_alpha`` times, summed over the MoE layers, the sequence-level
  balance term: per sequence of ``S`` tokens ``sum_e f_e P_e``, ``f_e`` the
  count of the sequence's top-k choices of expert ``e`` (dropped or not)
  over ``k S / E``, ``P_e`` the sequence's mean probability of ``e``;
  averaged over the sequences.  No z-loss.

Parameters are a flat dict ``{path: tensor}`` of one node, each group's
layers stacked on a leading axis, linear weights ``(d_in, d_out)`` applied as
``x @ w``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense

Params = dict[str, torch.Tensor]
DENSE, MOE = "groups.g0", "groups.g1"


def dims(model: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    run = model["run"]
    dense_layers = int(model["first_k_dense_replace"])
    yarn = model.get("rope_scaling") or {}
    return {
        "d": int(model["hidden_size"]),
        "h": int(model["num_attention_heads"]),
        "nope": int(model["qk_nope_head_dim"]),
        "rope": int(model["qk_rope_head_dim"]),
        "dv": int(model["v_head_dim"]),
        "r": int(model["kv_lora_rank"]),
        "f": int(model["intermediate_size"]),
        "fe": int(model["moe_intermediate_size"]),
        "shared": int(model["n_shared_experts"]),
        "E": int(run["router_width"]),
        "held": int(model["n_routed_experts"]),
        "k": int(model["num_experts_per_tok"]),
        "v": int(model["vocab_size"]),
        "dense_layers": dense_layers,
        "moe_layers": int(model["num_hidden_layers"]) - dense_layers,
        "theta": float(model["rope_theta"]),
        "yarn": yarn,
        "tied": bool(model["tie_word_embeddings"]),
        "norm": run["norm"],
    }


def _attn_specs(group: str, L: int, m: dict) -> list[tuple[str, tuple, float]]:
    d, h, r = m["d"], m["h"], m["r"]
    q, kv = h * (m["nope"] + m["rope"]), h * (m["nope"] + m["dv"])
    return [(f"{group}.attn.wq", (L, d, q), d ** -0.5),
            (f"{group}.attn.wkv_a", (L, d, r + m["rope"]), d ** -0.5),
            (f"{group}.attn.kv_norm", (L, r), 0.0),
            (f"{group}.attn.wkv_b", (L, r, kv), r ** -0.5),
            (f"{group}.attn.wo", (L, h * m["dv"], d), (h * m["dv"]) ** -0.5),
            (f"{group}.attn_norm.scale", (L, d), 0.0),
            (f"{group}.mlp_norm.scale", (L, d), 0.0)]


def param_specs(model: dict) -> list[tuple[str, tuple, float]]:
    m = dims(model)
    d, L0, L1 = m["d"], m["dense_layers"], m["moe_layers"]
    fe, held, fs = m["fe"], m["held"], m["shared"] * m["fe"]
    out = [("embed.table", (m["v"], d), 0.02)]
    if not m["tied"]:
        out.append(("lm_head.w", (d, m["v"]), d ** -0.5))
    out += _attn_specs(DENSE, L0, m) + [
        (f"{DENSE}.mlp.w_in", (L0, d, m["f"]), d ** -0.5),
        (f"{DENSE}.mlp.w_gate", (L0, d, m["f"]), d ** -0.5),
        (f"{DENSE}.mlp.w_out", (L0, m["f"], d), m["f"] ** -0.5)]
    out += _attn_specs(MOE, L1, m) + [
        (f"{MOE}.moe.router", (L1, d, m["E"]), d ** -0.5),
        (f"{MOE}.moe.w_in", (L1, held, d, fe), d ** -0.5),
        (f"{MOE}.moe.w_gate", (L1, held, d, fe), d ** -0.5),
        (f"{MOE}.moe.w_out", (L1, held, fe, d), fe ** -0.5),
        (f"{MOE}.moe.shared.w_in", (L1, d, fs), d ** -0.5),
        (f"{MOE}.moe.shared.w_gate", (L1, d, fs), d ** -0.5),
        (f"{MOE}.moe.shared.w_out", (L1, fs, d), fs ** -0.5)]
    return out + [("final_norm.scale", (d,), 0.0)]


def yarn_freqs(m: dict, device) -> tuple[torch.Tensor, float, float]:
    """``(frequencies (rope/2,), cos and sin factor, softmax scale)``."""
    rope, theta, y = m["rope"], m["theta"], m["yarn"]
    base = 1.0 / theta ** (torch.arange(0, rope, 2, dtype=torch.float32, device=device) / rope)
    scale = (m["nope"] + rope) ** -0.5
    if not y:
        return base, 1.0, scale
    factor, orig = float(y["factor"]), float(y["original_max_position_embeddings"])

    def c(rotations):
        return rope * math.log(orig / (2 * math.pi * rotations)) / (2 * math.log(theta))

    def mscale(s):
        return 0.1 * s * math.log(factor) + 1.0 if factor > 1 else 1.0

    lo = max(math.floor(c(float(y["beta_fast"]))), 0)
    hi = min(math.ceil(c(float(y["beta_slow"]))), rope - 1)
    hi = hi + 0.001 if hi == lo else hi
    i = torch.arange(rope // 2, dtype=torch.float32, device=device)
    ramp = ((i - lo) / (hi - lo)).clamp(0.0, 1.0)  # 0: theta's own, 1: divided by factor
    freqs = (base / factor) * ramp + base * (1.0 - ramp)
    all_dim = float(y.get("mscale_all_dim", 0.0))
    if all_dim:
        scale *= mscale(all_dim) ** 2
    return freqs, mscale(float(y.get("mscale", 1.0))) / mscale(all_dim), scale


def rotate_pairs(x: torch.Tensor, freqs: torch.Tensor, cos_scale: float) -> torch.Tensor:
    """``x`` (B, S, heads, rope): pair ``(2i, 2i + 1)`` at position ``s``
    rotated by the angle ``s freqs[i]``."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos = (torch.cos(ang) * cos_scale)[None, :, None, :]
    sin = (torch.sin(ang) * cos_scale)[None, :, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2)


def mla(h: torch.Tensor, p: Params, group: str, layer: int, m: dict) -> torch.Tensor:
    B, S, _ = h.shape
    H, nope, rope, dv, r = m["h"], m["nope"], m["rope"], m["dv"], m["r"]
    w = {k: p[f"{group}.attn.{k}"][layer] for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")}
    q = (h @ w["wq"]).view(B, S, H, nope + rope)
    ckv = h @ w["wkv_a"]
    c = dense.norm(ckv[..., :r], w["kv_norm"], "rmsnorm")
    kv = (c @ w["wkv_b"]).view(B, S, H, nope + dv)
    freqs, cos_scale, scale = yarn_freqs(m, h.device)
    q_rope = rotate_pairs(q[..., nope:], freqs, cos_scale)
    k_rope = rotate_pairs(ckv[..., None, r:], freqs, cos_scale)[:, :, 0]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope], kv[..., :nope])
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), kv[..., nope:])
    return out.reshape(B, S, H * dv) @ w["wo"]


def swiglu(h: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    return (F.silu(h @ w_gate) * (h @ w_in)) @ w_out


def capacity(m: dict, tokens: int, factor: float) -> int:
    c = math.ceil(m["k"] * tokens * factor / m["E"])
    return max(8, 8 * math.ceil(c / 8))


def moe_block(h: torch.Tensor, p: Params, layer: int, model: dict, m: dict):
    """``h`` (B, S, d) -> (the held experts' part plus the shared experts'
    output (B, S, d), the sequence-level balance term)."""
    B, S, d = h.shape
    T, E, k = B * S, m["E"], m["k"]
    x = h.reshape(T, d)
    probs = torch.softmax(x @ p[f"{MOE}.moe.router"][layer], dim=-1)
    gates, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    balance = 0.0
    for b in range(B):
        counts = torch.zeros(E, device=h.device).index_add_(
            0, top_e[b * S:(b + 1) * S].reshape(-1), torch.ones(S * k, device=h.device))
        balance = balance + torch.sum(counts / (k * S / E) * probs[b * S:(b + 1) * S].mean(0))
    balance = balance / B

    C = capacity(m, T, float(model["run"]["capacity_factor"]))
    flat_e, flat_g = top_e.reshape(-1), gates.reshape(-1)
    out = torch.zeros(T * k, d, dtype=h.dtype, device=h.device)
    for e in range(m["held"]):
        assigned = torch.nonzero(flat_e == e).reshape(-1)[:C]  # in token order
        if assigned.numel() == 0:
            continue
        ye = swiglu(x[assigned // k], *(p[f"{MOE}.moe.{n}"][layer, e]
                                         for n in ("w_in", "w_gate", "w_out")))
        out = out.index_put((assigned,), ye * flat_g[assigned, None])
    routed = out.view(T, k, d).sum(1).view(B, S, d)
    shared = swiglu(h, *(p[f"{MOE}.moe.shared.{n}"][layer] for n in ("w_in", "w_gate", "w_out")))
    return routed + shared, balance


def forward_loss(p: Params, tokens: torch.Tensor, targets: torch.Tensor, model: dict,
                 ) -> torch.Tensor:
    """The training loss of one node's parameters on ``tokens`` (B, S)."""
    m = dims(model)
    x = dense.embed(p, tokens)
    balance = 0.0
    for group, count in ((DENSE, m["dense_layers"]), (MOE, m["moe_layers"])):
        for layer in range(count):
            h = dense.norm(x, p[f"{group}.attn_norm.scale"][layer], m["norm"])
            x = x + mla(h, p, group, layer, m)
            h = dense.norm(x, p[f"{group}.mlp_norm.scale"][layer], m["norm"])
            if group == DENSE:
                x = x + dense.swiglu(h, p, layer)
            else:
                y, b = moe_block(h, p, layer, model, m)
                x, balance = x + y, balance + b
    return dense.head_loss(x, p, targets, m) + float(model["aux_loss_alpha"]) * balance
