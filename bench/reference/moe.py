"""Plain reference of a mixture-of-experts decoder LM's training loss
(granite-3.0-1b-a400m as run).

Attention, norms, embeddings and the head are :mod:`.dense`'s.  Each layer's
MLP is a sparse MoE block, written from the Switch / GShard description in
float32 with a Python loop over the experts:

* router: ``logits = h @ W_r`` (d, E) in float32, ``probs = softmax(logits)``;
  each token takes the ``k`` experts of highest probability (the lower index
  first on a tie) with gates ``probs / sum of its k probs``;
* capacity: an expert holds ``C = max(8, 8 * ceil(c / 8))`` assignments,
  ``c = ceil(k * T * capacity_factor / E)`` for the ``T`` tokens of one
  node's microbatch; the assignments are taken in token order (token ``t``'s
  ``j``-th choice is assignment ``t * k + j``), and those past the first ``C``
  of an expert are dropped;
* experts: SwiGLU of width ``f`` each, ``(silu(h Wg_e) * (h Wi_e)) Wo_e``;
* output: each token's sum over its kept assignments of ``gate * expert(h)``;
* router terms added to the loss: ``router_aux_weight * E * sum_e mean_t
  probs[t, e] * mean_t chosen[t, e]`` (``chosen`` counts all ``k`` choices,
  dropped or not) and ``router_z_weight * mean_t logsumexp(logits_t)^2``,
  each summed over the layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense

Params = dict[str, torch.Tensor]
GROUP = dense.GROUP


def experts(model: dict) -> tuple[int, int]:
    return int(model["num_local_experts"]), int(model["num_experts_per_tok"])


def param_specs(model: dict) -> list[tuple[str, tuple, float]]:
    m = dense.dims(model)
    d, f, L = m["d"], m["f"], m["layers"]
    E, _ = experts(model)
    moe = [(f"{GROUP}.moe.router", (L, d, E), d ** -0.5),
           (f"{GROUP}.moe.w_in", (L, E, d, f), d ** -0.5),
           (f"{GROUP}.moe.w_gate", (L, E, d, f), d ** -0.5),
           (f"{GROUP}.moe.w_out", (L, E, f, d), f ** -0.5)]
    return dense.embed_specs(model) + dense.attn_specs(model) + moe + dense.norm_specs(model)


def capacity(model: dict, tokens: int) -> int:
    E, k = experts(model)
    c = math.ceil(k * tokens * float(model["run"]["capacity_factor"]) / E)
    return max(8, 8 * math.ceil(c / 8))


def moe_block(h: torch.Tensor, p: Params, layer: int, model: dict):
    """``h`` (B, S, d) -> (output (B, S, d), load-balance term, z term)."""
    B, S, d = h.shape
    T = B * S
    E, k = experts(model)
    x = h.reshape(T, d)
    logits = x @ p[f"{GROUP}.moe.router"][layer]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = torch.zeros(T, E, device=h.device).scatter(1, top_e, 1.0)
    balance = E * torch.sum(probs.mean(0) * chosen.mean(0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    C = capacity(model, T)
    flat_e = top_e.reshape(-1)  # assignment t * k + j -> its expert
    flat_g = gates.reshape(-1)
    out = torch.zeros(T * k, d, dtype=h.dtype, device=h.device)
    w_in = p[f"{GROUP}.moe.w_in"][layer]
    w_gate = p[f"{GROUP}.moe.w_gate"][layer]
    w_out = p[f"{GROUP}.moe.w_out"][layer]
    for e in range(E):
        assigned = torch.nonzero(flat_e == e).reshape(-1)[:C]  # in token order
        if assigned.numel() == 0:
            continue
        xe = x[assigned // k]
        ye = (F.silu(xe @ w_gate[e]) * (xe @ w_in[e])) @ w_out[e]
        out = out.index_put((assigned,), ye * flat_g[assigned, None])
    return out.view(T, k, d).sum(1).view(B, S, d), balance, z


def forward_loss(p: Params, tokens: torch.Tensor, targets: torch.Tensor, model: dict,
                 ) -> torch.Tensor:
    m = dense.dims(model)
    run = model["run"]
    x = dense.embed(p, tokens)
    balance = z = 0.0
    for layer in range(m["layers"]):
        h = dense.norm(x, p.get(f"{GROUP}.attn_norm.scale")[layer], m["norm"])
        x = x + dense.attention(h, p, layer, m)
        h = dense.norm(x, p.get(f"{GROUP}.mlp_norm.scale")[layer], m["norm"])
        y, b, zl = moe_block(h, p, layer, model)
        x = x + y
        balance, z = balance + b, z + zl
    loss = dense.head_loss(x, p, targets, m)
    return (loss + float(run["router_aux_weight"]) * balance
            + float(run["router_z_weight"]) * z)
