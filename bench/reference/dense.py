"""Plain reference of a dense decoder LM's training loss (OLMo-1B as run).

Written from the published architecture, in float32 with plain ``torch``
operations and autograd, no kernel, cache or batching of the program under
test; nothing here imports it.  The configuration file in
``bench/configs`` states what is run; this module reads the numbers from it.

The architecture (Groeneveld et al., arXiv:2402.00838; as run):

* token embedding ``E`` (V, d); logits ``h @ E^T`` when the embeddings are
  tied, else ``h @ W_head`` (d, V);
* per layer, pre-norm: ``x += Attn(Norm(x))``, ``x += MLP(Norm(x))``; a final
  norm before the head;
* ``Norm``: OLMo's layer norm without affine parameters (eps 1e-5), or an
  RMS norm (eps 1e-6) whose scale is stored as an offset from one,
  ``x * (1 + scale)``;
* attention: ``q = h Wq``, ``k = h Wk``, ``v = h Wv``, rotary positions on the
  two halves of each head (theta from the file), grouped-query heads (query
  head ``j`` reads key/value head ``j // (H / KV)``), causal softmax of
  ``q k / sqrt(hd)`` in float32, output ``Wo``;
* MLP: SwiGLU, ``(silu(h Wg) * (h Wi)) Wo``;
* loss: the mean over tokens of the cross entropy over the whole vocabulary.

Parameters are a flat dict ``{path: tensor}`` of one node, with the layers of
a kind stacked on a leading axis; a linear weight is ``(d_in, d_out)`` and is
applied as ``x @ w``.  :func:`param_specs` gives every path, its shape and the
standard deviation it is drawn with (0: a zero init).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]

GROUP = "groups.g0"  # every layer of the model is of one kind: one stacked group


def dims(model: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    d = int(model["hidden_size"])
    h = int(model["num_attention_heads"])
    return {
        "d": d,
        "h": h,
        "kv": int(model["num_key_value_heads"]),
        "hd": int(model.get("head_dim") or d // h),
        "f": int(model["intermediate_size"]),
        "v": int(model["vocab_size"]),
        "layers": int(model["num_hidden_layers"]),
        "theta": float(model["rope_theta"]),
        "tied": bool(model["tie_word_embeddings"]),
        "norm": model["run"]["norm"],
    }


def norm_specs(model: dict) -> list[tuple[str, tuple, float]]:
    """The norm scales of an RMS-norm model (none for OLMo's layer norm)."""
    m = dims(model)
    if m["norm"] != "rmsnorm":
        return []
    return [(f"{GROUP}.attn_norm.scale", (m["layers"], m["d"]), 0.0),
            (f"{GROUP}.mlp_norm.scale", (m["layers"], m["d"]), 0.0),
            ("final_norm.scale", (m["d"],), 0.0)]


def attn_specs(model: dict) -> list[tuple[str, tuple, float]]:
    m = dims(model)
    d, L, q, kv = m["d"], m["layers"], m["h"] * m["hd"], m["kv"] * m["hd"]
    return [(f"{GROUP}.attn.wq", (L, d, q), d ** -0.5),
            (f"{GROUP}.attn.wk", (L, d, kv), d ** -0.5),
            (f"{GROUP}.attn.wv", (L, d, kv), d ** -0.5),
            (f"{GROUP}.attn.wo", (L, q, d), q ** -0.5)]


def embed_specs(model: dict) -> list[tuple[str, tuple, float]]:
    m = dims(model)
    out = [("embed.table", (m["v"], m["d"]), 0.02)]
    if not m["tied"]:
        out.append(("lm_head.w", (m["d"], m["v"]), m["d"] ** -0.5))
    return out


def param_specs(model: dict) -> list[tuple[str, tuple, float]]:
    m = dims(model)
    d, f, L = m["d"], m["f"], m["layers"]
    mlp = [(f"{GROUP}.mlp.w_in", (L, d, f), d ** -0.5),
           (f"{GROUP}.mlp.w_gate", (L, d, f), d ** -0.5),
           (f"{GROUP}.mlp.w_out", (L, f, d), f ** -0.5)]
    return embed_specs(model) + attn_specs(model) + mlp + norm_specs(model)


def norm(x: torch.Tensor, scale: torch.Tensor | None, kind: str) -> torch.Tensor:
    if kind == "nonparametric_ln":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5)
    if kind == "rmsnorm":
        y = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
        return y * (1.0 + scale)
    raise ValueError(f"unknown norm {kind!r}")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on ``x`` (B, S, heads, hd): the first and the
    second half of each head rotate as pairs."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(h: torch.Tensor, p: Params, layer: int, m: dict) -> torch.Tensor:
    B, S, _ = h.shape
    H, KV, hd = m["h"], m["kv"], m["hd"]
    q = (h @ p[f"{GROUP}.attn.wq"][layer]).view(B, S, H, hd)
    k = (h @ p[f"{GROUP}.attn.wk"][layer]).view(B, S, KV, hd)
    v = (h @ p[f"{GROUP}.attn.wv"][layer]).view(B, S, KV, hd)
    q, k = rope(q, m["theta"]), rope(k, m["theta"])
    kv_of = torch.arange(H, device=h.device) // (H // KV)
    k, v = k[:, :, kv_of], v[:, :, kv_of]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(B, S, H * hd) @ p[f"{GROUP}.attn.wo"][layer]


def swiglu(h: torch.Tensor, p: Params, layer: int) -> torch.Tensor:
    gate = F.silu(h @ p[f"{GROUP}.mlp.w_gate"][layer])
    return (gate * (h @ p[f"{GROUP}.mlp.w_in"][layer])) @ p[f"{GROUP}.mlp.w_out"][layer]


def _scale(p: Params, path: str, layer: int | None = None):
    t = p.get(path)
    if t is None:
        return None
    return t if layer is None else t[layer]


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed.table"][tokens.long()]


def head_loss(x: torch.Tensor, p: Params, targets: torch.Tensor, m: dict) -> torch.Tensor:
    x = norm(x, _scale(p, "final_norm.scale"), m["norm"])
    w = p["embed.table"].t() if m["tied"] else p["lm_head.w"]
    logits = x.reshape(-1, x.shape[-1]) @ w
    return F.cross_entropy(logits, targets.reshape(-1).long())


def forward_loss(p: Params, tokens: torch.Tensor, targets: torch.Tensor, model: dict,
                 ) -> torch.Tensor:
    """The training loss of one node's parameters on ``tokens`` (B, S)."""
    m = dims(model)
    x = embed(p, tokens)
    for layer in range(m["layers"]):
        h = norm(x, _scale(p, f"{GROUP}.attn_norm.scale", layer), m["norm"])
        x = x + attention(h, p, layer, m)
        h = norm(x, _scale(p, f"{GROUP}.mlp_norm.scale", layer), m["norm"])
        x = x + swiglu(h, p, layer)
    return head_loss(x, p, targets, m)
