"""Model assembly for the dense decoder-only LM (the port of
``repro.models.transformer``, dense family, tensor-parallel degree 1).

Layers are organized into **block groups**: maximal runs of consecutive
layers with the same (block kind, attention window).  Each group's params
are stacked on a leading layer axis, as in the reference, so a JAX-built
parameter tree converts leaf for leaf (:mod:`repro_torch.interop`).  Where
the reference scans a group with ``lax.scan``, the port loops over the
layers of the unbound stack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..utils import tree_leaves, tree_map
from . import attention as attn
from .layers import (
    Initializer,
    embed_lookup,
    embedding_init,
    lm_head_logits,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    softmax_xent_sharded,
)

Tree = Any

__all__ = ["GroupSpec", "block_groups", "init_params", "count_params", "forward_loss"]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str  # dense (the only kind of this slice)
    window: int  # 0 = full attention
    layers: tuple[int, ...]

    @property
    def count(self) -> int:
        return len(self.layers)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.arch_kind != "decoder" or cfg.moe or cfg.ssm or cfg.xlstm:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported "
            f"(family={cfg.family!r}, arch_kind={cfg.arch_kind!r})"
        )


def block_groups(cfg: ModelConfig) -> list[GroupSpec]:
    """Split layers into maximal same-(kind, window) runs."""
    _check_dense(cfg)
    groups: list[GroupSpec] = []
    run: list[int] = []
    cur = None
    for i in range(cfg.n_layers):
        w = cfg.window_for_layer(i)
        if w != cur and run:
            groups.append(GroupSpec("dense", cur, tuple(run)))
            run = []
        cur = w
        run.append(i)
    if run:
        groups.append(GroupSpec("dense", cur, tuple(run)))
    return groups


def _layer_init(init: Initializer, cfg: ModelConfig) -> Tree:
    d, nt = cfg.d_model, cfg.norm_type
    p = {"attn_norm": norm_init(init, nt, d), "attn": attn.attn_init(init, cfg)}
    if cfg.d_ff > 0:
        p["mlp_norm"] = norm_init(init, nt, d)
        p["mlp"] = mlp_init(init, d, cfg.d_ff, cfg.gated_mlp)
    return p


def _stack(trees: list[Tree]) -> Tree:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Tree:
    """One node's parameters, on the generator's device, in the reference's
    draw order (embed, layers in order, final norm, lm_head)."""
    init = Initializer(generator)
    vp = cfg.vocab_padded(1)
    params: Tree = {"embed": embedding_init(init, vp, cfg.d_model)}
    params["groups"] = {
        f"g{gi}": _stack([_layer_init(init, cfg) for _ in g.layers])
        for gi, g in enumerate(block_groups(cfg))
    }
    params["final_norm"] = norm_init(init, cfg.norm_type, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "w": init.normal((cfg.d_model, vp), 1.0 / math.sqrt(cfg.d_model))
        }
    return params


def count_params(params: Tree) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _block_fwd(x, lp, cfg: ModelConfig, g: GroupSpec, positions):
    nt = cfg.norm_type
    h = norm_apply(x, lp["attn_norm"], nt)
    x = x + attn.attn_forward(h, lp["attn"], cfg, positions=positions, causal=True,
                              window=g.window)
    if cfg.d_ff > 0:
        h2 = norm_apply(x, lp["mlp_norm"], nt)
        x = x + mlp_apply(h2, lp["mlp"], cfg.act)
    return x


def forward_loss(params: Tree, batch: dict, cfg: ModelConfig):
    """batch: tokens (B, S), targets (B, S).  Returns
    ``(loss, metrics)``; the dense family has no auxiliary losses, so the
    total is the cross entropy."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    table = params["embed"]["table"]
    x = embed_lookup(tokens, table)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for gi, g in enumerate(block_groups(cfg)):
        layers = tree_map(lambda t: t.unbind(0), params["groups"][f"g{gi}"])
        for li in range(g.count):
            lp = tree_map(lambda ts: ts[li], layers)
            x = _block_fwd(x, lp, cfg, g, positions)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    w = table.T if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = lm_head_logits(x, w)
    loss = softmax_xent_sharded(
        logits.reshape(B * S, -1), batch["targets"].reshape(-1), vocab_size=cfg.vocab_size
    )
    return loss, {"xent": loss}
