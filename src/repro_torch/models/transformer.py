"""Model assembly for the decoder-only families (the port of
``repro.models.transformer`` at tensor-parallel degree 1): dense, MoE
(granite-moe), hybrid attention + SSM heads (hymba), the VLM backbone with
its patch-embedding stub (internvl2) and the xLSTM stack; the training
forward and the serve path (cache, prefill, decode).  The encoder-decoder
(whisper) is not ported yet.

Layers are organized into **block groups**: maximal runs of consecutive
layers with the same (block kind, attention window).  Each group's params
are stacked on a leading layer axis, as in the reference, so a JAX-built
parameter tree converts leaf for leaf (:mod:`repro_torch.interop`) — an
empty subtree (olmo's parameter-free norms, ``{}``) included; so is each
group's serve cache: a rolling ``window``-slot kv buffer for a
sliding-window group, beside it the SSM state ``{"ssm": h, conv}`` for a
hybrid group, the recurrent state ``{"mlstm": C, n, m}`` or ``{"slstm": c,
n, m, h}`` for an xLSTM group.  Where the reference scans a group with
``lax.scan``, the port loops over the layers of the unbound stack.  A
config with ``rope_theta == 0`` (xlstm-350m) adds absolute sinusoidal
positions to the embedding instead of rotating q and k.  A hybrid layer
runs attention and the SSM on the same normed input and adds their mean;
a MoE layer's router losses sum over the layers into the training loss
(``xent + router_aux_weight * load_balance + 1e-3 * z``), as in the
reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..utils import tree_leaves, tree_map
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
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

__all__ = [
    "RuntimeConfig",
    "GroupSpec",
    "block_groups",
    "init_params",
    "count_params",
    "forward_loss",
    "init_cache",
    "prefill",
    "decode_step",
]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """What the serve path reads of the reference's ``RuntimeConfig``."""

    dtype: str = "bfloat16"  # activation/compute dtype
    attn_impl: str = "torch"  # torch (plain) | cuda (the flash-attention kernel)
    # decode attention: contract q-head groups against the raw KV cache
    # (no (H/KV)-times K/V materialization)
    decode_grouped_gqa: bool = False
    mlstm_impl: str = "torch"  # torch (plain) | cuda (the mlstm_chunk kernel)
    ssm_chunk: int = 128
    mlstm_chunk: int = 128

    @property
    def cdtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str  # dense | moe | hybrid | mlstm | slstm
    window: int  # 0 = full attention (for attn-bearing kinds)
    layers: tuple[int, ...]

    @property
    def count(self) -> int:
        return len(self.layers)

    @property
    def has_attn(self) -> bool:
        return self.kind in ("dense", "moe", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.kind == "hybrid"


def _check_ported(cfg: ModelConfig) -> None:
    """The decoder-only families are ported; the encoder-decoder is not."""
    if cfg.arch_kind != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (arch_kind={cfg.arch_kind!r}) is not ported "
            "yet (ROADMAP queue 1, the next slice)"
        )


def _layer_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.xlstm:
        return "slstm" if i in cfg.slstm_layers() else "mlstm"
    if cfg.ssm:
        return "hybrid"
    if cfg.moe:
        return "moe"
    return "dense"


def block_groups(cfg: ModelConfig) -> list[GroupSpec]:
    """Split layers into maximal same-(kind, window) runs."""
    _check_ported(cfg)
    groups: list[GroupSpec] = []
    run: list[int] = []
    cur = None
    for i in range(cfg.n_layers):
        sig = (_layer_kind(cfg, i), cfg.window_for_layer(i))
        if sig != cur and run:
            groups.append(GroupSpec(cur[0], cur[1], tuple(run)))
            run = []
        cur = sig
        run.append(i)
    if run:
        groups.append(GroupSpec(cur[0], cur[1], tuple(run)))
    return groups


def _layer_init(init: Initializer, cfg: ModelConfig, kind: str) -> Tree:
    d, nt = cfg.d_model, cfg.norm_type
    if kind == "mlstm":
        return {"norm": norm_init(init, nt, d), "mlstm": xlstm_mod.mlstm_init(init, cfg)}
    if kind == "slstm":
        return {"norm": norm_init(init, nt, d), "slstm": xlstm_mod.slstm_init(init, cfg)}
    p = {"attn_norm": norm_init(init, nt, d), "attn": attn.attn_init(init, cfg)}
    if kind == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(init, cfg)
    if cfg.d_ff > 0:
        p["mlp_norm"] = norm_init(init, nt, d)
        if kind == "moe":
            p["moe"] = moe_mod.moe_init(init, cfg)
        else:
            p["mlp"] = mlp_init(init, d, cfg.d_ff, cfg.gated_mlp)
    return p


def _stack(trees: list[Tree]) -> Tree:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> Tree:
    """One node's parameters, on the generator's device (or ``device``:
    ``"meta"`` gives shapes and dtypes only), in the reference's draw order
    (embed, layers in order, final norm, lm_head)."""
    init = Initializer(generator)
    if device is not None:
        init.device = torch.device(device)
    vp = cfg.vocab_padded(1)
    params: Tree = {"embed": embedding_init(init, vp, cfg.d_model)}
    params["groups"] = {
        f"g{gi}": _stack([_layer_init(init, cfg, g.kind) for _ in g.layers])
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


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal position embeddings (..., d) in f32."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _block_fwd(x, lp, cfg: ModelConfig, g: GroupSpec, positions, *,
               rt: RuntimeConfig = RuntimeConfig(), serve: bool = False):
    """One layer forward.  Returns ``(x, aux, entry)``: ``aux`` the MoE
    router's terms (empty for other kinds); with ``serve``, ``entry`` the
    layer's serve state — ``{"kv": (k, v)}`` over the whole sequence for an
    attention layer, plus ``{"ssm": state}`` for a hybrid one, the final
    recurrent state for an xLSTM layer (None without ``serve``)."""
    nt = cfg.norm_type
    if g.kind in ("mlstm", "slstm"):
        h = norm_apply(x, lp["norm"], nt)
        if g.kind == "mlstm":
            out = xlstm_mod.mlstm_forward(h, lp["mlstm"], cfg, chunk=rt.mlstm_chunk,
                                          impl=rt.mlstm_impl, return_state=serve)
        else:
            out = xlstm_mod.slstm_forward(h, lp["slstm"], cfg, return_state=serve)
        y, st = out if serve else (out, None)
        return x + y, {}, ({g.kind: st} if serve else None)
    h = norm_apply(x, lp["attn_norm"], nt)
    a = attn.attn_forward(h, lp["attn"], cfg, positions=positions, causal=True,
                          window=g.window, attn_impl=rt.attn_impl, return_kv=serve)
    entry = None
    if serve:
        a, kv = a
        entry = {"kv": kv}
    if g.has_ssm:
        s = ssm_mod.ssm_forward(h, lp["ssm"], cfg, chunk=rt.ssm_chunk, return_state=serve)
        if serve:
            s, entry["ssm"] = s
        x = x + 0.5 * (a + s)  # hymba: parallel heads, mean combine
    else:
        x = x + a
    aux = {}
    if cfg.d_ff > 0:
        h2 = norm_apply(x, lp["mlp_norm"], nt)
        if g.kind == "moe":
            y2, aux = moe_mod.moe_forward(h2, lp["moe"], cfg)
        else:
            y2 = mlp_apply(h2, lp["mlp"], cfg.act)
        x = x + y2
    return x, aux, entry


def _layers(group_params: Tree, count: int) -> list[Tree]:
    """A layer-stacked group's params as one tree per layer (views)."""
    split = tree_map(lambda t: t.unbind(0), group_params)
    return [tree_map(lambda ts: ts[li], split) for li in range(count)]


def _embed(tokens, params, cfg: ModelConfig, dtype, positions, patch_embeds=None):
    """Token embeddings in ``dtype``; a VLM's ``patch_embeds`` (B, P, d), when
    given, replace the first P positions (the vision frontend's stub); with
    ``rope_theta == 0`` plus the absolute sinusoidal embeddings of
    ``positions`` (broadcast to tokens)."""
    x = embed_lookup(tokens, params["embed"]["table"].to(dtype))
    if cfg.family == "vlm" and patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(dtype), x[:, n:]], dim=1)
    if cfg.rope_theta == 0:
        x = x + _sinusoid(positions, cfg.d_model).to(dtype)
    return x


_AUX = ("moe_load_balance", "moe_router_z")


def _run_groups(x, params, cfg: ModelConfig, positions, rt: RuntimeConfig, serve: bool):
    """Every block group in order.  Returns ``(x, aux totals, entries)``:
    the router terms summed over each MoE group's layers, then over the
    groups (the reference's order); ``entries[gi]`` the layers' serve
    entries (with ``serve``)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_tot = {k: zero for k in _AUX}
    entries = {}
    for gi, g in enumerate(block_groups(cfg)):
        group_aux = {k: [] for k in _AUX}
        layer_entries = []
        for lp in _layers(params["groups"][f"g{gi}"], g.count):
            x, aux, entry = _block_fwd(x, lp, cfg, g, positions, rt=rt, serve=serve)
            for k in aux.keys() & group_aux.keys():
                group_aux[k].append(aux[k])
            layer_entries.append(entry)
        for k, vals in group_aux.items():
            if vals:
                aux_tot[k] = aux_tot[k] + torch.sum(torch.stack(vals))
        entries[gi] = layer_entries
    return x, aux_tot, entries


def forward_loss(params: Tree, batch: dict, cfg: ModelConfig,
                 rt: RuntimeConfig = RuntimeConfig(dtype="float32")):
    """batch: tokens (B, S), targets (B, S) [, patch_embeds (B, P, d) for a
    VLM].  Returns ``(total, metrics)``: the total is the cross entropy plus
    the MoE router terms, ``xent + router_aux_weight * moe_load_balance +
    1e-3 * moe_router_z`` (both zero without MoE layers), and the metrics
    are ``xent`` and the two router terms.  Activations compute in
    ``rt.cdtype``: the embedding table and the lm_head (or tied) weights are
    cast to it where the reference casts them, and every layer casts its
    weights to the activations' dtype.  mLSTM layers run the cell's plain
    version, as the reference trains with ``mlstm_impl="ref"`` (the kernel
    has no backward), and attention its plain path (``attn_impl="jnp"``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dt = rt.cdtype
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(tokens, params, cfg, dt, positions, batch.get("patch_embeds"))
    x, aux, _ = _run_groups(x, params, cfg, positions,
                            dataclasses.replace(rt, attn_impl="torch", mlstm_impl="torch"),
                            serve=False)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = lm_head_logits(x, w.to(dt))
    loss = softmax_xent_sharded(
        logits.reshape(B * S, -1), batch["targets"].reshape(-1), vocab_size=cfg.vocab_size
    )
    if cfg.moe:
        total = (loss + cfg.router_aux_weight * aux["moe_load_balance"]
                 + 1e-3 * aux["moe_router_z"])
    else:  # the router terms are zeros: the reference's sum is the cross entropy
        total = loss
    return total, {"xent": loss, **aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _group_capacity(g: GroupSpec, target_len: int) -> int:
    return min(g.window, target_len) if g.window > 0 else target_len


def init_cache(cfg: ModelConfig, batch: int, target_len: int, rt: RuntimeConfig,
               device=None) -> Tree:
    """Serve cache: per block group (layer-stacked) ``{"kv": ...}`` for an
    attention group, and ``{"ssm": ...}`` beside it for a hybrid group;
    ``{"mlstm": ...}`` or ``{"slstm": ...}`` for an xLSTM group."""
    cache: Tree = {}
    for gi, g in enumerate(block_groups(cfg)):
        c: Tree = {}
        if g.has_attn:
            c["kv"] = attn.init_kv_cache(cfg, g.count, batch, _group_capacity(g, target_len),
                                         rt.cdtype, device)
        if g.has_ssm:
            c["ssm"] = ssm_mod.init_ssm_state(cfg, g.count, batch, device)
        if g.kind == "mlstm":
            c["mlstm"] = xlstm_mod.init_mlstm_state(cfg, g.count, batch, device)
        if g.kind == "slstm":
            c["slstm"] = xlstm_mod.init_slstm_state(cfg, g.count, batch, device)
        cache[f"g{gi}"] = c
    return cache


def _roll_into_cache(k_full: torch.Tensor, v_full: torch.Tensor, cap: int) -> Tree:
    """(Lg, B, S, KV, hd) full-sequence kv -> a ``cap``-slot rolling cache.

    Slot j holds the largest position p < S with p % cap == j, or is empty
    (pos -1; its k/v are position 0's, as in the reference's gather)."""
    Lg, B, S = k_full.shape[:3]
    j = torch.arange(cap, device=k_full.device)
    p = cap * torch.div(S - 1 - j, cap, rounding_mode="floor") + j
    p = torch.where((p >= 0) & (p < S), p, -1)
    idx = torch.clamp(p, min=0)
    return {
        "k": k_full.index_select(2, idx),
        "v": v_full.index_select(2, idx),
        "pos": p.to(torch.int32)[None, None].expand(Lg, B, cap).contiguous(),
    }


def _logits(x, params, cfg: ModelConfig, rt: RuntimeConfig):
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return lm_head_logits(x[:, -1], w.to(rt.cdtype))


def prefill(params: Tree, batch: dict, cfg: ModelConfig, rt: RuntimeConfig, *,
            target_len: int | None = None):
    """Full-sequence prefill of ``batch["tokens"]`` (B, S) [and a VLM's
    ``patch_embeds``]: returns the last-token logits (B, Vp) and the serve
    cache for ``target_len`` positions (default S)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    target_len = target_len or S
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(tokens, params, cfg, rt.cdtype, positions, batch.get("patch_embeds"))
    x, _, entries = _run_groups(x, params, cfg, positions, rt, serve=True)
    cache: Tree = {}
    for gi, g in enumerate(block_groups(cfg)):
        layer_entries = entries.pop(gi)
        c: Tree = {}
        if g.has_attn:
            ks, vs = zip(*(e["kv"] for e in layer_entries))
            c["kv"] = _roll_into_cache(torch.stack(ks), torch.stack(vs),
                                       _group_capacity(g, target_len))
        for name in ("ssm", "mlstm", "slstm"):
            if name in layer_entries[0]:
                c[name] = _stack([e[name] for e in layer_entries])
        cache[f"g{gi}"] = c
        del layer_entries
    return _logits(x, params, cfg, rt), cache


def decode_step(params: Tree, tokens: torch.Tensor, cache: Tree, t, cfg: ModelConfig,
                rt: RuntimeConfig, *, target_len: int):
    """One-token decode.  tokens: (B, 1); ``t``: the new token's absolute
    position, an int or a per-slot (B,) tensor (continuous batching serves
    requests whose timelines are independent).  The cache is updated **in
    place** (the reference donates it): the new kv into its slot, the new
    recurrent state over the old.  Returns ``(logits (B, Vp), cache)``."""
    B = tokens.shape[0]
    t = torch.as_tensor(t, device=tokens.device).to(torch.long).expand(B)
    x = _embed(tokens, params, cfg, rt.cdtype, t[:, None])
    nt = cfg.norm_type
    for gi, g in enumerate(block_groups(cfg)):
        cg = cache[f"g{gi}"]
        if g.has_attn and cg["kv"]["k"].shape[2] != _group_capacity(g, target_len):
            raise ValueError(f"cache group g{gi} holds {cg['kv']['k'].shape[2]} slots; "
                             f"target_len {target_len} gives {_group_capacity(g, target_len)}")
        for li, lp in enumerate(_layers(params["groups"][f"g{gi}"], g.count)):
            if not g.has_attn:
                step = (xlstm_mod.mlstm_decode_step if g.kind == "mlstm"
                        else xlstm_mod.slstm_decode_step)
                y = _recurrent_step(step, norm_apply(x, lp["norm"], nt), lp[g.kind],
                                    cg[g.kind], li, cfg)
                x = x + y
                continue
            h = norm_apply(x, lp["attn_norm"], nt)
            layer_cache = {n: c[li] for n, c in cg["kv"].items()}
            a, _ = attn.attn_decode_step(h, lp["attn"], layer_cache, cfg, t=t,
                                         window=g.window, grouped=rt.decode_grouped_gqa)
            if g.has_ssm:
                s = _recurrent_step(ssm_mod.ssm_decode_step, h, lp["ssm"], cg["ssm"], li, cfg)
                x = x + 0.5 * (a + s)
            else:
                x = x + a
            if cfg.d_ff > 0:
                h2 = norm_apply(x, lp["mlp_norm"], nt)
                if g.kind == "moe":
                    y2, _ = moe_mod.moe_forward(h2, lp["moe"], cfg)
                else:
                    y2 = mlp_apply(h2, lp["mlp"], cfg.act)
                x = x + y2
    return _logits(x, params, cfg, rt), cache


def _recurrent_step(step, h, lp, group_state: Tree, li: int, cfg: ModelConfig):
    """Layer ``li``'s recurrent decode ``step`` on its slice of the
    layer-stacked ``group_state``, which takes the new state in place."""
    state = {n: c[li] for n, c in group_state.items()}
    y, new = step(h, lp, state, cfg)
    for n, c in state.items():
        c.copy_(new[n])
    return y
