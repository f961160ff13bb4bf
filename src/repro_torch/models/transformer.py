"""Model assembly (the port of ``repro.models.transformer``): dense, MoE
(granite-moe), hybrid attention + SSM heads (hymba), the VLM backbone with its patch-embedding stub (internvl2),
the xLSTM stack and the encoder-decoder (whisper); the training forward and
the serve path (cache, prefill, decode).

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
positions to the embedding instead of rotating q and k.  The
encoder-decoder's encoder (``params["enc"]``, kind ``"enc"``) runs
non-causally over the stub frame embeddings ``enc_frames`` (B, T_enc, d)
plus their sinusoids, then ``enc_norm``; each decoder layer (kind ``"dec"``)
adds a cross-attention over the encoder's output after its self-attention,
and its serve cache holds the cross k/v (``cross_kv``, (count, B, T_enc, KV,
hd)) beside the self-attention kv.  A hybrid layer
runs attention and the SSM on the same normed input and adds their mean;
a MoE layer's router losses sum over the layers into the training loss
(``xent + router_aux_weight * load_balance + 1e-3 * z``), as in the
reference (DeepSeek's ``seq_aux`` router: ``xent + router_aux_weight *
load_balance``).  A MoE model's ``first_dense_layers`` leading layers are
dense (kind ``"dense"``, an MLP of width ``d_ff``; its experts take
``moe_d_ff``), and a config with ``kv_lora_rank`` set attends with
multi-head latent attention (:func:`~.attention.mla_forward`), in training
only: MLA has no serve cache and no tensor-parallel path yet
(:func:`check_tp`).

Tensor parallelism (a :class:`~repro_torch.models.layers.TPContext` of
size > 1, passed as ``tp``) covers every family, as the reference's: the
parameters are the rank's shards of :func:`init_params` at that tp, cut
along :func:`param_shard_axes` (:mod:`repro_torch.interop`), the vocab
sharded over the model group (the embedding by rows, the lm_head by
columns, the loss and the lookup summed over the group; a VLM's
``patch_embeds`` spliced after the joined lookup), attention and the MLP
Megatron's, the MoE experts by expert or inside each expert
(:mod:`.moe`), mLSTM on its value dimension and sLSTM replicated
(:mod:`.xlstm`), the SSM on its channels (:mod:`.ssm`), and the
encoder-decoder's encoder and cross-attention on the rank's heads.  The
serve cache is sharded as the reference's ``cache_specs``: the kv cache by
sequence, the mLSTM memory on its value columns, the SSM state on its
channels; prefill's and decode's logits are the rank's vocab shard.  The
encoder-decoder trains at tp > 1 but does not serve there: the
reference's own sharded serving of it fails (:func:`check_tp`).
"""

from __future__ import annotations

import dataclasses
import functools
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
    TPContext,
    embed_lookup,
    embedding_init,
    lm_head_logits,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    softmax_xent_sharded,
    zero_pad,
)

Tree = Any

__all__ = [
    "RuntimeConfig",
    "GroupSpec",
    "block_groups",
    "init_params",
    "param_shard_axes",
    "check_tp",
    "count_params",
    "forward_loss",
    "init_cache",
    "cache_shard_axes",
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
    kind: str  # dense | moe | hybrid | mlstm | slstm | enc | dec
    window: int  # 0 = full attention (for attn-bearing kinds)
    layers: tuple[int, ...]

    @property
    def count(self) -> int:
        return len(self.layers)

    @property
    def has_attn(self) -> bool:
        return self.kind in ("dense", "moe", "hybrid", "enc", "dec")

    @property
    def has_ssm(self) -> bool:
        return self.kind == "hybrid"


def _layer_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.xlstm:
        return "slstm" if i in cfg.slstm_layers() else "mlstm"
    if cfg.ssm:
        return "hybrid"
    if cfg.moe and i >= cfg.first_dense_layers:
        return "moe"
    return "dense"


def block_groups(cfg: ModelConfig, *, stack: str = "dec") -> list[GroupSpec]:
    """Split layers into maximal same-(kind, window) runs; ``stack="enc"``
    gives the encoder's (every layer kind ``"enc"``, window 0)."""
    n = cfg.n_enc_layers if stack == "enc" else cfg.n_layers
    groups: list[GroupSpec] = []
    run: list[int] = []
    cur = None
    for i in range(n):
        if stack == "enc":
            sig = ("enc", 0)
        else:
            kind = "dec" if cfg.arch_kind == "encdec" else _layer_kind(cfg, i)
            sig = (kind, cfg.window_for_layer(i))
        if sig != cur and run:
            groups.append(GroupSpec(cur[0], cur[1], tuple(run)))
            run = []
        cur = sig
        run.append(i)
    if run:
        groups.append(GroupSpec(cur[0], cur[1], tuple(run)))
    return groups


def _layer_init(init: Initializer, cfg: ModelConfig, kind: str, tp: int = 1) -> Tree:
    d, nt = cfg.d_model, cfg.norm_type
    if kind == "mlstm":
        return {"norm": norm_init(init, nt, d), "mlstm": xlstm_mod.mlstm_init(init, cfg)}
    if kind == "slstm":
        return {"norm": norm_init(init, nt, d), "slstm": xlstm_mod.slstm_init(init, cfg)}
    p = {"attn_norm": norm_init(init, nt, d),
         "attn": attn.mla_init(init, cfg) if cfg.mla else attn.attn_init(init, cfg, tp)}
    if kind == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(init, cfg)
    if kind == "dec" and cfg.arch_kind == "encdec":
        p["cross_norm"] = norm_init(init, nt, d)
        p["cross"] = attn.attn_init(init, cfg, tp)
    if cfg.d_ff > 0:
        p["mlp_norm"] = norm_init(init, nt, d)
        if kind == "moe":
            p["moe"] = moe_mod.moe_init(init, cfg)
        else:
            p["mlp"] = mlp_init(init, d, cfg.d_ff, cfg.gated_mlp)
    return p


def _stack(trees: list[Tree]) -> Tree:
    def stack(*xs):
        if xs[0].device.type == "meta":  # shapes only: torch.stack on meta tensors
            # loads torch._dynamo (seconds a process)
            return torch.empty((len(xs),) + tuple(xs[0].shape), dtype=xs[0].dtype,
                               device="meta")
        return torch.stack(xs, dim=0)

    return tree_map(stack, *trees)


def _groups_init(init: Initializer, cfg: ModelConfig, stack: str = "dec", tp: int = 1) -> Tree:
    """``{"g<i>": layer-stacked params}`` of one stack's block groups."""
    return {f"g{gi}": _stack([_layer_init(init, cfg, g.kind, tp) for _ in g.layers])
            for gi, g in enumerate(block_groups(cfg, stack=stack))}


# the reference's fault that keeps the encoder-decoder from serving at tp > 1
ENCDEC_SERVE_FAULT = (
    "the reference's sharded serving of the encoder-decoder fails: its _encode "
    "(src/repro/models/transformer.py:408-418) runs the encoder's self-attention with "
    "serve=False, which shards k/v by head, while serve_specs lays the encoder's k/v "
    "projections out replicated (TypeError: cannot reshape array of shape (2, 16, 64) into "
    "shape (2, 16, 2, 16) at tp 2)")


def check_tp(cfg: ModelConfig, tp: int, *, serve: bool = False) -> None:
    """Raise unless ``cfg`` runs at tensor-parallel degree ``tp``: every
    family of the reference trains there; the encoder-decoder does not serve
    at tp > 1 (``serve``), as the reference cannot.  Latent attention (MLA)
    trains at tp = 1 only and serves nowhere: its latent kv cache, its decode
    step and its sharding (with those of the shared experts and of a chip's
    held block of experts) are not ported (ROADMAP.md)."""
    if cfg.mla and serve:
        raise NotImplementedError(
            f"{cfg.name} serving: multi-head latent attention has no serve path (its latent "
            "kv cache and decode step are not ported; ROADMAP.md); train it at tp = 1")
    if tp == 1:
        return
    if cfg.mla or cfg.n_shared_experts or cfg.experts_held:
        raise NotImplementedError(
            f"{cfg.name} at tp={tp}: multi-head latent attention, shared experts and a held "
            "block of experts have no tensor-parallel path (ROADMAP.md); train it at tp = 1")
    if serve and cfg.arch_kind == "encdec":
        raise NotImplementedError(
            f"{cfg.name} serving at tp={tp}: {ENCDEC_SERVE_FAULT}; serve it at tp = 1 "
            "(ROADMAP.md §3)")
    if cfg.d_ff > 0 and not cfg.moe and cfg.d_ff % tp:
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} is not divisible by tp={tp}")
    if cfg.xlstm and xlstm_mod._head_dims(cfg)[1] % tp:
        raise ValueError(f"{cfg.name}: the mLSTM head dim {xlstm_mod._head_dims(cfg)[1]} is "
                         f"not divisible by tp={tp}")
    if cfg.ssm and cfg.d_ssm_inner % tp:
        raise ValueError(f"{cfg.name}: d_ssm {cfg.d_ssm_inner} is not divisible by tp={tp}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None, tp: int = 1) -> Tree:
    """One node's global parameters, on the generator's device (or
    ``device``: ``"meta"`` gives shapes and dtypes only), in the reference's
    draw order (embed, the encoder's layers and norm, layers in order, final
    norm, lm_head), padded for tensor-parallel degree ``tp`` to the
    reference's shapes (q heads and the vocab to a multiple of ``tp``).  The
    padding is zeros and takes no draw, so the real entries are the same at
    every tp (the reference draws the padded shapes, so its tp = 1 and tp > 1
    inits differ).  No padded entry reaches an output: padded heads are
    masked, padded vocab rows are never looked up and their logits are
    masked in the loss."""
    init = Initializer(generator)
    if device is not None:
        init.device = torch.device(device)
    vp = cfg.vocab_padded(tp)
    params: Tree = {"embed": embedding_init(init, vp, cfg.d_model, cfg.vocab_size)}
    if cfg.arch_kind == "encdec":
        params["enc"] = _groups_init(init, cfg, stack="enc", tp=tp)
        params["enc_norm"] = norm_init(init, cfg.norm_type, cfg.d_model)
    params["groups"] = _groups_init(init, cfg, tp=tp)
    params["final_norm"] = norm_init(init, cfg.norm_type, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": zero_pad(
            init.normal((cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model)), 1, vp)}
    return params


_NORM_LEAVES = {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"), "nonparametric_ln": ()}


def param_shard_axes(cfg: ModelConfig, tp: int = 1, serve: bool = False) -> Tree:
    """The counterpart of the reference's ``param_specs``: for each leaf of
    :func:`init_params`'s tree, the axis split over the model group (None:
    replicated; a group's leaves count their layer axis).  ``serve=True``
    keeps k and v replicated."""
    check_tp(cfg, tp)

    def norm(tree):
        return {k: None for k in tree}

    def stacked(axes):  # the layer axis comes first
        return {k: stacked(a) if isinstance(a, dict) else None if a is None else a + 1
                for k, a in axes.items()}

    def layer(kind: str):
        init = Initializer(torch.Generator())
        init.device = torch.device("meta")
        p = _layer_init(init, cfg, kind, tp)
        if kind in ("mlstm", "slstm"):
            axes = (xlstm_mod.mlstm_shard_axes() if kind == "mlstm"
                    else {k: None for k in p[kind]})
            return {"norm": norm(p["norm"]), kind: stacked(axes)}
        att = ({k: None for k in p["attn"]} if cfg.mla
               else stacked(attn.attn_shard_axes(cfg, tp, serve)))
        out = {"attn_norm": norm(p["attn_norm"]), "attn": att}
        if "ssm" in p:
            out["ssm"] = stacked(ssm_mod.ssm_shard_axes())
        if "cross" in p:
            out["cross_norm"] = norm(p["cross_norm"])
            out["cross"] = dict(att)
        if "mlp" in p:
            out["mlp_norm"] = norm(p["mlp_norm"])
            out["mlp"] = {k: 2 if k in ("w_in", "w_gate") else 1 for k in p["mlp"]}
        if "moe" in p:
            out["mlp_norm"] = norm(p["mlp_norm"])
            out["moe"] = stacked(moe_mod.moe_shard_axes(cfg, tp))
        return out

    axes: Tree = {"embed": {"table": 0}}
    if cfg.arch_kind == "encdec":
        axes["enc"] = {f"g{gi}": layer(g.kind)
                       for gi, g in enumerate(block_groups(cfg, stack="enc"))}
        axes["enc_norm"] = {k: None for k in _NORM_LEAVES[cfg.norm_type]}
    axes["groups"] = {f"g{gi}": layer(g.kind) for gi, g in enumerate(block_groups(cfg))}
    axes["final_norm"] = {k: None for k in _NORM_LEAVES[cfg.norm_type]}
    if not cfg.tie_embeddings:
        axes["lm_head"] = {"w": 1}
    return axes


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
               rt: RuntimeConfig = RuntimeConfig(), serve: bool = False, enc_out=None,
               tp: TPContext | None = None):
    """One layer forward.  Returns ``(x, aux, entry)``: ``aux`` the MoE
    router's terms (empty for other kinds); with ``serve``, ``entry`` the
    layer's serve state — ``{"kv": (k, v)}`` over the whole sequence for an
    attention layer, plus ``{"ssm": state}`` for a hybrid one and
    ``{"cross_kv": (k, v)}`` over the encoder's output for a decoder layer
    of the encoder-decoder, the final recurrent state for an xLSTM layer
    (None without ``serve``).  Self-attention is causal but in the
    encoder."""
    nt = cfg.norm_type
    if g.kind in ("mlstm", "slstm"):
        h = norm_apply(x, lp["norm"], nt)
        if g.kind == "mlstm":
            out = xlstm_mod.mlstm_forward(h, lp["mlstm"], cfg, chunk=rt.mlstm_chunk,
                                          impl=rt.mlstm_impl, return_state=serve, tp=tp)
        else:
            out = xlstm_mod.slstm_forward(h, lp["slstm"], cfg, return_state=serve)
        y, st = out if serve else (out, None)
        return x + y, {}, ({g.kind: st} if serve else None)
    h = norm_apply(x, lp["attn_norm"], nt)
    if cfg.mla:  # training only (check_tp refuses serving)
        a = attn.mla_forward(h, lp["attn"], cfg, positions=positions)
    else:
        a = attn.attn_forward(h, lp["attn"], cfg, positions=positions, causal=g.kind != "enc",
                              window=g.window, attn_impl=rt.attn_impl, return_kv=serve, tp=tp,
                              serve=serve)
    entry = None
    if serve:
        a, kv = a
        entry = {"kv": kv}
    if g.has_ssm:
        s = ssm_mod.ssm_forward(h, lp["ssm"], cfg, chunk=rt.ssm_chunk, return_state=serve,
                                tp=tp)
        if serve:
            s, entry["ssm"] = s
        x = x + 0.5 * (a + s)  # hymba: parallel heads, mean combine
    else:
        x = x + a
    if g.kind == "dec" and cfg.arch_kind == "encdec" and enc_out is not None:
        c = norm_apply(x, lp["cross_norm"], nt)
        cr = attn.attn_forward(c, lp["cross"], cfg, positions=positions, causal=False,
                               window=0, attn_impl=rt.attn_impl, return_kv=serve,
                               kv_source=enc_out, tp=tp, serve=serve)
        if serve:
            cr, entry["cross_kv"] = cr
        x = x + cr
    aux = {}
    if cfg.d_ff > 0:
        h2 = norm_apply(x, lp["mlp_norm"], nt)
        if g.kind == "moe":
            y2, aux = moe_mod.moe_forward(h2, lp["moe"], cfg, tp)
        else:
            y2 = mlp_apply(h2, lp["mlp"], cfg.act, tp)
        x = x + y2
    return x, aux, entry


def _layers(group_params: Tree, count: int) -> list[Tree]:
    """A layer-stacked group's params as one tree per layer (views)."""
    split = tree_map(lambda t: t.unbind(0), group_params)
    return [tree_map(lambda ts: ts[li], split) for li in range(count)]


def _embed(tokens, params, cfg: ModelConfig, dtype, positions, patch_embeds=None, tp=None):
    """Token embeddings in ``dtype``; a VLM's ``patch_embeds`` (B, P, d), when
    given, replace the first P positions (the vision frontend's stub); with
    ``rope_theta == 0`` plus the absolute sinusoidal embeddings of
    ``positions`` (broadcast to tokens)."""
    x = embed_lookup(tokens, params["embed"]["table"].to(dtype), tp)
    if cfg.family == "vlm" and patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(dtype), x[:, n:]], dim=1)
    if cfg.rope_theta == 0:
        x = x + _sinusoid(positions, cfg.d_model).to(dtype)
    return x


_AUX = ("moe_load_balance", "moe_router_z")


def _run_groups(x, groups_params, cfg: ModelConfig, positions, rt: RuntimeConfig,
                serve: bool, *, stack: str = "dec", enc_out=None, collect_rows: bool = False,
                tp: TPContext | None = None):
    """Every block group of ``stack`` in order, over ``groups_params``
    (``params["groups"]``, or the encoder's ``params["enc"]``).  Returns
    ``(x, aux totals, entries)``: the router terms summed over each MoE
    group's layers, then over the groups (the reference's order);
    ``entries[gi]`` the layers' serve entries (with ``serve``).
    ``collect_rows`` adds ``aux["_row_info"]``: each MoE group's
    layer-stacked ``(Lg, E)`` expert-hit masks under ``"moe/g<gi>"`` (the
    :class:`~repro_torch.sparse.RowTracker` source names)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_tot = {k: zero for k in _AUX}
    entries, row_info = {}, {}
    for gi, g in enumerate(block_groups(cfg, stack=stack)):
        group_aux = {k: [] for k in _AUX}
        hits = []
        layer_entries = []
        for lp in _layers(groups_params[f"g{gi}"], g.count):
            x, aux, entry = _block_fwd(x, lp, cfg, g, positions, rt=rt, serve=serve,
                                       enc_out=enc_out, tp=tp)
            for k in aux.keys() & group_aux.keys():
                group_aux[k].append(aux[k])
            if "moe_expert_hits" in aux:
                hits.append(aux["moe_expert_hits"].detach())
            layer_entries.append(entry)
        for k, vals in group_aux.items():
            if vals:
                aux_tot[k] = aux_tot[k] + torch.sum(torch.stack(vals))
        if collect_rows and hits:
            row_info[f"moe/g{gi}"] = torch.stack(hits)
        entries[gi] = layer_entries
    if collect_rows:
        aux_tot["_row_info"] = row_info
    return x, aux_tot, entries


def _encode(params: Tree, batch: dict, cfg: ModelConfig, rt: RuntimeConfig,
            tp: TPContext | None = None):
    """The whisper encoder over the stub frame embeddings ``enc_frames``
    (B, T_enc, d): plus the sinusoids of 0..T_enc-1, the encoder's groups
    non-causally (on the rank's heads at tp > 1), then ``enc_norm``."""
    if "enc_frames" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: the batch needs 'enc_frames' "
                         f"(B, {cfg.enc_seq}, {cfg.d_model}), the frontend stub's output")
    dt = rt.cdtype
    frames = batch["enc_frames"].to(dt)
    B, T = frames.shape[:2]
    pos = torch.arange(T, device=frames.device)
    x = frames + _sinusoid(pos, cfg.d_model)[None].to(dt)
    x, _, _ = _run_groups(x, params["enc"], cfg, pos[None].expand(B, T), rt, serve=False,
                          stack="enc", tp=tp)
    return norm_apply(x, params["enc_norm"], cfg.norm_type)


def forward_loss(params: Tree, batch: dict, cfg: ModelConfig,
                 rt: RuntimeConfig = RuntimeConfig(dtype="float32"), *,
                 collect_rows: bool = False, tp: TPContext | None = None):
    """batch: tokens (B, S), targets (B, S) [, patch_embeds (B, P, d) for a
    VLM, enc_frames (B, T_enc, d) for the encoder-decoder].  Returns
    ``(total, metrics)``: the total is the cross entropy plus the MoE router
    terms, ``xent + router_aux_weight * moe_load_balance +
    1e-3 * moe_router_z`` (both zero without MoE layers; no z term with the
    ``seq_aux`` router, whose ``moe_router_z`` stays zero), and the metrics
    are ``xent`` and the two router terms.  Activations compute in
    ``rt.cdtype``: the embedding table and the lm_head (or tied) weights are
    cast to it where the reference casts them, and every layer casts its
    weights to the activations' dtype.  mLSTM layers run the cell's plain
    version, as the reference trains with ``mlstm_impl="ref"`` (the kernel
    has no backward), and attention its plain path (``attn_impl="jnp"``).
    ``collect_rows`` adds ``metrics["_row_info"]`` (see :func:`_run_groups`)
    for row-sparse gossip.  With ``tp`` the parameters are the rank's
    shards and the loss is the same on every rank of the group."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dt = rt.cdtype
    _check_ctx(cfg, tp)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(tokens, params, cfg, dt, positions, batch.get("patch_embeds"), tp)
    rt = dataclasses.replace(rt, attn_impl="torch", mlstm_impl="torch")
    enc_out = _encode(params, batch, cfg, rt, tp) if cfg.arch_kind == "encdec" else None
    x, aux, _ = _run_groups(x, params["groups"], cfg, positions, rt, serve=False,
                            enc_out=enc_out, collect_rows=collect_rows, tp=tp)
    row_info = aux.pop("_row_info", None)
    logits = _head(x, params, cfg, dt, tp)
    loss = softmax_xent_sharded(
        logits.reshape(B * S, -1), batch["targets"].reshape(-1), vocab_size=cfg.vocab_size,
        tp=tp,
    )
    if cfg.moe and cfg.router_loss == "seq_aux":
        total = loss + cfg.router_aux_weight * aux["moe_load_balance"]
    elif cfg.moe:
        total = (loss + cfg.router_aux_weight * aux["moe_load_balance"]
                 + 1e-3 * aux["moe_router_z"])
    else:  # the router terms are zeros: the reference's sum is the cross entropy
        total = loss
    metrics = {"xent": loss, **aux}
    if row_info is not None:
        metrics["_row_info"] = row_info
    return total, metrics


def _check_ctx(cfg: ModelConfig, tp: TPContext | None, serve: bool = False) -> None:
    check_tp(cfg, tp.size if tp is not None else 1, serve=serve)


def _head(x, params, cfg: ModelConfig, dtype, tp: TPContext | None, last: bool = False):
    """The final norm and the lm_head (or tied) logits (of the last position
    only with ``last``): the rank's vocab shard at tp > 1."""
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    if last:
        x = x[:, -1]
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    if tp is not None:
        x = tp.copy_in(x)
    return lm_head_logits(x, w.to(dtype))


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _group_capacity(g: GroupSpec, target_len: int, tp: int = 1) -> int:
    """Global slots of a group's cache, rounded up to a multiple of tp."""
    cap = min(g.window, target_len) if g.window > 0 else target_len
    return -(-cap // tp) * tp


def init_cache(cfg: ModelConfig, batch: int, target_len: int, rt: RuntimeConfig,
               device=None, tp: int = 1) -> Tree:
    """Serve cache: per block group (layer-stacked) ``{"kv": ...}`` for an
    attention group, and ``{"ssm": ...}`` beside it for a hybrid group and
    ``{"cross_kv": ...}`` (count, batch, enc_seq, KV, hd) for a decoder group
    of the encoder-decoder; ``{"mlstm": ...}`` or ``{"slstm": ...}`` for an
    xLSTM group.  At tp > 1 each leaf is the rank's shard along
    :func:`cache_shard_axes` (the kv cache's slots, the mLSTM memory's value
    columns, the SSM state's channels)."""
    check_tp(cfg, tp, serve=True)
    cache: Tree = {}
    for gi, g in enumerate(block_groups(cfg)):
        c: Tree = {}
        if g.has_attn:
            c["kv"] = attn.init_kv_cache(cfg, g.count, batch,
                                         _group_capacity(g, target_len, tp), rt.cdtype, device,
                                         tp)
        if g.has_ssm:
            c["ssm"] = ssm_mod.init_ssm_state(cfg, g.count, batch, device, tp)
        if g.kind == "mlstm":
            c["mlstm"] = xlstm_mod.init_mlstm_state(cfg, g.count, batch, device, tp)
        if g.kind == "slstm":
            c["slstm"] = xlstm_mod.init_slstm_state(cfg, g.count, batch, device)
        if g.kind == "dec" and cfg.arch_kind == "encdec":
            shape = (g.count, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
            c["cross_kv"] = {n: torch.zeros(shape, dtype=rt.cdtype, device=device)
                             for n in ("k", "v")}
        cache[f"g{gi}"] = c
    return cache


def cache_shard_axes(cfg: ModelConfig, tp: int = 1) -> Tree:
    """The counterpart of the reference's ``cache_specs``: for each leaf of
    :func:`init_cache`'s tree the axis sharded over the model group (after
    the layer and batch axes): the kv cache's slots (2), the mLSTM memory
    ``C``'s value columns (4), the SSM state ``h``'s channels (2) and its
    conv tail's (3); None elsewhere (a recurrent leaf whose width ``tp``
    does not divide stays whole, as :func:`init_cache` keeps it).  The batch
    axis (1) splits over the nodes where the batch does."""
    meta = init_cache(cfg, 1, 1, RuntimeConfig(), device="meta")
    dh = xlstm_mod._head_dims(cfg)[1] if cfg.xlstm else 0
    split = {"kv": {"k": 2, "v": 2, "pos": 2},
             "mlstm": {"C": 4 if dh % tp == 0 else None},
             "ssm": {"h": 2, "conv": 3} if cfg.ssm and cfg.d_ssm_inner % tp == 0 else {}}
    return {gk: {name: {leaf: split.get(name, {}).get(leaf) for leaf in sub}
                 for name, sub in c.items()} for gk, c in meta.items()}


def _roll_into_cache(k_full: torch.Tensor, v_full: torch.Tensor, cap: int,
                     tp: TPContext | None = None) -> Tree:
    """(Lg, B, S, KV, hd) full-sequence kv -> a ``cap``-slot rolling cache
    (at tp > 1 the rank's ``cap / tp`` contiguous slots of it).

    Slot j holds the largest position p < S with p % cap == j, or is empty
    (pos -1; its k/v are position 0's, as in the reference's gather)."""
    Lg, B, S = k_full.shape[:3]
    j = torch.arange(cap, device=k_full.device)
    if tp is not None and tp.enabled:
        s_local = cap // tp.size
        j = j[tp.index * s_local:(tp.index + 1) * s_local]
        cap_local = s_local
    else:
        cap_local = cap
    p = cap * torch.div(S - 1 - j, cap, rounding_mode="floor") + j
    p = torch.where((p >= 0) & (p < S), p, -1)
    idx = torch.clamp(p, min=0)
    return {
        "k": k_full.index_select(2, idx),
        "v": v_full.index_select(2, idx),
        "pos": p.to(torch.int32)[None, None].expand(Lg, B, cap_local).contiguous(),
    }


def _logits(x, params, cfg: ModelConfig, rt: RuntimeConfig, tp=None):
    return _head(x, params, cfg, rt.cdtype, tp, last=True)


def prefill(params: Tree, batch: dict, cfg: ModelConfig, rt: RuntimeConfig, *,
            target_len: int | None = None, tp: TPContext | None = None):
    """Full-sequence prefill of ``batch["tokens"]`` (B, S) [and a VLM's
    ``patch_embeds``, an encoder-decoder's ``enc_frames``, encoded once]:
    returns the last-token logits (B, Vp) and the serve cache for
    ``target_len`` positions (default S).  With ``tp`` the logits are the
    rank's vocab shard (B, Vp/tp) and the cache its sequence shard."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    target_len = target_len or S
    _check_ctx(cfg, tp, serve=True)
    tps = tp.size if tp is not None else 1
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(tokens, params, cfg, rt.cdtype, positions, batch.get("patch_embeds"), tp)
    enc_out = _encode(params, batch, cfg, rt, tp) if cfg.arch_kind == "encdec" else None
    x, _, entries = _run_groups(x, params["groups"], cfg, positions, rt, serve=True,
                                enc_out=enc_out, tp=tp)
    del enc_out
    cache: Tree = {}
    for gi, g in enumerate(block_groups(cfg)):
        layer_entries = entries.pop(gi)
        c: Tree = {}
        if g.has_attn:
            ks, vs = zip(*(e["kv"] for e in layer_entries))
            c["kv"] = _roll_into_cache(torch.stack(ks), torch.stack(vs),
                                       _group_capacity(g, target_len, tps), tp)
        for name in ("ssm", "mlstm", "slstm"):
            if name in layer_entries[0]:
                c[name] = _stack([e[name] for e in layer_entries])
        if "cross_kv" in layer_entries[0]:
            ks, vs = zip(*(e["cross_kv"] for e in layer_entries))
            c["cross_kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        cache[f"g{gi}"] = c
        del layer_entries
    return _logits(x, params, cfg, rt, tp), cache


def decode_step(params: Tree, tokens: torch.Tensor, cache: Tree, t, cfg: ModelConfig,
                rt: RuntimeConfig, *, target_len: int, tp: TPContext | None = None):
    """One-token decode.  tokens: (B, 1); ``t``: the new token's absolute
    position, an int or a per-slot (B,) tensor (continuous batching serves
    requests whose timelines are independent).  The cache is updated **in
    place** (the reference donates it): the new kv into its slot, the new
    recurrent state over the old; a decoder layer of the encoder-decoder
    reads its cached cross k/v.  Returns ``(logits (B, Vp), cache)``; with
    ``tp`` the logits are the rank's vocab shard and the step split-K."""
    B = tokens.shape[0]
    _check_ctx(cfg, tp, serve=True)
    tps = tp.size if tp is not None else 1
    t = torch.as_tensor(t, device=tokens.device).to(torch.long).expand(B)
    x = _embed(tokens, params, cfg, rt.cdtype, t[:, None], tp=tp)
    nt = cfg.norm_type
    for gi, g in enumerate(block_groups(cfg)):
        cg = cache[f"g{gi}"]
        want = _group_capacity(g, target_len, tps) // tps
        if g.has_attn and cg["kv"]["k"].shape[2] != want:
            raise ValueError(f"cache group g{gi} holds {cg['kv']['k'].shape[2]} slots; "
                             f"target_len {target_len} gives {want}")
        for li, lp in enumerate(_layers(params["groups"][f"g{gi}"], g.count)):
            if not g.has_attn:
                # sLSTM is replicated: the same recurrence on every rank
                step = (functools.partial(xlstm_mod.mlstm_decode_step, tp=tp)
                        if g.kind == "mlstm" else xlstm_mod.slstm_decode_step)
                y = _recurrent_step(step, norm_apply(x, lp["norm"], nt), lp[g.kind],
                                    cg[g.kind], li, cfg)
                x = x + y
                continue
            h = norm_apply(x, lp["attn_norm"], nt)
            layer_cache = {n: c[li] for n, c in cg["kv"].items()}
            a, _ = attn.attn_decode_step(h, lp["attn"], layer_cache, cfg, t=t,
                                         window=g.window, grouped=rt.decode_grouped_gqa, tp=tp)
            if g.has_ssm:
                s = _recurrent_step(functools.partial(ssm_mod.ssm_decode_step, tp=tp), h,
                                    lp["ssm"], cg["ssm"], li, cfg)
                x = x + 0.5 * (a + s)
            else:
                x = x + a
            if g.kind == "dec" and cfg.arch_kind == "encdec":
                cross = {n: c[li] for n, c in cg["cross_kv"].items()}
                x = x + attn.attn_cross_decode(norm_apply(x, lp["cross_norm"], nt),
                                               lp["cross"], cross, cfg)
            if cfg.d_ff > 0:
                h2 = norm_apply(x, lp["mlp_norm"], nt)
                if g.kind == "moe":
                    y2, _ = moe_mod.moe_forward(h2, lp["moe"], cfg, tp)
                else:
                    y2 = mlp_apply(h2, lp["mlp"], cfg.act, tp)
                x = x + y2
    return _logits(x, params, cfg, rt, tp), cache


def _recurrent_step(step, h, lp, group_state: Tree, li: int, cfg: ModelConfig):
    """Layer ``li``'s recurrent decode ``step`` on its slice of the
    layer-stacked ``group_state``, which takes the new state in place."""
    state = {n: c[li] for n, c in group_state.items()}
    y, new = step(h, lp, state, cfg)
    for n, c in state.items():
        c.copy_(new[n])
    return y
