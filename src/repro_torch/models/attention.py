"""Attention (the port of ``repro.models.attention``): the train/prefill
forward, the serve KV cache and the one-token decode step, with manual
tensor parallelism.

``attention_core`` takes the unexpanded kv ``(B, Sk, Hkv, hd)``.  Its
``impl="torch"`` branch is the reference's ``jnp`` path
(``_masked_attention_traced_window``) as plain torch matmul and softmax over
kv expanded to the query heads; the JAX trainer computes it outside any
Pallas kernel too.  The reference splits queries into 512-row blocks to
bound its live score matrix; each row's math is independent of that split,
so the port computes all rows at once.  ``impl="cuda"`` is the reference's
``pallas`` branch: the flash-attention kernel, which does GQA itself (its
plain version on a CPU tensor).

Cross-attention (the encoder-decoder's, ``kv_source``) projects k and v
from the encoder's output and attends non-causally over all of it; RoPE
never touches cross k.  With ``impl="cuda"`` it goes through the same
flash kernel at Sq != Sk.  At tp > 1 it projects k and v for the rank's
kv heads, as self-attention does.

Decode is the reference's split-K softmax at tp = 1 in plain torch: the new
token's k/v go into slot ``t % capacity`` of the cache (a rolling buffer
when the capacity is a sliding window), and the scores run over the whole
cache, masked by each slot's stored position.  A decoder token's
cross-attention over the cached encoder k/v (:func:`attn_cross_decode`) is
a plain f32 softmax, as in the reference.

Tensor parallelism (a :class:`~repro_torch.models.layers.TPContext` of
size > 1) follows the reference's scheme (:class:`AttnDims`):

* **train / prefill**: q heads are column-sharded, padded up to a multiple
  of tp (padded heads are masked to zero, so they give no output and get
  no gradient); k/v are sharded by kv head when both head counts divide
  tp and the call is not serving, else computed whole on every rank.  Each
  rank attends with its local heads over kv laid out for them
  (:func:`local_kv`): a rank's q heads start at ``index * h_local``, so
  with replicated kv they read kv groups that do not start at 0, and the
  flash kernel (which maps q head ``h`` to kv head ``h // (H/KV)`` from
  head 0) gets the slice or the gather of those groups, never the whole
  kv.  ``wo`` is row-sharded and its product summed over the group.
* **decode**: split-K.  The KV cache is sharded by sequence over the model
  group (each rank holds ``capacity / tp`` contiguous slots, a window's
  rolling buffer too), the new token's q is all-gathered, each rank scores
  its own slots for every head, and the partial max, sum of exponentials
  and weighted v merge with an all-reduce max and two all-reduce sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..kernels.gemm import linear
from ..trace import span
from .layers import (
    Initializer,
    TPContext,
    apply_rope,
    apply_rope_pairs,
    linear_init,
    rms_norm,
    rope_freqs,
    tp_enabled,
    yarn_freqs,
    yarn_mscale,
    zero_pad,
)

Tree = Any

__all__ = [
    "ATTN_IMPLS",
    "AttnDims",
    "attn_shard_axes",
    "local_kv",
    "attn_init",
    "attn_forward",
    "attention_core",
    "mla_init",
    "mla_forward",
    "mla_rope",
    "attn_cross_decode",
    "attn_decode_step",
    "group_index",
    "init_kv_cache",
]

NEG_INF = -1e30
ATTN_IMPLS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Head counts at tensor-parallel degree ``tp`` (the reference's)."""

    n_heads: int  # real q heads
    n_heads_padded: int
    n_kv: int
    hd: int
    tp: int
    kv_sharded: bool

    @classmethod
    def resolve(cls, cfg: ModelConfig, tp: int, serve: bool = False) -> "AttnDims":
        # serving keeps every kv head on every rank (the cache is sharded by
        # sequence instead), so the k/v projections stay replicated there
        kv_sharded = cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0 and not serve
        return cls(cfg.n_heads, cfg.n_heads_padded(tp), cfg.n_kv_heads, cfg.hd, tp,
                   kv_sharded)

    @property
    def h_local(self) -> int:
        return self.n_heads_padded // self.tp

    @property
    def kv_local(self) -> int:
        return self.n_kv // self.tp if self.kv_sharded else self.n_kv

    @property
    def q_per_kv(self) -> int:
        return max(self.n_heads // self.n_kv, 1)

    def local_groups(self, index: int) -> list[int]:
        """(h_local,) the kv head (in the rank's kv tensor) of each local q head."""
        base = index * self.h_local
        g = [min((base + h) // self.q_per_kv, self.n_kv - 1) for h in range(self.h_local)]
        if self.kv_sharded:
            g = [x - index * self.kv_local for x in g]
        return g

    def head_mask(self, index: int, device=None) -> torch.Tensor | None:
        """(h_local,) 1.0 for real heads, 0.0 for padding (None: no padding)."""
        if self.n_heads_padded == self.n_heads:
            return None
        idx = index * self.h_local + torch.arange(self.h_local, device=device)
        return (idx < self.n_heads).to(torch.float32)


def attn_init(init: Initializer, cfg: ModelConfig, tp: int = 1) -> Tree:
    """Global parameters; q heads padded to a multiple of ``tp`` with zero
    columns of ``wq`` and zero rows of ``wo`` (drawn at the real head count,
    so that a seed gives the same model at every tp; a padded head's output
    is masked whatever its weights)."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    hp = cfg.n_heads_padded(tp)
    p = {
        "wq": zero_pad(linear_init(init, d, h * hd), 1, hp * hd),
        "wk": linear_init(init, d, cfg.n_kv_heads * hd),
        "wv": linear_init(init, d, cfg.n_kv_heads * hd),
        "wo": zero_pad(linear_init(init, h * hd, d), 0, hp * hd),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.zeros((hd,))
        p["k_norm"] = init.zeros((hd,))
    return p


def attn_shard_axes(cfg: ModelConfig, tp: int, serve: bool = False) -> Tree:
    """The axis of each attention leaf split over the model group (None:
    replicated), the reference's ``attn_specs``."""
    kv = 1 if AttnDims.resolve(cfg, tp, serve=serve).kv_sharded else None
    p = {"wq": 1, "wk": kv, "wv": kv, "wo": 0}
    if cfg.qk_norm:
        p["q_norm"] = None
        p["k_norm"] = None
    return p


def group_index(n_heads: int, n_kv: int, device=None, q_per_kv: int | None = None) -> torch.Tensor:
    """(n_heads,) GQA map: q head ``h`` reads kv head ``h // (H / KV)``
    (``q_per_kv`` from the real head count where heads are padded)."""
    q_per_kv = q_per_kv or max(n_heads // n_kv, 1)
    return torch.clamp(torch.arange(n_heads, device=device) // q_per_kv, 0, n_kv - 1)


def local_kv(k: torch.Tensor, dims: AttnDims, index: int) -> torch.Tensor:
    """(B, S, KVloc, hd) -> kv laid out for this rank's q heads: the
    contiguous run of kv heads they read when their group map is
    ``g0 + h // q_per_kv`` (the flash kernel's own map, from ``g0``), else
    one kv head per local q head (the reference's ``_expand_kv``)."""
    g = dims.local_groups(index)
    q, n = dims.q_per_kv, dims.h_local // dims.q_per_kv
    if dims.h_local % q == 0 and g == [g[0] + h // q for h in range(dims.h_local)] \
            and g[0] + n <= k.shape[2]:
        return k[:, :, g[0]:g[0] + n]
    return k[:, :, torch.tensor(g, device=k.device)]


def _group_full(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd): kv expanded to the query heads."""
    return k[:, :, group_index(n_heads, k.shape[2], k.device)]


def attention_core(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                   impl: str = "torch", scale: float | None = None):
    """q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd), v: (B, Sk, Hkv, dv),
    unexpanded.  Scores (times ``scale``, by default 1/sqrt(hd)) and softmax
    in f32.  Returns (B, Sq, H, dv)."""
    if impl == "cuda":
        if softcap > 0.0:
            # the reference's Pallas branch drops softcap silently; refuse it
            raise NotImplementedError(
                "attn_impl='cuda' does not apply logit_softcap; use attn_impl='torch'"
            )
        if scale is not None or v.shape[-1] != q.shape[-1]:
            raise NotImplementedError("the flash kernel scales by 1/sqrt(hd) and takes v's "
                                      "head dim equal to q's; use attn_impl='torch'")
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl != "torch":
        raise ValueError(f"unknown attn_impl {impl!r}; one of {ATTN_IMPLS}")
    H = q.shape[2]
    k, v = _group_full(k, H), _group_full(v, H)
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _project(x, params, cfg: ModelConfig, positions, kv_source=None):
    """q (B, S, H, hd) and k, v (B, Sk, KV, hd), normed and rotated; k and v
    from ``kv_source`` (B, Sk, d) where given (cross-attention: k is not
    rotated), else from ``x``."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    src = x if kv_source is None else kv_source.to(dt)
    Sk = src.shape[1]
    q = linear(x, params["wq"].to(dt)).reshape(B, S, H, hd)
    k = linear(src, params["wk"].to(dt)).reshape(B, Sk, KV, hd)
    v = linear(src, params["wv"].to(dt)).reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_source is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(
    x: torch.Tensor,
    params: Tree,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    attn_impl: str = "torch",
    return_kv: bool = False,
    kv_source: torch.Tensor | None = None,
    tp: TPContext | None = None,
    serve: bool = False,
):
    """x: (B, S, d) -> (B, S, d); with ``return_kv`` also this layer's
    ``(k, v)``, each (B, Sk, KV, hd), for the serve cache.  ``kv_source``
    (B, Sk, d) makes it cross-attention: k and v are projected from it.
    With a ``tp`` group of size > 1 the parameters are this rank's shards
    (``serve`` picks the serving layout, kv replicated) and the returned
    k/v are the rank's (every kv head when serving)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if tp_enabled(tp):
        return _attn_forward_tp(x, params, cfg, tp, positions=positions, causal=causal,
                                window=window, attn_impl=attn_impl, return_kv=return_kv,
                                serve=serve, kv_source=kv_source)
    q, k, v = _project(x, params, cfg, positions, kv_source)
    out = attention_core(q, k, v, causal=causal, window=window,
                         softcap=cfg.logit_softcap, impl=attn_impl)
    y = linear(out.reshape(B, S, cfg.n_heads * cfg.hd), params["wo"].to(x.dtype))
    if return_kv:
        return y, (k, v)
    return y


def _attn_forward_tp(x, params, cfg: ModelConfig, tp: TPContext, *, positions, causal,
                     window, attn_impl, return_kv, serve, kv_source=None):
    B, S, _ = x.shape
    dims = AttnDims.resolve(cfg, tp.size, serve=serve)
    dt, hd = x.dtype, cfg.hd
    x = tp.copy_in(x)
    # cross-attention projects k and v from the encoder's output, for the
    # rank's kv heads (k not rotated)
    src = x if kv_source is None else tp.copy_in(kv_source.to(dt))
    Sk = src.shape[1]
    # a replicated leaf used on this rank's heads only: its gradient sums
    # over the group
    wk, wv = params["wk"], params["wv"]
    if not dims.kv_sharded:
        wk, wv = tp.copy_in(wk), tp.copy_in(wv)
    q = linear(x, params["wq"].to(dt)).reshape(B, S, dims.h_local, hd)
    k = linear(src, wk.to(dt)).reshape(B, Sk, dims.kv_local, hd)
    v = linear(src, wv.to(dt)).reshape(B, Sk, dims.kv_local, hd)
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy_in(params["q_norm"]))
        k = rms_norm(k, tp.copy_in(params["k_norm"]))
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_source is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_core(q, local_kv(k, dims, tp.index), local_kv(v, dims, tp.index),
                         causal=causal, window=window, softcap=cfg.logit_softcap,
                         impl=attn_impl)
    mask = dims.head_mask(tp.index, x.device)
    if mask is not None:
        out = out * mask[None, None, :, None].to(dt)
    y = tp.reduce_out(linear(out.reshape(B, S, dims.h_local * hd), params["wo"].to(dt)))
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2), training path
# ---------------------------------------------------------------------------


def mla_init(init: Initializer, cfg: ModelConfig) -> Tree:
    """MLA's parameters with no q LoRA: ``wq`` (d, H (nope + rope)), ``wkv_a``
    (d, rank + rope), the latent's RMS norm ``kv_norm`` (rank,), ``wkv_b``
    (rank, H (nope + v)), ``wo`` (H v, d)."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": linear_init(init, d, h * (nope + rope)),
        "wkv_a": linear_init(init, d, r + rope),
        "kv_norm": init.zeros((r,)),
        "wkv_b": linear_init(init, r, h * (nope + dv)),
        "wo": linear_init(init, h * dv, d),
    }


def mla_rope(cfg: ModelConfig, device=None) -> tuple[torch.Tensor, float, float]:
    """``(freqs, cos_scale, softmax_scale)`` of MLA's rope slice: YaRN's
    frequencies and factors where ``yarn_factor`` is set, else theta's, 1
    and ``(nope + rope)^-1/2``."""
    rope = cfg.qk_rope_head_dim
    scale = (cfg.qk_nope_head_dim + rope) ** -0.5
    if cfg.yarn_factor <= 0:
        return rope_freqs(rope, cfg.rope_theta, device), 1.0, scale
    f = cfg.yarn_factor
    freqs = yarn_freqs(rope, cfg.rope_theta, f, cfg.yarn_original_max_pos, cfg.yarn_beta_fast,
                       cfg.yarn_beta_slow, device)
    cos_scale = yarn_mscale(f, cfg.yarn_mscale) / yarn_mscale(f, cfg.yarn_mscale_all_dim)
    if cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(f, cfg.yarn_mscale_all_dim) ** 2
    return freqs, cos_scale, scale


def mla_forward(x: torch.Tensor, params: Tree, cfg: ModelConfig, *,
                positions: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), causal (``modeling_deepseek.py``'s
    ``DeepseekV2Attention`` with no q LoRA): ``q = x wq`` split per head into
    nope and rope; ``[c | k_rope] = x wkv_a``, ``c`` RMS-normed and
    ``[k_nope | v] = c wkv_b`` per head; the rope slice of q and the one
    ``k_rope`` every head shares rotated (:func:`~.layers.apply_rope_pairs`);
    scores over ``[nope | rope]`` times :func:`mla_rope`'s scale; ``o wo``.
    Spans: ``mla`` holds the layer, ``mla_latent`` the latent's products and
    norm, ``mla_core`` the scores, softmax and PV."""
    B, S, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    with span("mla"):
        q = linear(x, params["wq"].to(dt)).reshape(B, S, h, nope + rope)
        with span("mla_latent"):
            ckv = linear(x, params["wkv_a"].to(dt))
            c = rms_norm(ckv[..., :r], params["kv_norm"])
            kv = linear(c, params["wkv_b"].to(dt)).reshape(B, S, h, nope + dv)
        freqs, cos_scale, scale = mla_rope(cfg, x.device)
        q_rope = apply_rope_pairs(q[..., nope:], positions, freqs, cos_scale)
        k_rope = apply_rope_pairs(ckv[..., None, r:], positions, freqs, cos_scale)
        q = torch.cat([q[..., :nope], q_rope], dim=-1)
        k = torch.cat([kv[..., :nope], k_rope.expand(B, S, h, rope)], dim=-1)
        with span("mla_core"):
            out = attention_core(q, k, kv[..., nope:], causal=True, scale=scale)
        return linear(out.reshape(B, S, h * dv), params["wo"].to(dt))


# ---------------------------------------------------------------------------
# Decode: the KV cache and the one-token step
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, capacity: int,
                  dtype=torch.bfloat16, device=None, tp: int = 1) -> Tree:
    """Layer-stacked cache: k/v ``(n_layers, batch, capacity / tp, KV, hd)``
    and ``pos`` ``(n_layers, batch, capacity / tp)``, each slot's absolute
    position (-1 = empty), so rolling windows and masking are explicit.
    ``capacity`` is the global slot count; a rank of the model group holds
    ``capacity / tp`` contiguous slots with every kv head."""
    if capacity % tp:
        raise ValueError(f"cache capacity {capacity} is not divisible by tp={tp}")
    s_local = capacity // tp
    shape = (n_layers, batch, s_local, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_layers, batch, s_local), -1, dtype=torch.int32, device=device),
    }


def attn_decode_step(
    x: torch.Tensor,
    params: Tree,
    cache_layer: Tree,
    cfg: ModelConfig,
    *,
    t: torch.Tensor,
    window: int = 0,
    grouped: bool = False,
    tp: TPContext | None = None,
):
    """One-token decode.  x: (B, 1, d); ``t``: the new token's absolute
    position, (B,) int (one per slot).  ``cache_layer``: this layer's
    ``{"k", "v"}`` (B, capacity, KV, hd) and ``"pos"`` (B, capacity), updated
    **in place** (slot ``t % capacity`` takes the new k/v and position ``t``).
    ``grouped`` scores q-head groups against the raw cache instead of a
    kv copy expanded to H heads.  Returns ``(y, cache_layer)``.  At tp > 1
    the cache layer is the rank's sequence shard and the step is split-K
    (module docstring)."""
    B = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per slot, got x {tuple(x.shape)}")
    if tp_enabled(tp):
        return _decode_split_k(x, params, cache_layer, cfg, tp, t=t, window=window,
                               grouped=grouped)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    t = t.to(device=x.device, dtype=torch.long)
    q, k, v = _project(x, params, cfg, t[:, None])

    ck, cv, cpos = cache_layer["k"], cache_layer["v"], cache_layer["pos"]
    slot = t % ck.shape[1]
    rows = torch.arange(B, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = t.to(cpos.dtype)

    valid = (cpos >= 0) & (cpos <= t[:, None])
    if window > 0:
        valid &= t[:, None] - cpos < window
    scale = 1.0 / math.sqrt(hd)
    softcap = cfg.logit_softcap
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
    if grouped and H % KV == 0:
        # contract q-head groups against the raw cache: no (H/KV)-times copy
        gp = H // KV
        qg = q.reshape(B, 1, KV, gp, hd)
        s = torch.einsum("bqegd,bked->begqk", qg, ck.to(dt)).to(torch.float32) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, None, :], s, neg).reshape(B, H, 1, -1)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, _group_full(ck.to(dt), H)).to(torch.float32)
        s = s * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, :], s, neg)
    m = torch.amax(s, dim=-1)  # (B, H, 1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # (B, H, 1)
    if grouped and H % KV == 0:
        pg = p.reshape(B, KV, gp, 1, -1)
        o = torch.einsum("begqk,bked->bqegd", pg.to(dt), cv.to(dt))
        o = o.reshape(B, 1, H, hd).to(torch.float32)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), _group_full(cv.to(dt), H))
        o = o.to(torch.float32)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    y = out.reshape(B, 1, H * hd).to(dt) @ params["wo"].to(dt)
    return y, cache_layer


def _decode_split_k(x, params, cache_layer, cfg: ModelConfig, tp: TPContext, *, t,
                    window: int, grouped: bool):
    B = x.shape[0]
    dims = AttnDims.resolve(cfg, tp.size, serve=True)
    hp, kvh, hd = dims.n_heads_padded, dims.n_kv, cfg.hd
    dt = x.dtype
    t = t.to(device=x.device, dtype=torch.long)
    pos = t[:, None]
    q = (x @ params["wq"].to(dt)).reshape(B, 1, dims.h_local, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, 1, kvh, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, 1, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    qf = tp.all_gather(q, dim=2)  # (B, 1, Hp, hd): every head on every rank

    # the new k/v go into the rank that owns slot t % capacity
    ck, cv, cpos = cache_layer["k"], cache_layer["v"], cache_layer["pos"]
    s_local = ck.shape[1]
    slot = t % (s_local * tp.size)
    mine = (slot // s_local == tp.index)
    local_slot = slot % s_local
    rows = torch.arange(B, device=x.device)
    ck[rows, local_slot] = torch.where(mine[:, None, None], k[:, 0].to(ck.dtype),
                                       ck[rows, local_slot])
    cv[rows, local_slot] = torch.where(mine[:, None, None], v[:, 0].to(cv.dtype),
                                       cv[rows, local_slot])
    cpos[rows, local_slot] = torch.where(mine, t.to(cpos.dtype), cpos[rows, local_slot])

    valid = (cpos >= 0) & (cpos <= t[:, None])
    if window > 0:
        valid &= t[:, None] - cpos < window
    scale = 1.0 / math.sqrt(hd)
    softcap = cfg.logit_softcap
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
    can_group = grouped and hp == dims.n_heads and dims.n_heads % kvh == 0
    if can_group:
        gp = dims.n_heads // kvh
        qg = qf.reshape(B, 1, kvh, gp, hd)
        s = torch.einsum("bqegd,bked->begqk", qg, ck.to(dt)).to(torch.float32) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, None, :], s, neg).reshape(B, hp, 1, -1)
    else:
        gi = group_index(hp, kvh, x.device, dims.q_per_kv)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ck.to(dt)[:, :, gi]).to(torch.float32) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(valid[:, None, None, :], s, neg)
    m = tp.all_reduce(torch.amax(s, dim=-1), "max")  # (B, Hp, 1)
    p = torch.exp(s - m[..., None])
    l = tp.all_reduce(torch.sum(p, dim=-1))
    if can_group:
        pg = p.reshape(B, kvh, gp, 1, -1)
        o = torch.einsum("begqk,bked->bqegd", pg.to(dt), cv.to(dt))
        o = o.reshape(B, 1, hp, hd).to(torch.float32)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), cv.to(dt)[:, :, gi]).to(torch.float32)
    o = tp.all_reduce(o)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    if hp != dims.n_heads:  # padded heads' (uniform) outputs vanish
        out = out * (torch.arange(hp, device=x.device) < dims.n_heads).to(out.dtype)[:, None]
    lo = tp.index * dims.h_local
    out_local = out[:, :, lo:lo + dims.h_local].reshape(B, 1, dims.h_local * hd).to(dt)
    y = tp.all_reduce(out_local @ params["wo"].to(dt))
    return y, cache_layer


def attn_cross_decode(x: torch.Tensor, params: Tree, cross_kv: Tree, cfg: ModelConfig):
    """Decode-time cross-attention of x (B, 1, d) over the cached encoder
    ``cross_kv`` ``{"k", "v"}`` (B, T_enc, KV, hd): no rope, no mask, a plain
    f32 softmax (the reference's, not the kernel).  Returns (B, 1, d)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, 1, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
    kf = _group_full(cross_kv["k"].to(dt), H)
    vf = _group_full(cross_kv["v"].to(dt), H)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf).to(torch.float32) * (1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vf.dtype), vf)
    return out.reshape(B, 1, H * hd) @ params["wo"].to(dt)
