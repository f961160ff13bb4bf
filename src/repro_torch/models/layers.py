"""Shared layers of the decoder LMs (the port of ``repro.models.layers``),
with manual tensor parallelism.

Parameters are plain nested dicts of tensors with the JAX package's paths
and layouts: a linear weight is ``(d_in, d_out)`` and is applied as
``x @ w`` (:func:`~repro_torch.kernels.gemm.linear`: a large f32 product on
a card runs on the 3xTF32 ``wgmma`` kernel, every other on
``torch.matmul``).  Norm scales are stored as offsets from 1 (``x * (1 +
scale)``), as in the reference.

Tensor parallelism is Megatron's, as in the reference: activations are
replicated over the model group at block boundaries, a column-sharded
in-projection makes a sharded hidden, a row-sharded out-projection and one
all-reduce bring it back.  :class:`TPContext` holds the model group
(:class:`~repro_torch.launch.mesh.Grid`'s ``model``); with no group, or a
group of one, every collective is the identity and the code is the tp = 1
code.  Gradients come from autograd through Megatron's pair of functions:
:meth:`TPContext.copy_in` (identity forward, all-reduce backward) at the
entry of each column-sharded projection, and :meth:`TPContext.reduce_out`
(all-reduce forward, identity backward) after ``wo``/``w_out`` and the
vocab-sharded lookup and loss sums.  A replicated leaf that a rank uses on
its own shard only (``q_norm``/``k_norm``, k/v projections that are not
sharded) enters through ``copy_in`` too, so its gradient is summed over the
group; every leaf's gradient, gathered over the group, is then its tp = 1
gradient.  The reference gets the same from shard_map's AD, and patches its
legacy form by hand (``repro/train/step.py:286-317``); nothing here copies
those factors.
"""

from __future__ import annotations

import math
import time
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.gemm import linear
from ..launch.costmodel import record_collective

Tree = Any

__all__ = [
    "TPContext",
    "pmax_stopgrad",
    "Initializer",
    "rms_norm",
    "layer_norm",
    "norm_init",
    "norm_apply",
    "rope_freqs",
    "apply_rope",
    "yarn_mscale",
    "yarn_freqs",
    "apply_rope_pairs",
    "linear_init",
    "mlp_init",
    "mlp_apply",
    "embedding_init",
    "zero_pad",
    "embed_lookup",
    "lm_head_logits",
    "softmax_xent_sharded",
]


class TPContext:
    """The model group of one node (see the module docstring).  ``group`` is
    a :class:`~repro_torch.launch.mesh.NodeGroup` over the node's ranks
    (None: tp = 1).  On gloo with tensors on a card (``group.staged``) each
    collective copies its tensor to the host and back.  The collectives'
    host seconds, count and staged bytes accumulate in ``seconds``,
    ``calls`` and ``staged_bytes``; with ``timing`` on, each collective
    first waits for the card, so ``seconds`` holds the collectives alone."""

    def __init__(self, group=None, *, timing: bool = False):
        self.group = group
        self.size = 1 if group is None else group.world
        self.index = 0 if group is None else group.rank
        self.timing = timing
        self.reset()

    def reset(self) -> None:
        self.seconds, self.calls, self.staged_bytes = 0.0, 0, 0

    @property
    def enabled(self) -> bool:
        return self.size > 1

    def _run(self, x: torch.Tensor, fn, op: str, dim: int = 0) -> torch.Tensor:
        """``fn(t)`` on a contiguous copy of ``x`` (on the host when staged),
        in place; the result back on ``x``'s device.  ``op`` (``all-reduce``
        or ``all-gather`` along ``dim``) is what the cost model records
        (:func:`~repro_torch.launch.costmodel.record_collective`); on a dry
        group (:func:`~repro_torch.launch.mesh.dry_grid`) the result is a
        meta tensor of its shape, and ``fn`` does not run."""
        g = self.group
        nbytes = x.numel() * x.element_size()
        record_collective(op, g, x.shape, nbytes, nbytes * (g.world if op == "all-gather" else 1))
        if g.dry:
            if x.device.type != "meta":
                raise ValueError(f"a dry group takes meta tensors only, got one on {x.device}")
            t = x.detach().clone()
            return torch.cat([t] * g.world, dim=dim) if op == "all-gather" else t
        staged = g.staged and x.device.type == "cuda"
        if self.timing and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        t = x.detach().contiguous().to("cpu") if staged else x.detach().clone().contiguous()
        t = fn(t)
        if staged:
            self.staged_bytes += 2 * t.numel() * t.element_size()
            t = t.to(x.device)
        if self.timing and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return t

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) over the group; no autograd."""
        if not self.enabled:
            return x
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def fn(t):
            dist.all_reduce(t, op=rop, group=self.group.pg)
            return t

        return self._run(x, fn, "all-reduce")

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's tensors concatenated along ``dim`` by model index."""
        if not self.enabled:
            return x

        def fn(t):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group.pg)
            return torch.cat(parts, dim=dim)

        return self._run(x, fn, "all-gather", dim)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, all-reduce of the gradient backward."""
        return _CopyIn.apply(x, self) if self.enabled else x

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce forward, identity backward."""
        return _ReduceOut.apply(x, self) if self.enabled else x



class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enabled(tp: TPContext | None) -> bool:
    return tp is not None and tp.enabled


def pmax_stopgrad(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The max over the model group with no gradient: it feeds
    numerical-stability shifts only (the reference's ``pmax_stopgrad``)."""
    return tp.all_reduce(x.detach(), "max")


class Initializer:
    """Deterministic param init: truncated-normal (+-2 sigma) fan-in scaling,
    drawn from one explicit ``torch.Generator``.  Same shapes and scales as
    the JAX initializer; the numbers differ (the two RNGs never agree)."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device

    def normal(self, shape, scale: float, dtype=torch.float32) -> torch.Tensor:
        if self.device.type == "meta":
            # shapes and dtypes only; a draw on meta tensors would load torch's
            # Python meta kernels (seconds a process) for values that are not
            return torch.empty(shape, dtype=dtype, device=self.device)
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return t.mul_(scale).to(dtype)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.to(torch.float32))
    return x.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * (1.0 + scale.to(torch.float32))
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def norm_init(init: Initializer, norm_type: str, d: int) -> Tree:
    if norm_type == "rmsnorm":
        return {"scale": init.zeros((d,))}
    if norm_type == "layernorm":
        return {"scale": init.zeros((d,)), "bias": init.zeros((d,))}
    if norm_type == "nonparametric_ln":  # OLMo: no affine params, an empty subtree
        return {}
    raise ValueError(norm_type)


def norm_apply(x: torch.Tensor, params: Tree, norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    if norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if norm_type == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# RoPE (half-split: the first and second halves of hd rotate as pairs)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None, cos_scale: float = 1.0) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: (..., S) integer.  ``freqs``
    (hd/2,) replaces ``theta``'s inverse frequencies (YaRN's), and
    ``cos_scale`` scales cos and sin (YaRN's attention factor)."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    if cos_scale != 1.0:
        cos, sin = cos * cos_scale, sin * cos_scale
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
                     cos_scale: float = 1.0) -> torch.Tensor:
    """DeepSeek-V2's rope on x (..., S, n_heads, r): the r dims are read as
    adjacent pairs (2i, 2i + 1), reordered to the evens then the odds, and
    rotated half-split by ``freqs[i]`` (``modeling_deepseek.py``'s
    ``apply_rotary_pos_emb``; for the scores the same as rotating each pair
    in place)."""
    r = x.shape[-1]
    x = x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    return apply_rope(x, positions, 0.0, freqs, cos_scale)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude correction ``0.1 mscale ln(factor) + 1`` (1 for
    ``factor <= 1``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, factor: float, original_max_pos: int,
               beta_fast: float, beta_slow: float, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (dim/2,) in f32: theta's own frequencies
    (extrapolated) below the correction range of ``beta_fast`` rotations over
    ``original_max_pos`` positions, those divided by ``factor``
    (interpolated) above that of ``beta_slow``, a linear ramp between."""

    def correction(rotations: float) -> float:
        return dim * math.log(original_max_pos / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(correction(beta_fast)), 0)
    high = min(math.ceil(correction(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    extra = rope_freqs(dim, theta, device)
    inter = 1.0 / (factor * theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                   device=device) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp  # 1: extrapolate, 0: interpolate
    return inter * (1 - mask) + extra * mask


# ---------------------------------------------------------------------------
# Linear / MLP
# ---------------------------------------------------------------------------


def linear_init(init: Initializer, d_in: int, d_out: int, *, scale: float | None = None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), s)


_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(init: Initializer, d: int, f: int, gated: bool) -> Tree:
    p = {
        "w_in": linear_init(init, d, f),
        "w_out": linear_init(init, f, d),
    }
    if gated:
        p["w_gate"] = linear_init(init, d, f)
    return p


def mlp_apply(x: torch.Tensor, params: Tree, act: str,
              tp: TPContext | None = None) -> torch.Tensor:
    """Megatron's MLP at tp > 1: ``w_in``/``w_gate`` column-sharded, ``w_out``
    row-sharded, one all-reduce."""
    if tp_enabled(tp):
        return tp.reduce_out(_mlp(tp.copy_in(x), params, act))
    return _mlp(x, params, act)


def _mlp(x: torch.Tensor, params: Tree, act: str) -> torch.Tensor:
    dt = x.dtype
    h = linear(x, params["w_in"].to(dt))
    if "w_gate" in params:
        g = linear(x, params["w_gate"].to(dt))
        h = _ACTS[act](g) * h
    else:
        h = _ACTS[act](h)
    return linear(h, params["w_out"].to(dt))


# ---------------------------------------------------------------------------
# Embedding + LM head / loss
# ---------------------------------------------------------------------------


def zero_pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to size ``n``."""
    extra = n - x.shape[dim]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def embedding_init(init: Initializer, vocab_padded: int, d: int,
                   vocab: int | None = None) -> Tree:
    """``(vocab_padded, d)``; with ``vocab``, rows past it are zeros (drawn
    for ``vocab`` rows only: the padding changes no other draw)."""
    vocab = vocab_padded if vocab is None else vocab
    return {"table": zero_pad(init.normal((vocab, d), 0.02), 0, vocab_padded)}


def embed_lookup(ids: torch.Tensor, table: torch.Tensor,
                 tp: TPContext | None = None) -> torch.Tensor:
    """Rows of ``table`` for ``ids``; at tp > 1 the table is this rank's
    vocab shard ``(Vp/tp, d)``: the rows it holds, zeros elsewhere, summed
    over the group."""
    if not tp_enabled(tp):
        return F.embedding(ids.long(), table)
    v_local = table.shape[0]
    local = ids.long() - tp.index * v_local
    hit = (local >= 0) & (local < v_local)
    emb = F.embedding(torch.clamp(local, 0, v_local - 1), table)
    emb = torch.where(hit[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return tp.reduce_out(emb)


def lm_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d); w: (d, V) -> logits (..., V)."""
    return linear(x, w.to(x.dtype))


def softmax_xent_sharded(logits: torch.Tensor, targets: torch.Tensor, *,
                         vocab_size: int, tp: TPContext | None = None) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (T, Vp) against ``targets`` (T,).

    Padded vocab columns (``>= vocab_size``) are masked to -1e30 and the max
    shift carries no gradient, as in the reference.  At tp > 1 ``logits``
    is this rank's vocab shard (T, Vp/tp): the max, the sum of exponentials
    and the label's logit combine over the model group."""
    if tp_enabled(tp):
        return _xent_sharded(logits, targets, vocab_size, tp)
    lg = logits.to(torch.float32)
    valid = torch.arange(lg.shape[-1], device=lg.device) < vocab_size
    lg = torch.where(valid, lg, torch.full((), -1e30, dtype=lg.dtype, device=lg.device))
    mx = torch.amax(lg, dim=-1, keepdim=True).detach()
    lg = lg - mx
    sumexp = torch.sum(torch.exp(lg), dim=-1)
    label_logit = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = torch.log(sumexp) - label_logit
    return torch.sum(nll) / float(nll.numel())


def _xent_sharded(logits, targets, vocab_size: int, tp: TPContext) -> torch.Tensor:
    lg = logits.to(torch.float32)
    v_local = lg.shape[-1]
    lo = tp.index * v_local
    valid = torch.arange(lo, lo + v_local, device=lg.device) < vocab_size
    lg = torch.where(valid, lg, torch.full((), -1e30, dtype=lg.dtype, device=lg.device))
    mx = pmax_stopgrad(torch.amax(lg, dim=-1, keepdim=True), tp)
    lg = lg - mx
    sumexp = tp.reduce_out(torch.sum(torch.exp(lg), dim=-1))
    local_t = targets.long() - lo
    hit = (local_t >= 0) & (local_t < v_local)
    picked = torch.gather(lg, -1, torch.clamp(local_t, 0, v_local - 1)[..., None])[..., 0]
    label_logit = tp.reduce_out(torch.where(hit, picked, torch.zeros((), device=lg.device)))
    nll = torch.log(sumexp) - label_logit
    return torch.sum(nll) / float(nll.numel())
