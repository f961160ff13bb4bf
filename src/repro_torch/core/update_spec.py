"""Algorithm update tails as *data*: the fused-update engine's front end.

Every algorithm in :mod:`repro_torch.core.optimizers` is one to two rounds of

    elementwise PRE  ->  communication  ->  elementwise POST

where PRE builds the gossip payload (and usually the new momentum) and POST
recombines the mixed payload into new parameters.  This module is the port
of ``repro.core.update_spec``: the same :class:`UpdateSpec` table, the same
per-op elementwise math (:func:`pre_math` / :func:`post_math`, here on f32
tensors) and the same phase walker :func:`run_update`, parameterized by a
*stage executor* — :func:`reference_stage` (plain per-leaf torch; the
oracle) or the fused engine of :mod:`repro_torch.kernels.fused_update`
(one pass over device memory per stage and leaf).

Gradient preprocessing (global-norm clip, coupled weight decay, LARS trust
ratios) needs reductions, so the *norms* are computed outside the stages
(:func:`grad_scalars`, or per node of stacked trees
:func:`node_grad_scalars`); the resulting scalars are applied inside them.

Phase table (paper Sec. 7 baselines + Alg. 2):

=============  ============================================================
pmsgd[-lars]   identity_g        -> mean   -> momentum_step
dsgd           grad_step         -> gossip -> assign_x
dmsgd          momentum_payload  -> gossip -> assign_x
da-dmsgd       momentum_accum    -> gossip -> assign_m ;
               x_minus_lr_m      -> gossip -> assign_x
awc-dmsgd      momentum_keep_x   -> gossip -> mix_minus_lr_m
slowmo         momentum_payload  -> gossip -> assign_x  (+ outer sync)
qg-dmsgd       qg_payload        -> gossip -> qg_post
d2-dmsgd       d2_payload        -> gossip -> assign_x  (+ prev-state shift)
decentlam      grad_step         -> gossip -> decentlam_post
decentlam-sa   grad_step         -> gossip -> decentlam_sa_post
=============  ============================================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..trace import span
from ..utils import tree_leaves, tree_map, tree_unflatten
from .gossip import GossipChannel

Tree = Any

__all__ = [
    "Phase",
    "UpdateSpec",
    "MathCtx",
    "update_spec",
    "math_ctx",
    "phase_ctx",
    "pre_is_free",
    "post_is_free",
    "stage_plan",
    "grad_scalars",
    "node_grad_scalars",
    "pre_io",
    "post_io",
    "pre_math",
    "post_math",
    "staleness_damping",
    "reference_stage",
    "run_update",
]


# ---------------------------------------------------------------------------
# Spec declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    pre: str  # elementwise payload op (PRE_IO key)
    comm: str  # "gossip" | "mean" | "none"
    post: str  # elementwise recombination op (POST_IO key)


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    algorithm: str
    phases: tuple[Phase, ...]
    nesterov_ok: bool = False  # whether cfg.nesterov applies to this tail
    slowmo_outer: bool = False  # periodic exact-average outer step
    d2_state: bool = False  # carries (x_prev, m_prev)
    staleness_aware: bool = False  # post stages consume the "sg" gap damping

    @property
    def gossips_per_step(self) -> int:
        return sum(p.comm == "gossip" for p in self.phases)


_SPEC_TABLE: dict[str, UpdateSpec] = {
    "pmsgd": UpdateSpec(
        "pmsgd",
        (Phase("identity_g", "mean", "momentum_step"),),
        nesterov_ok=True,
    ),
    "pmsgd-lars": UpdateSpec(
        "pmsgd-lars",
        (Phase("identity_g", "mean", "momentum_step"),),
        nesterov_ok=True,
    ),
    "dsgd": UpdateSpec("dsgd", (Phase("grad_step", "gossip", "assign_x"),)),
    "dmsgd": UpdateSpec(
        "dmsgd",
        (Phase("momentum_payload", "gossip", "assign_x"),),
        nesterov_ok=True,
    ),
    "da-dmsgd": UpdateSpec(
        "da-dmsgd",
        (
            Phase("momentum_accum", "gossip", "assign_m"),
            Phase("x_minus_lr_m", "gossip", "assign_x"),
        ),
    ),
    "awc-dmsgd": UpdateSpec(
        "awc-dmsgd", (Phase("momentum_keep_x", "gossip", "mix_minus_lr_m"),)
    ),
    "slowmo": UpdateSpec(
        "slowmo",
        (Phase("momentum_payload", "gossip", "assign_x"),),
        slowmo_outer=True,
    ),
    "qg-dmsgd": UpdateSpec("qg-dmsgd", (Phase("qg_payload", "gossip", "qg_post"),)),
    "d2-dmsgd": UpdateSpec(
        "d2-dmsgd", (Phase("d2_payload", "gossip", "assign_x"),), d2_state=True
    ),
    "decentlam": UpdateSpec(
        "decentlam",
        (Phase("grad_step", "gossip", "decentlam_post"),),
        nesterov_ok=True,
    ),
    "decentlam-sa": UpdateSpec(
        "decentlam-sa",
        (Phase("grad_step", "gossip", "decentlam_sa_post"),),
        nesterov_ok=True,
        staleness_aware=True,
    ),
}


def update_spec(cfg) -> UpdateSpec:
    """The update-spec for an :class:`~repro_torch.core.optimizers.OptimizerConfig`."""
    return _SPEC_TABLE[cfg.algorithm]


@dataclasses.dataclass(frozen=True)
class MathCtx:
    """Compile-time constants of one fused stage (hashable: the stage kernel
    specializes on it)."""

    beta: float = 0.9
    nesterov: bool = False
    wd: float = 0.0
    coupled_wd: bool = False  # fold  g <- wd*x + g  into the payload stage
    decoupled_wd: bool = False  # fold  x <- x - lr*wd*x  into this post stage
    clip: bool = False  # multiply g by the global clip scale s["gs"]
    lars: bool = False  # multiply g by the per-leaf trust ratio s["r"]


def math_ctx(cfg, *, nesterov_ok: bool, apply_decoupled_wd: bool) -> MathCtx:
    return MathCtx(
        beta=cfg.momentum,
        nesterov=bool(cfg.nesterov and nesterov_ok),
        wd=cfg.weight_decay,
        coupled_wd=cfg.weight_decay > 0.0 and not cfg.decoupled_wd,
        decoupled_wd=(
            cfg.weight_decay > 0.0 and cfg.decoupled_wd and apply_decoupled_wd
        ),
        clip=cfg.grad_clip > 0.0,
        lars=bool(cfg.lars or cfg.algorithm == "pmsgd-lars"),
    )


def phase_ctx(cfg, spec: UpdateSpec, i: int) -> MathCtx:
    """The MathCtx of phase ``i``: decoupled wd folds into the final phase's
    post stage, except for SlowMo where it applies after the outer sync."""
    last = i == len(spec.phases) - 1
    return math_ctx(
        cfg,
        nesterov_ok=spec.nesterov_ok,
        apply_decoupled_wd=last and not spec.slowmo_outer,
    )


def pre_is_free(ph: Phase, ctx: MathCtx) -> bool:
    """Payload stages that cost nothing (pure handoff, no kernel launch)."""
    return ph.pre == "identity_g" and not (ctx.clip or ctx.coupled_wd or ctx.lars)


def post_is_free(ph: Phase, ctx: MathCtx) -> bool:
    """Recombine stages that are pure assigns (no kernel launch)."""
    return ph.post == "assign_m" or (ph.post == "assign_x" and not ctx.decoupled_wd)


def stage_plan(cfg) -> list[tuple[str, str, MathCtx]]:
    """The (kind, op, ctx) stages :func:`run_update` actually executes."""
    spec = update_spec(cfg)
    plan: list[tuple[str, str, MathCtx]] = []
    for i, ph in enumerate(spec.phases):
        ctx = phase_ctx(cfg, spec, i)
        if not pre_is_free(ph, ctx):
            plan.append(("pre", ph.pre, ctx))
        if not post_is_free(ph, ctx):
            plan.append(("post", ph.post, ctx))
    return plan


# ---------------------------------------------------------------------------
# Elementwise op math (f32 in, f32 out) — shared by reference and kernels
# ---------------------------------------------------------------------------

# op -> (input names, output names).  "x" is appended to g-consuming ops when
# coupled weight decay needs it (see pre_io).
PRE_IO: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "grad_step": (("x", "g"), ("payload",)),
    "identity_g": (("g",), ("payload",)),
    "momentum_payload": (("x", "g", "m"), ("payload", "m")),
    "momentum_accum": (("g", "m"), ("payload", "m")),
    "x_minus_lr_m": (("x", "m"), ("payload",)),
    "momentum_keep_x": (("x", "g", "m"), ("payload", "m")),
    "qg_payload": (("x", "g", "m"), ("payload",)),
    "d2_payload": (("x", "g", "m", "x_prev", "m_prev"), ("payload", "m")),
}

POST_IO: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "assign_x": (("mix",), ("x",)),
    "assign_m": (("mix",), ("m",)),
    "mix_minus_lr_m": (("mix", "m"), ("x",)),
    "momentum_step": (("x", "mix", "m"), ("x", "m")),
    "qg_post": (("x", "mix", "m"), ("x", "m")),
    "decentlam_post": (("x", "mix", "m"), ("x", "m")),
    "decentlam_sa_post": (("x", "mix", "m", "g"), ("x", "m")),
}


def pre_io(op: str, ctx: MathCtx) -> tuple[tuple[str, ...], tuple[str, ...]]:
    ins, outs = PRE_IO[op]
    if ctx.coupled_wd and "g" in ins and "x" not in ins:
        ins = ("x",) + ins
    return ins, outs


def post_io(op: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    return POST_IO[op]


def _bcast(v, like):
    """A stage scalar broadcast against a leaf value: a scalar as it is; a
    per-node ``(n,)`` tensor (stacked layout) reshaped to ``(n, 1, ...)``; a
    plane's row column (``(rows, 1)`` or ``(n, rows, 1)``) as it is."""
    if isinstance(v, torch.Tensor) and 0 < v.ndim < like.ndim:
        v = v.reshape(tuple(v.shape) + (1,) * (like.ndim - v.ndim))
    return v


def _g_eff(ctx: MathCtx, s, x, g):
    """Clip-scale + coupled weight decay + LARS, folded into the stage
    (clip first, then ``wd*x + g``, then the trust ratio)."""
    if ctx.clip:
        g = _bcast(s["gs"], g) * g
    if ctx.coupled_wd:
        g = ctx.wd * x + g
    if ctx.lars:
        g = _bcast(s["r"], g) * g
    return g


def _with_nesterov(ctx: MathCtx, m_new, d):
    """The applied direction: m (heavy ball) or beta*m + d (Nesterov)."""
    return ctx.beta * m_new + d if ctx.nesterov else m_new


def _decay(ctx: MathCtx, lr, x_new):
    if ctx.decoupled_wd:
        return x_new - lr * ctx.wd * x_new
    return x_new


def _safe_lr(lr):
    return torch.clamp(lr, min=1e-12)


def staleness_damping(cfg, gap, device=None) -> torch.Tensor:
    """Per-gap damping factor ``max(sa_damping ** gap, sa_floor)`` of the
    staleness-aware estimator; exactly 1 at gap 0 and for ``gap=None``."""
    if gap is None:
        return torch.ones((), dtype=torch.float32, device=device)
    gap = torch.as_tensor(gap, device=device).to(torch.float32)
    base = torch.tensor(getattr(cfg, "sa_damping", 0.5), dtype=torch.float32, device=device)
    floor = getattr(cfg, "sa_floor", 0.0)
    return torch.clamp(torch.pow(base, gap), min=floor)


def _sg_of(s, like):
    """The stage's damping factor, broadcast against a leaf value: scalar, or
    ``(n,)`` reshaped to ``(n, 1, ...)`` in the stacked layout."""
    return _bcast(s.get("sg", 1.0), like)


def pre_math(op: str, ctx: MathCtx, s, **v):
    """Payload stage: f32 leaf values in ``v`` -> dict of f32 outputs."""
    lr = s["lr"]
    if op == "grad_step":
        return {"payload": v["x"] - lr * _g_eff(ctx, s, v.get("x"), v["g"])}
    if op == "identity_g":
        return {"payload": _g_eff(ctx, s, v.get("x"), v["g"])}
    if op == "momentum_payload":
        g = _g_eff(ctx, s, v["x"], v["g"])
        m = ctx.beta * v["m"] + g
        return {"payload": v["x"] - lr * _with_nesterov(ctx, m, g), "m": m}
    if op == "momentum_accum":
        g = _g_eff(ctx, s, v.get("x"), v["g"])
        m = ctx.beta * v["m"] + g
        return {"payload": m, "m": m}
    if op == "x_minus_lr_m":
        return {"payload": v["x"] - lr * v["m"]}
    if op == "momentum_keep_x":
        g = _g_eff(ctx, s, v["x"], v["g"])
        return {"payload": v["x"], "m": ctx.beta * v["m"] + g}
    if op == "qg_payload":
        g = _g_eff(ctx, s, v["x"], v["g"])
        return {"payload": v["x"] - lr * (ctx.beta * v["m"] + g)}
    if op == "d2_payload":
        g = _g_eff(ctx, s, v["x"], v["g"])
        m = ctx.beta * v["m"] + g
        z = 2.0 * v["x"] - v["x_prev"] - lr * (m - v["m_prev"])
        return {"payload": z, "m": m}
    raise ValueError(f"unknown pre op {op!r}")


def post_math(op: str, ctx: MathCtx, s, **v):
    """Recombination stage: f32 leaf values in ``v`` -> dict of f32 outputs."""
    lr = s["lr"]
    safe_lr = _safe_lr(lr)
    if op == "assign_x":
        return {"x": _decay(ctx, lr, v["mix"])}
    if op == "assign_m":
        return {"m": v["mix"]}
    if op == "mix_minus_lr_m":
        return {"x": _decay(ctx, lr, v["mix"] - lr * v["m"])}
    if op == "momentum_step":
        m = ctx.beta * v["m"] + v["mix"]
        x = v["x"] - lr * _with_nesterov(ctx, m, v["mix"])
        return {"x": _decay(ctx, lr, x), "m": m}
    if op == "qg_post":
        m = ctx.beta * v["m"] + (1.0 - ctx.beta) * (v["x"] - v["mix"]) / safe_lr
        return {"x": _decay(ctx, lr, v["mix"]), "m": m}
    if op == "decentlam_post":
        g_tilde = (v["x"] - v["mix"]) / safe_lr
        m = ctx.beta * v["m"] + g_tilde
        x = v["x"] - lr * _with_nesterov(ctx, m, g_tilde)
        return {"x": _decay(ctx, lr, x), "m": m}
    if op == "decentlam_sa_post":
        # gap-scheduled decentlam -> dsgd interpolation; sg == 1 (gap 0) is
        # decentlam_post exactly (see repro.core.update_spec for the reason)
        sg = _sg_of(s, v["x"])
        drift = (v["x"] - v["mix"]) / safe_lr
        g_eff = _g_eff(ctx, s, v["x"], v["g"])
        m = ctx.beta * v["m"] + (sg * drift + (1.0 - sg) * g_eff)
        if ctx.nesterov:
            applied = sg * (ctx.beta * m) + drift
        else:
            applied = sg * (ctx.beta * v["m"]) + drift
        x = v["x"] - lr * applied
        return {"x": _decay(ctx, lr, x), "m": m}
    raise ValueError(f"unknown post op {op!r}")


# ---------------------------------------------------------------------------
# Preprocessing scalars (the only reductions in the tail)
# ---------------------------------------------------------------------------


def _sq_sum(x) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def grad_scalars(cfg, x: Tree, g: Tree, *, tp=None, sharded: list | None = None
                 ) -> dict[str, Any]:
    """Scalars applied inside the fused stages: ``gs`` (global-norm clip
    scale) and ``r`` (LARS trust ratio, a tree of per-leaf scalars).  Entries
    are 1.0 when the feature is off.

    With a model group (``tp``, a :class:`~repro_torch.models.layers.
    TPContext` of size > 1) ``x`` and ``g`` are a rank's shards and
    ``sharded`` says, leaf by leaf, which are split over the group: a
    sharded leaf's squared norm is summed over the group and a replicated
    one counted once, so every rank gets the node's tp = 1 scalars."""
    if tp is not None and tp.enabled:
        return _grad_scalars_tp(cfg, x, g, tp, sharded)
    dev = tree_leaves(g)[0].device
    one = torch.ones((), dtype=torch.float32, device=dev)
    s: dict[str, Any] = {"gs": one, "r": one}
    if cfg.grad_clip > 0.0:
        norm = torch.sqrt(torch.sum(torch.stack([_sq_sum(l) for l in tree_leaves(g)])))
        s["gs"] = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    if cfg.lars or cfg.algorithm == "pmsgd-lars":
        gs = s["gs"]
        coupled = cfg.weight_decay > 0.0 and not cfg.decoupled_wd

        def ratio(p, gl):
            p32 = p.to(torch.float32)
            g32 = gs * gl.to(torch.float32) if cfg.grad_clip > 0.0 else gl.to(torch.float32)
            if coupled:
                g32 = cfg.weight_decay * p32 + g32
            pn, gn = torch.sqrt(_sq_sum(p32)), torch.sqrt(_sq_sum(g32))
            denom = gn + cfg.weight_decay * pn + cfg.lars_eps
            return torch.where(
                (pn > 0.0) & (gn > 0.0), cfg.lars_trust * pn / denom, one
            )

        s["r"] = tree_map(ratio, x, g)
    return s


def _grad_scalars_tp(cfg, x: Tree, g: Tree, tp, sharded: list) -> dict[str, Any]:
    dev = tree_leaves(g)[0].device
    one = torch.ones((), dtype=torch.float32, device=dev)
    mask = torch.tensor(sharded, dtype=torch.bool, device=dev)

    def group_sums(sq: list) -> torch.Tensor:
        v = torch.stack(sq)
        zero = torch.zeros((), dtype=v.dtype, device=dev)
        return tp.all_reduce(torch.where(mask, v, zero)) + torch.where(mask, zero, v)

    s: dict[str, Any] = {"gs": one, "r": one}
    clip = cfg.grad_clip > 0.0
    if clip:
        norm = torch.sqrt(torch.sum(group_sums([_sq_sum(l) for l in tree_leaves(g)])))
        s["gs"] = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    if cfg.lars or cfg.algorithm == "pmsgd-lars":
        coupled = cfg.weight_decay > 0.0 and not cfg.decoupled_wd
        psq, gsq = [], []
        for p, gl in zip(tree_leaves(x), tree_leaves(g)):
            p32 = p.to(torch.float32)
            g32 = s["gs"] * gl.to(torch.float32) if clip else gl.to(torch.float32)
            if coupled:
                g32 = cfg.weight_decay * p32 + g32
            psq.append(_sq_sum(p32))
            gsq.append(_sq_sum(g32))
        pn, gn = torch.sqrt(group_sums(psq)), torch.sqrt(group_sums(gsq))
        denom = gn + cfg.weight_decay * pn + cfg.lars_eps
        r = torch.where((pn > 0.0) & (gn > 0.0), cfg.lars_trust * pn / denom, one)
        s["r"] = tree_unflatten(x, list(r.unbind()))
    return s


def node_grad_scalars(cfg, x: Tree, g: Tree, *, tp=None, sharded: list | None = None
                      ) -> dict[str, Any]:
    """:func:`grad_scalars` of each node of stacked ``(n, ...)`` trees: ``gs``
    an ``(n,)`` tensor, ``r`` a tree of ``(n,)`` tensors, entry ``i`` equal to
    ``grad_scalars(cfg, x[i], g[i])`` — each node clips by its own norm and
    takes its own LARS norms, as inside ``repro``'s shard_map step.  A
    feature that is off keeps its scalar 1.0, so without clip and LARS this
    is ``grad_scalars`` itself (no reduction).  ``tp`` and ``sharded``:
    see :func:`grad_scalars`."""
    clip = cfg.grad_clip > 0.0
    lars = bool(cfg.lars or cfg.algorithm == "pmsgd-lars")
    if not (clip or lars):
        return grad_scalars(cfg, x, g)
    n = tree_leaves(g)[0].shape[0]
    per = [
        grad_scalars(cfg, tree_map(lambda a: a[i], x), tree_map(lambda a: a[i], g), tp=tp,
                     sharded=sharded)
        for i in range(n)
    ]
    s = dict(per[0])
    if clip:
        s["gs"] = torch.stack([p["gs"] for p in per])
    if lars:
        s["r"] = tree_map(lambda *rs: torch.stack(rs), *[p["r"] for p in per])
    return s


# ---------------------------------------------------------------------------
# Stage executors + the phase walker
# ---------------------------------------------------------------------------

# stage(kind, op, ctx, operands, scalars, like_x) -> dict[name, Tree]
StageFn = Callable[..., dict[str, Tree]]


def _f32_tree(tree: Tree) -> Tree:
    return tree_map(lambda a: a.to(torch.float32), tree)


def leaf_scalars(scalars, n_leaves: int, ctx: MathCtx) -> list[dict]:
    """Per-leaf ``{lr, gs, r, sg}``.  ``r`` may be a tree of per-leaf values
    (LARS): scalars, per-node ``(n,)`` tensors, or a plane dict of row
    columns; ``gs`` (clip) and ``sg`` (staleness damping) are scalars or
    ``(n,)``.  The stage math broadcasts an ``(n,)`` value over the node
    axis (:func:`_bcast`)."""
    r = scalars.get("r")
    if ctx.lars and isinstance(r, dict):
        rs = tree_leaves(r)
    else:
        rs = [r if r is not None else 1.0] * n_leaves
    gs = scalars.get("gs", 1.0)
    sg = scalars.get("sg", 1.0)
    return [
        {"lr": scalars["lr"], "gs": gs, "r": rs[i], "sg": sg} for i in range(n_leaves)
    ]


def reference_stage(kind, op, ctx, operands, scalars, like_x, *, out=None):
    """Plain torch oracle executor: per-leaf :func:`pre_math`/:func:`post_math`.

    Output dtype policy (matched by the fused executor): ``x`` keeps the
    dtype of ``like_x``; ``payload`` and ``m`` are f32.  ``out`` (``{name:
    tree}``) names buffers that outputs are copied into, as the fused
    executors write into them.
    """
    names = tuple(operands)
    first = operands[names[0]]
    cols = {n: tree_leaves(operands[n]) for n in names}
    x_like = tree_leaves(like_x)
    n_leaves = len(cols[names[0]])
    per_leaf_s = leaf_scalars(scalars, n_leaves, ctx)
    math = pre_math if kind == "pre" else post_math

    into = {n: tree_leaves(t) for n, t in (out or {}).items()}
    out_cols: dict[str, list] = {}
    for i in range(n_leaves):
        vals = {n: cols[n][i].to(torch.float32) for n in names}
        res = math(op, ctx, per_leaf_s[i], **vals)
        for name, val in res.items():
            if name == "x":
                val = val.to(x_like[i].dtype)
            if name in into:
                val = into[name][i].copy_(val)
            out_cols.setdefault(name, []).append(val)
    return {n: tree_unflatten(first, col) for n, col in out_cols.items()}


def run_update(
    spec: UpdateSpec,
    cfg,
    *,
    x: Tree,
    g: Tree,
    state: dict[str, Tree],
    lr,
    step_idx: int,
    gossip,
    mean,
    comp_state: Tree,
    stage: StageFn = reference_stage,
    node_gaps=None,
    scalars: dict | None = None,
):
    """Walk the spec's phases; returns ``(x, new_state, comp_state)``.

    ``x`` may be any float dtype (the stages compute in f32 and cast the
    parameter output back); ``g`` and the state buckets are f32.  ``stage``
    selects the executor: :func:`reference_stage` or the fused engine's
    (``repro_torch.kernels.fused_update.make_stage``).  ``node_gaps``
    overrides the per-node version gaps a staleness-aware spec folds in;
    ``scalars`` overrides :func:`grad_scalars`.
    """
    dev = tree_leaves(x)[0].device
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    safe_lr = _safe_lr(lr)
    scalars = dict(grad_scalars(cfg, x, g)) if scalars is None else dict(scalars)
    scalars["lr"] = lr

    env: dict[str, Tree] = {"x": x, "g": g}
    for k in ("m", "x_prev", "m_prev"):
        if k in state:
            env[k] = state[k]
    x0 = x

    for i, ph in enumerate(spec.phases):
        ctx = phase_ctx(cfg, spec, i)

        # --- PRE: build the payload (and usually the new momentum) ---------
        if pre_is_free(ph, ctx):
            payload = _f32_tree(env["g"])  # nothing to fuse
        else:
            ins, _ = pre_io(ph.pre, ctx)
            # a channel that records payloads (a delay ring) may offer the
            # buffer the payload would be copied into: the stage writes there
            slot = (gossip.payload_slot(comp_state)
                    if ph.comm == "gossip" and isinstance(gossip, GossipChannel) else None)
            out = stage(
                "pre", ph.pre, ctx, {n: env[n] for n in ins}, scalars, env["x"],
                **({"out": {"payload": slot}} if slot is not None else {}),
            )
            payload = out.pop("payload")
            env.update(out)

        # --- COMM ----------------------------------------------------------
        if ph.comm == "gossip":
            with span("gossip.apply"):
                if isinstance(gossip, GossipChannel):
                    comp_state, mixed = gossip.apply(comp_state, payload, step_idx)
                else:  # closure protocol: (tree, step, comp_state) -> (tree, comp_state)
                    mixed, comp_state = gossip(payload, step_idx, comp_state)
            if spec.staleness_aware:
                gaps = node_gaps
                if gaps is None and isinstance(gossip, GossipChannel):
                    gaps = gossip.node_gaps(comp_state)
                scalars["sg"] = staleness_damping(cfg, gaps, dev)
        elif ph.comm == "mean":
            mixed = mean(payload)
        else:
            mixed = payload
        del payload
        last_mixed = mixed

        # --- POST: recombine -----------------------------------------------
        if post_is_free(ph, ctx):
            if ph.post == "assign_m":
                env["m"] = _f32_tree(mixed)
            else:  # assign_x
                env["x"] = tree_map(lambda p, v: v.to(p.dtype), env["x"], mixed)
        else:
            ins, _ = post_io(ph.post)
            operands = {n: (mixed if n == "mix" else env[n]) for n in ins}
            out = stage("post", ph.post, ctx, operands, scalars, env["x"])
            env.update(out)

    x = env["x"]
    new_state = dict(state)
    if "m" in state:
        new_state["m"] = env["m"]
    if spec.d2_state:
        new_state["x_prev"] = _f32_tree(x0)
        new_state["m_prev"] = env["m"]

    if spec.slowmo_outer:
        # the sync must see the f32 inner-step result (see repro's run_update)
        x32 = _f32_tree(last_mixed)
        u, anchor = state["u"], state["anchor"]
        if (step_idx + 1) % cfg.slowmo_period == 0:
            xbar = mean(x32)
            u = tree_map(
                lambda uu, a, xb: cfg.slowmo_momentum * uu + (a - xb) / safe_lr,
                u, anchor, xbar,
            )
            anchor = tree_map(lambda a, uu: a - cfg.slowmo_lr * lr * uu, anchor, u)
            x = tree_map(lambda p, v: v.to(p.dtype, copy=True), x, anchor)
        new_state["u"] = u
        new_state["anchor"] = anchor
        if cfg.weight_decay > 0.0 and cfg.decoupled_wd:
            x = tree_map(
                lambda p: (
                    p.to(torch.float32) - lr * cfg.weight_decay * p.to(torch.float32)
                ).to(p.dtype),
                x,
            )

    return x, new_state, comp_state
