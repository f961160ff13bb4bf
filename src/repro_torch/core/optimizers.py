"""Decentralized momentum optimizers (the paper's subject).

The port of ``repro.core.optimizers``: every algorithm is an ``(init,
step)`` pair over stacked parameter trees, with communication injected as
a gossip channel (or closure) and an exact-mean closure.  ``step`` walks the
algorithm's :class:`~repro_torch.core.update_spec.UpdateSpec` with the plain
:func:`~repro_torch.core.update_spec.reference_stage`; the fused engine
(:mod:`repro_torch.kernels.fused_update`) walks the same spec with one
kernel launch per stage and leaf.

===========  ================================================================
pmsgd        parallel momentum SGD:  m <- b m + mean(g); x <- x - lr m
pmsgd-lars   + layer-wise adaptive rate scaling [You et al. 2017]
dsgd         ATC decentralized SGD (eq. 4-5):  x <- G(x - lr g)
dmsgd        Alg. 1:  m <- b m + g; x <- G(x - lr m)
da-dmsgd     [Yu et al. 2019]: m <- G(b m + g); x <- G(x - lr m)
awc-dmsgd    [Balu et al. 2020]: m <- b m + g; x <- G(x) - lr m
slowmo       [Wang et al. 2019]: inner DmSGD + periodic exact-average slow
             momentum outer update
qg-dmsgd     [Lin et al. 2021] heavy-ball quasi-global momentum
d2-dmsgd     D^2 [Tang et al. 2018] with momentum on the local update
decentlam    **Alg. 2 / eq. (17)**:
             g~ = (x - G(x - lr g)) / lr;  m <- b m + g~;  x <- x - lr m
decentlam-sa staleness-aware DecentLaM (gap-damped momentum estimator)
===========  ================================================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..utils import tree_map
from .update_spec import reference_stage, run_update, update_spec

Tree = Any

__all__ = [
    "OptimizerConfig",
    "Optimizer",
    "make_optimizer",
    "state_keys",
    "update_spec",
    "ALGORITHMS",
]

ALGORITHMS = (
    "pmsgd",
    "pmsgd-lars",
    "dsgd",
    "dmsgd",
    "da-dmsgd",
    "awc-dmsgd",
    "slowmo",
    "qg-dmsgd",
    "d2-dmsgd",
    "decentlam",
    "decentlam-sa",
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    algorithm: str = "decentlam"
    momentum: float = 0.9
    nesterov: bool = False  # applies to pmsgd / dmsgd / decentlam updates
    weight_decay: float = 0.0
    decoupled_wd: bool = False
    grad_clip: float = 0.0  # 0 = off; global-norm clip of local grads
    # LARS (pmsgd-lars, or lars=True to compose with any algorithm)
    lars: bool = False
    lars_trust: float = 0.001
    lars_eps: float = 1e-9
    # SlowMo
    slowmo_period: int = 12
    slowmo_momentum: float = 0.5
    slowmo_lr: float = 1.0
    # DecentLaM-SA gap-damping schedule
    sa_damping: float = 0.5
    sa_floor: float = 0.0

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; one of {ALGORITHMS}"
            )
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got {self.momentum}")
        if not 0.0 < self.sa_damping <= 1.0:
            raise ValueError(f"sa_damping is a decay base in (0, 1], got {self.sa_damping}")
        if not 0.0 <= self.sa_floor <= 1.0:
            raise ValueError(f"sa_floor must be in [0, 1], got {self.sa_floor}")


def state_keys(cfg: OptimizerConfig) -> tuple[str, ...]:
    """Names of the optimizer-state buckets (each mirrors the param tree)."""
    keys: list[str] = []
    if cfg.algorithm != "dsgd":
        keys.append("m")
    if cfg.algorithm == "slowmo":
        keys += ["u", "anchor"]
    if cfg.algorithm == "d2-dmsgd":
        keys += ["x_prev", "m_prev"]
    return tuple(keys)


class Optimizer(NamedTuple):
    config: OptimizerConfig
    init: Callable[[Tree], Tree]
    step: Callable[..., tuple[Tree, Tree, Tree]]
    # step(params, grads, state, *, lr, step_idx, gossip, mean,
    #      comp_state={}, node_gaps=None, scalars=None)
    #   -> (params, state, comp_state); scalars overrides grad_scalars
    gossips_per_step: int  # payload sends per iteration (comm accounting)


def _f32_copy(tree: Tree) -> Tree:
    return tree_map(lambda x: x.to(torch.float32, copy=True), tree)


def _zeros_like_f32(tree: Tree) -> Tree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    algo = cfg.algorithm
    spec = update_spec(cfg)

    def init(params: Tree) -> Tree:
        # copies, never views of ``params``: the fused engine may update
        # parameters in place
        st: dict[str, Tree] = {}
        if algo != "dsgd":
            st["m"] = _zeros_like_f32(params)
        if algo == "slowmo":
            st["u"] = _zeros_like_f32(params)
            st["anchor"] = _f32_copy(params)
        if algo == "d2-dmsgd":
            st["x_prev"] = _f32_copy(params)
            st["m_prev"] = _zeros_like_f32(params)
        return st

    def step(
        params, grads, state, *, lr, step_idx, gossip, mean,
        comp_state=None, node_gaps=None, scalars=None,
    ):
        x, new_state, comp_state = run_update(
            spec,
            cfg,
            x=tree_map(lambda p: p.to(torch.float32), params),
            g=tree_map(lambda g: g.to(torch.float32), grads),
            state=state,
            lr=lr,
            step_idx=step_idx,
            gossip=gossip,
            mean=mean,
            comp_state={} if comp_state is None else comp_state,
            stage=reference_stage,
            node_gaps=node_gaps,
            scalars=scalars,
        )
        out = tree_map(lambda p, nx: nx.to(p.dtype), params, x)
        return out, new_state, comp_state

    return Optimizer(
        config=cfg,
        init=init,
        step=step,
        gossips_per_step=spec.gossips_per_step,
    )
