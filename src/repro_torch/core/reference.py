"""Stacked (mesh-free) reference harness for the decentralized optimizers
(the port of ``repro.core.reference``).

Runs any algorithm from :mod:`repro_torch.core.optimizers` with leaves
stacked over a leading node axis ``(n, ...)`` and a stacked gossip channel:
the engine of the paper's bias experiments (Figs. 2-3, Props. 1-3), which
are pure optimization studies.  The optimizer's stage is the plain one, as
in the reference (its ``make_optimizer`` walks the plain stage too).

Also provides the full-batch linear-regression problem of App. G.2 and the
closed-form quantities (x*, b^2) needed to measure inconsistency bias.  Its
data come from numpy's ``default_rng(seed)`` exactly as the reference makes
them, so both packages hold the same f32 arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..utils import resolve_device, tree_leaves
from .gossip import GossipChannel, StackedChannel, make_stacked_mean
from .optimizers import Optimizer, OptimizerConfig, make_optimizer
from .topology import Topology

Tree = Any

__all__ = [
    "run_stacked",
    "LinearRegressionProblem",
    "make_linear_regression",
    "consensus_distance",
    "bias_to_optimum",
    "run_bias_experiment",
]


def run_stacked(
    opt: Optimizer,
    topology: Topology,
    params0: Tree,
    grad_fn: Callable[[Tree, int], Tree],
    *,
    lr,
    n_steps: int,
    record_every: int = 0,
    metric_fn: Callable[[Tree], torch.Tensor] | None = None,
    channel: GossipChannel | None = None,
):
    """Iterate ``opt`` with stacked gossip.

    ``params0`` leaves are ``(n, ...)`` (one replica per node); ``grad_fn``
    maps stacked params + step to stacked grads (already per-node).  ``lr``
    may be a float or a ``step -> lr`` schedule.  ``channel`` is any
    stacked-layout :class:`~repro_torch.core.gossip.GossipChannel` (default:
    the plain :class:`~repro_torch.core.gossip.StackedChannel`); its state —
    delay buffers, compression error feedback — is threaded through the
    steps, and staleness-aware algorithms (``decentlam-sa``) read their
    per-node version gaps from it.  ``metric_fn`` is recorded at ``k %
    record_every == 0`` and at the last step.  Returns final params,
    optimizer state, and the metric trace (a numpy array)."""
    if channel is None:
        channel = StackedChannel(topology)
    mean = make_stacked_mean(topology.n)
    lr_fn = lr if callable(lr) else (lambda _s: lr)
    dev = tree_leaves(params0)[0].device

    state = opt.init(params0)
    chstate = channel.init(params0)
    params = params0
    trace: list[float] = []
    for k in range(n_steps):
        grads = grad_fn(params, k)
        with torch.no_grad():
            params, state, chstate = opt.step(
                params, grads, state,
                lr=torch.as_tensor(lr_fn(k), dtype=torch.float32, device=dev),
                step_idx=k, gossip=channel, mean=mean, comp_state=chstate,
            )
        if record_every and (k % record_every == 0 or k == n_steps - 1):
            if metric_fn is None:
                raise ValueError("record_every needs a metric_fn")
            trace.append(float(metric_fn(params)))
    return params, state, np.asarray(trace)


# ---------------------------------------------------------------------------
# App. G.2 — full-batch linear regression over n nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearRegressionProblem:
    """min_x (1/n) sum_i 0.5 ||A_i x - b_i||^2 with per-node data (A_i, b_i)."""

    A: torch.Tensor  # (n, m, d)
    b: torch.Tensor  # (n, m)
    x_star: torch.Tensor  # (d,) global solution
    b_sq: float  # data-inconsistency (1/n) sum ||grad f_i(x*)||^2

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    def grad(self, x_stacked: torch.Tensor) -> torch.Tensor:
        """Full-batch per-node gradient; x_stacked: (n, d)."""
        r = torch.einsum("nmd,nd->nm", self.A, x_stacked) - self.b
        return torch.einsum("nmd,nm->nd", self.A, r)

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.einsum("nmd,d->nm", self.A, x) - self.b
        return 0.5 * torch.mean(torch.sum(r**2, dim=-1))

    def smoothness(self) -> tuple[float, float]:
        """(L, mu) of the average objective."""
        A = self.A.detach().cpu().numpy()
        H = np.mean(np.einsum("nmd,nme->nde", A, A), axis=0)
        ev = np.linalg.eigvalsh(H)
        return float(ev[-1]), float(ev[0])


def make_linear_regression(
    n: int = 8, m: int = 50, d: int = 30, *, noise: float = 0.01, seed: int = 0,
    heterogeneity: float = 1.0, device: str | torch.device | None = None,
) -> LinearRegressionProblem:
    """Per App. G.2: A_i ~ N(0,1), b_i = A_i x^o + s, white noise |s|=noise,
    drawn in float64 from ``default_rng(seed)`` in the reference's order and
    rounded to f32 once, on ``device`` (the card unless the caller asks for
    the CPU).

    ``heterogeneity`` scales a per-node shift of x^o, controlling b^2 (the
    data-inconsistency) independently of the noise.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m, d))
    x_o = rng.standard_normal(d)
    shift = heterogeneity * rng.standard_normal((n, d)) / np.sqrt(d)
    b = np.einsum("nmd,nd->nm", A, x_o[None, :] + shift)
    b = b + noise * rng.standard_normal((n, m))

    # global solution of the quadratic: x* = (sum A_i^T A_i)^-1 sum A_i^T b_i
    H = np.einsum("nmd,nme->de", A, A)
    c = np.einsum("nmd,nm->d", A, b)
    x_star = np.linalg.solve(H, c)

    g_star = np.einsum("nmd,nm->nd", A, np.einsum("nmd,d->nm", A, x_star) - b)
    b_sq = float(np.mean(np.sum(g_star**2, axis=-1)))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return LinearRegressionProblem(A=f32(A), b=f32(b), x_star=f32(x_star), b_sq=b_sq)


def consensus_distance(x_stacked: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_i ||x_i - x_bar||^2."""
    xb = torch.mean(x_stacked, dim=0, keepdim=True)
    return torch.mean(torch.sum((x_stacked - xb) ** 2, dim=-1))


def bias_to_optimum(x_stacked: torch.Tensor, x_star: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_i ||x_i - x*||^2 / ||x*||^2 (paper Fig. 2-3 y-axis)."""
    d = torch.sum((x_stacked - x_star[None, :]) ** 2, dim=-1)
    return torch.mean(d) / torch.sum(x_star**2)


def run_bias_experiment(
    algorithm: str,
    problem: LinearRegressionProblem,
    topology: Topology,
    *,
    lr: float = 1e-3,
    momentum: float = 0.8,
    n_steps: int = 3000,
    record_every: int = 50,
    channel: GossipChannel | None = None,
):
    """Full-batch bias trajectory (Figs. 2-3 reproduction), on the
    problem's device.

    ``channel`` overrides the transport (e.g. a
    :class:`~repro_torch.core.gossip.DelayedStackedChannel` to study the
    bias under stale mixing)."""
    opt = make_optimizer(OptimizerConfig(algorithm=algorithm, momentum=momentum))
    x0 = torch.zeros((problem.n, problem.dim), dtype=torch.float32, device=problem.A.device)
    _, _, trace = run_stacked(
        opt, topology, x0, lambda x, _step: problem.grad(x),
        lr=lr, n_steps=n_steps, record_every=record_every,
        metric_fn=lambda x: bias_to_optimum(x, problem.x_star),
        channel=channel,
    )
    return trace
