"""Simulation results + quality/throughput metrics (the port of
``repro.sim.metrics``).

Quality metrics reuse the closed forms from :mod:`repro_torch.core.reference`
(``consensus_distance``, ``bias_to_optimum`` against the App. G.2 global
optimum), so a scenario's bias numbers are directly comparable with the
paper's Figs. 2-3 lockstep reproduction.

``effective_batch_fraction`` captures the large-batch story under
heterogeneity: the fraction of the ideal ``n * n_steps`` gradient
contributions the cluster actually computed by the time the run finished
(stragglers and fail-stops shrink the *effective* batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.reference import bias_to_optimum, consensus_distance  # noqa: F401 — re-export

Tree = Any

__all__ = [
    "SimResult",
    "effective_batch_fraction",
    "consensus_distance",
    "bias_to_optimum",
    "is_diverged",
]

# relative bias >> 1 means the iterates left the basin entirely — treat it
# as divergence even when overflow hasn't hit inf yet
DIVERGENCE_BIAS = 1e6


def is_diverged(*biases: float | None) -> bool:
    """Whether any of the given relative-bias values marks a diverged run:
    non-finite, missing, or past :data:`DIVERGENCE_BIAS`.  Diverged runs
    must not report rankable quality metrics."""
    for b in biases:
        if b is None or not np.isfinite(b) or b >= DIVERGENCE_BIAS:
            return True
    return False


@dataclasses.dataclass
class SimResult:
    """Outcome of one simulated scenario run."""

    params: Tree  # stacked (n_final, ...) final per-node params
    opt_state: Tree
    steps: np.ndarray  # (n_final,) optimizer steps completed per node
    stall_time: np.ndarray  # (n_final,) simulated time spent SSP-blocked
    sim_time: float  # simulated time at termination (nominal steps)
    n_nodes: int  # final cluster size (differs from start after rescale)
    n_start: int
    target_steps: int
    recovery_mode: str  # "none" | "reroute" | "rescale" (last transition)
    dead: tuple[int, ...]  # nodes dead at termination (original indices)
    trace: list[dict]  # periodic records: {"t", "min_step", "max_step", ...}
    events_log: list[dict]  # applied scenario events with fire times
    kept: tuple[int, ...] = ()  # original indices of the final cluster's nodes
    final_metric: float | None = None  # metric_fn on final stacked params
    final_consensus: float | None = None
    # sparse-gossip byte accounting (SimSpec.sparse only)
    comm: dict | None = None

    @property
    def alive(self) -> np.ndarray:
        mask = np.ones(self.n_nodes, dtype=bool)
        if self.recovery_mode != "rescale":
            mask[list(self.dead)] = False
        return np.nonzero(mask)[0]

    def summary(self) -> dict:
        alive = self.alive
        return {
            "n_start": self.n_start,
            "n_final": self.n_nodes,
            "recovery_mode": self.recovery_mode,
            "dead": list(self.dead),
            "sim_time": round(float(self.sim_time), 4),
            "steps_min": int(self.steps[alive].min()),
            "steps_max": int(self.steps[alive].max()),
            "steps_total": int(self.steps[alive].sum()),
            "stall_time_total": round(float(self.stall_time[alive].sum()), 4),
            "effective_batch_fraction": round(
                effective_batch_fraction(self), 4
            ),
            "final_metric": self.final_metric,
            "final_consensus": self.final_consensus,
            "events": [e["event"] for e in self.events_log],
        }


def effective_batch_fraction(result: SimResult) -> float:
    """Gradient contributions computed vs the ideal homogeneous cluster.

    Ideal: ``n_start`` nodes each finishing ``target_steps`` steps in
    ``target_steps`` time units.  The ratio of actually-completed alive
    steps (capped at the simulated horizon) against that ideal measures how
    much of the paper's "large batch" survives stragglers and failures.
    """
    ideal = float(result.n_start * result.target_steps)
    done = float(result.steps[result.alive].sum())
    return done / ideal if ideal > 0 else 0.0
