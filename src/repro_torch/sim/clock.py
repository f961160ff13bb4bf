"""Virtual time for the cluster simulator: event queue + step-duration models
(a copy of ``repro.sim.clock``: numpy only).

Simulated time is measured in *nominal steps*: a healthy node with the
default model takes ~1.0 time units per optimizer step, so a wall-clock
projection only has to price one nominal step.

Determinism contract: every random draw comes from a per-node
``np.random.default_rng([seed, node])`` stream and each node consumes its
stream in its own step order, so results are independent of the order in
which the event loop interleaves nodes.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Protocol

import numpy as np

__all__ = [
    "EventQueue",
    "StepDuration",
    "ConstantDuration",
    "LognormalDuration",
    "PeriodicStragglerDuration",
    "node_rngs",
]


class EventQueue:
    """Min-heap of ``(time, node)`` completion events.

    Ties are broken by insertion order (a monotonic sequence number), so a
    given schedule of pushes always pops in the same order — the event loop
    is deterministic even when durations collide exactly.
    """

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, int]] = []
        self._seq = 0

    def push(self, time: float, node: int, tag: int = 0) -> None:
        """``tag`` lets callers invalidate queued events lazily (e.g. a
        per-node epoch bumped on failure): stale tags are skipped on pop."""
        heapq.heappush(self._heap, (float(time), self._seq, node, tag))
        self._seq += 1

    def pop(self) -> tuple[float, int, int]:
        time, _, node, tag = heapq.heappop(self._heap)
        return time, node, tag

    def peek_time(self) -> float:
        """Completion time of the next event without popping it.

        The vectorized event engine uses this to drain a whole same-time
        completion batch (popping while ``peek_time() == t``) — exact float
        equality is intentional: ties come from identical constant-duration
        arithmetic, and FIFO tie-breaking within the batch is preserved by
        the heap's sequence numbers.
        """
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class StepDuration(Protocol):
    """Per-node step-duration model: simulated seconds for ``node``'s
    ``step``-th optimizer step, drawing randomness (if any) from ``rng``."""

    def __call__(self, node: int, step: int, rng: np.random.Generator) -> float: ...


@dataclasses.dataclass(frozen=True)
class ConstantDuration:
    """Every step takes exactly ``mean`` time units (the lockstep oracle)."""

    mean: float = 1.0

    def __call__(self, node: int, step: int, rng: np.random.Generator) -> float:
        return self.mean


@dataclasses.dataclass(frozen=True)
class LognormalDuration:
    """Lognormal jitter with E[duration] = ``mean`` (heavy right tail, the
    standard straggler distribution for real clusters)."""

    mean: float = 1.0
    sigma: float = 0.2

    def __call__(self, node: int, step: int, rng: np.random.Generator) -> float:
        # mu chosen so the expectation is exactly `mean`
        mu = np.log(self.mean) - 0.5 * self.sigma**2
        return float(rng.lognormal(mu, self.sigma))

    def __post_init__(self):
        assert self.mean > 0 and self.sigma >= 0


@dataclasses.dataclass(frozen=True)
class PeriodicStragglerDuration:
    """Every ``period``-th step runs ``factor``x slow (GC pause / checkpoint
    flush / preemption-style periodic stalls)."""

    base: float = 1.0
    factor: float = 4.0
    period: int = 10
    phase: int = 0

    def __call__(self, node: int, step: int, rng: np.random.Generator) -> float:
        slow = (step + self.phase) % self.period == 0
        return self.base * (self.factor if slow else 1.0)

    def __post_init__(self):
        assert self.period >= 1 and self.factor > 0


def node_rngs(seed: int, n: int) -> list[np.random.Generator]:
    """One independent deterministic stream per node."""
    return [np.random.default_rng([int(seed), i]) for i in range(n)]
