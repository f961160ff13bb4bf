"""Host-side peer health tracking from gossip version gaps
(``repro.resilience.health``, plain numpy).

:class:`HealthMonitor` turns a per-node gap vector into a per-peer liveness
state machine::

    ALIVE --(gap >= suspect_after)--> SUSPECT --(patience exhausted,
          retries spent)--> DEAD
    SUSPECT --(recover_after clean rounds)--> ALIVE

A suspect peer gets ``dead_after`` rounds of patience; each time it runs out
while retries remain, the monitor grants another window scaled by
``backoff``.  ``DEAD`` is terminal for the gap-driven path: only
:meth:`report_alive` (a rejoin handshake) resurrects a peer, and
:meth:`report_dead` declares death at once.  :meth:`trust` feeds
:func:`~repro_torch.resilience.resilient.with_trust`; :meth:`dead` feeds
:func:`~repro_torch.launch.elastic.plan_recovery`.

Delayed transports report ``gap == delay`` in steady state for healthy
peers, so ``suspect_after`` must exceed the configured staleness.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ALIVE", "SUSPECT", "DEAD", "HealthConfig", "HealthMonitor", "fleet_sender_gaps"]


def fleet_sender_gaps(channel, state) -> np.ndarray:
    """Host-side ``(n,)`` per-*sender* version gaps: entry ``j`` is the
    worst age at which any receiver consumed node ``j``'s payload (the
    column max of ``channel.version_gaps``), the signal the monitor wants —
    it attributes a silent peer's staleness to that peer alone.

    A distributed channel's state describes every edge on every rank (the
    chaos counters and the ring counts are the same on all), and each rank
    contributes its own column through the gather that
    :func:`~repro_torch.core.gossip.fleet_node_gaps` uses: a collective,
    every rank calls it."""
    n = channel.topology.n
    if not channel.has_staleness():
        return np.zeros(n, np.int32)
    cols = np.max(np.asarray(channel.version_gaps(state)), axis=0).astype(np.int32)
    if channel._stacked_layout:
        return cols
    group = channel.group
    mine = torch.tensor([int(cols[group.rank])], dtype=torch.int64, device=group.comm_device)
    every = [torch.empty_like(mine) for _ in range(group.world)]
    dist.all_gather(every, mine, group=group.pg)
    return torch.cat(every).cpu().numpy().astype(np.int32)


ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"
_CODES = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    suspect_after: int = 1  # incident gap (rounds) that makes a peer suspect
    dead_after: int = 3  # suspect rounds of patience before death/retry
    backoff: float = 2.0  # patience multiplier per granted retry
    max_retries: int = 1  # extra patience windows before death
    recover_after: int = 1  # consecutive clean rounds for suspect -> alive

    def __post_init__(self):
        if self.suspect_after < 1 or self.dead_after < 1 or self.recover_after < 1:
            raise ValueError("health thresholds must be >= 1")
        if self.backoff < 1.0 or self.max_retries < 0:
            raise ValueError("backoff must be >= 1 and max_retries >= 0")

    def patience(self, retries: int) -> int:
        """Suspect rounds tolerated in the ``retries``-th window."""
        return max(1, int(round(self.dead_after * self.backoff**retries)))


class HealthMonitor:
    """Per-peer ALIVE / SUSPECT / DEAD tracking (plain numpy, host-side)."""

    def __init__(self, n: int, config: HealthConfig = HealthConfig()):
        self.n = int(n)
        self.config = config
        self._state = np.zeros(self.n, np.int8)  # _CODES
        self._missed = np.zeros(self.n, np.int64)  # consecutive suspect rounds
        self._clean = np.zeros(self.n, np.int64)  # consecutive healthy rounds
        self._retries = np.zeros(self.n, np.int64)
        self.rounds = 0

    def observe(self, gaps: Sequence[int]) -> np.ndarray:
        """Fold one round's per-node gaps into the state machine; returns
        the updated :meth:`trust` mask."""
        gaps = np.asarray(gaps)
        if gaps.shape != (self.n,):
            raise ValueError(f"expected ({self.n},) gaps, got {gaps.shape}")
        cfg = self.config
        for i in range(self.n):
            if self._state[i] == _CODES[DEAD]:
                continue
            if int(gaps[i]) >= cfg.suspect_after:
                self._clean[i] = 0
                self._missed[i] += 1
                self._state[i] = _CODES[SUSPECT]
                if self._missed[i] >= cfg.patience(int(self._retries[i])):
                    if self._retries[i] < cfg.max_retries:
                        self._retries[i] += 1  # grant a backed-off window
                        self._missed[i] = 0
                    else:
                        self._state[i] = _CODES[DEAD]
            else:
                self._missed[i] = 0
                self._clean[i] += 1
                if self._state[i] == _CODES[SUSPECT] and self._clean[i] >= cfg.recover_after:
                    self._state[i] = _CODES[ALIVE]
                    self._retries[i] = 0
        self.rounds += 1
        return self.trust

    def report_dead(self, nodes: Iterable[int]) -> None:
        """External death notice: declare the peers dead immediately."""
        for i in nodes:
            self._state[int(i)] = _CODES[DEAD]
            self._missed[int(i)] = self._clean[int(i)] = 0

    def report_alive(self, nodes: Iterable[int]) -> None:
        """Rejoin handshake: resurrect peers with a clean slate."""
        for i in nodes:
            self._state[int(i)] = _CODES[ALIVE]
            self._missed[int(i)] = self._clean[int(i)] = 0
            self._retries[int(i)] = 0

    @property
    def trust(self) -> np.ndarray:
        """``(n,)`` bool: peers whose payloads keep their mixing weight
        (ALIVE only — suspects are distrusted while under review)."""
        return self._state == _CODES[ALIVE]

    def dead(self) -> tuple[int, ...]:
        return tuple(int(i) for i in np.flatnonzero(self._state == _CODES[DEAD]))

    def states(self) -> list[str]:
        names = {v: k for k, v in _CODES.items()}
        return [names[int(s)] for s in self._state]
