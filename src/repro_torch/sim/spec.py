"""The simulator's front door: one frozen spec (the port of
``repro.sim.spec``).

:class:`SimSpec` collects *what to simulate* into a single frozen value
consumed by ``simulate(opt, spec, params0, grad_fn)`` — only the things
that are genuinely per-run (the optimizer, the initial parameters, the
gradient function) stay positional.

``topology`` takes anything ``core.topology.build_topology`` resolves: a
family name string, a :class:`~repro_torch.core.topology.TopologySpec`, or
a built :class:`~repro_torch.core.topology.Topology`.  ``engine`` selects
the event-loop execution strategy: ``"vectorized"`` (node-batched),
``"pernode"`` (the one-event-at-a-time reference loop), or ``"auto"``
(vectorized).  The two engines agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..core.topology import Topology, TopologySpec
from .events import Scenario

Tree = Any
GradFn = Callable[[Tree, Any], Tree]

__all__ = ["SimSpec"]

_ENGINES = ("auto", "vectorized", "pernode")


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """What to simulate: cluster shape, schedule, condition, instrumentation.

    * ``topology`` / ``n`` — the gossip graph and node count.
    * ``n_steps`` / ``lr`` — training horizon and learning rate (float or
      ``step -> lr`` schedule).
    * ``scenario`` — a :class:`~repro_torch.sim.events.Scenario`, a registry
      name, or ``None`` for the homogeneous baseline.
    * ``seed`` — per-node clock RNG seed.
    * ``record_dt`` — > 0 records a trace entry each time simulated time
      crosses a multiple of it.
    * ``metric_fn`` — stacked params -> scalar, evaluated on trace entries
      and the final state.
    * ``restrict`` — ``(alive_original_indices) -> grad_fn`` for rescale
      recoveries (required only when failures exceed the reroute budget).
    * ``compression`` — ``bf16`` / ``int8`` / ``topk:<rate>`` wire
      compression on every gossip payload.
    * ``engine`` — ``"auto"`` | ``"vectorized"`` | ``"pernode"`` event-loop
      strategy (ignored by ``engine="delayed"`` scenarios, which run
      synchronous rounds either way).
    * ``sparse`` — ``None`` (dense gossip) or a row-sparse channel mode
      (``"exact"`` | ``"delta"``, see :mod:`repro_torch.sparse.channel`):
      every step marks the rows its gradient touched, the pernode engine
      row-delta-compacts its parameter mailboxes, and ``SimResult.comm``
      accounts the bytes.
    * ``sparse_crossover`` — the dirty-row fraction past which a bucket
      ships dense.
    """

    topology: str | TopologySpec | Topology = "ring"
    n: int = 8
    n_steps: int = 100
    lr: Any = 1e-3
    scenario: Scenario | str | None = None
    seed: int = 0
    record_dt: float = 0.0
    metric_fn: Callable[[Tree], Any] | None = None
    restrict: Callable[[tuple[int, ...]], GradFn] | None = None
    compression: str | None = None
    engine: str = "auto"
    sparse: str | None = None
    sparse_crossover: float = 0.9

    def __post_init__(self):
        if self.n < 1 or self.n_steps < 1 or self.record_dt < 0.0:
            raise ValueError(f"want n >= 1, n_steps >= 1 and record_dt >= 0; got n {self.n}, "
                             f"n_steps {self.n_steps}, record_dt {self.record_dt}")
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; available: {_ENGINES}"
            )
        if self.sparse not in (None, "exact", "delta"):
            raise ValueError(
                f"unknown sparse mode {self.sparse!r}; available: "
                "None | 'exact' | 'delta'"
            )
        if not 0.0 < self.sparse_crossover <= 1.0:
            raise ValueError(
                f"sparse_crossover must be in (0, 1], got {self.sparse_crossover}"
            )
