"""Declarative failure/heterogeneity scenarios for the cluster simulator
(a copy of ``repro.sim.events``).

A :class:`Scenario` bundles per-node speed models (:mod:`repro_torch.sim.clock`),
a schedule of cluster events, and (for the synchronous bounded-staleness
engine) a gossip delay.  Events are keyed by *logical step*: an event fires
the first time any node completes ``at_step`` steps, which is deterministic
given the seeded event loop.

Event semantics (executed by :mod:`repro_torch.sim.runner`):

* :class:`FailStop`   — nodes stop stepping; the controller consults
  ``launch.elastic.plan_recovery`` and either *reroutes* (same node count,
  ``Topology.exclude`` re-weights the survivors) or *rescales*
  (consensus-collapse to a smaller power-of-two cluster).
* :class:`Rejoin`     — a previously failed node comes back (reroute mode
  only): it receives the consensus average of the alive replicas, zero
  momentum, and the max alive step counter.
* :class:`Slowdown`   — multiply the nodes' step durations by ``factor``
  from this point on (factor < 1 models a speed-up/repair).
* :class:`LinkDegrade`— add ``delay`` simulated time to the listed edges in
  both directions; receivers see correspondingly staler snapshots.

The registry entries are factories ``(n, n_steps) -> Scenario`` so event
steps and node sets scale with the cluster being simulated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .clock import ConstantDuration, LognormalDuration, StepDuration

__all__ = [
    "FailStop",
    "Rejoin",
    "Slowdown",
    "LinkDegrade",
    "Scenario",
    "SCENARIOS",
    "get_scenario",
]


@dataclasses.dataclass(frozen=True)
class FailStop:
    at_step: int
    nodes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Rejoin:
    at_step: int
    nodes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Slowdown:
    at_step: int
    nodes: tuple[int, ...]
    factor: float


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    at_step: int
    edges: tuple[tuple[int, int], ...]
    delay: float


Event = FailStop | Rejoin | Slowdown | LinkDegrade


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named virtual-cluster condition.

    ``engine`` selects the execution model:

    * ``"event"``   — the discrete-event loop: per-node clocks, stale
      snapshots, failures (:func:`repro_torch.sim.runner.simulate`).
    * ``"delayed"`` — synchronous rounds with bounded-staleness gossip
      (:func:`repro_torch.sim.delayed_gossip.run_delayed`); only
      ``gossip_delay`` applies.
    """

    name: str
    engine: str = "event"  # "event" | "delayed"
    speeds: Callable[[int], Sequence[StepDuration]] | None = None
    events: tuple[Event, ...] = ()
    gossip_delay: int = 0  # per-edge staleness for the delayed engine
    max_staleness: int = 16  # SSP bound: a node may lead a neighbor by <= this
    description: str = ""

    def __post_init__(self):
        assert self.engine in ("event", "delayed"), self.engine
        assert self.gossip_delay >= 0 and self.max_staleness >= 1

    def duration_models(self, n: int) -> list[StepDuration]:
        if self.speeds is None:
            return [ConstantDuration(1.0)] * n
        models = list(self.speeds(n))
        assert len(models) == n
        return models


# ---------------------------------------------------------------------------
# Registry — the reference's scenarios (its benchmarks/sim_scenarios.py)
# ---------------------------------------------------------------------------


def _homogeneous(n: int, n_steps: int) -> Scenario:
    return Scenario(
        name="homogeneous",
        description="constant equal speeds, no events — must match run_stacked "
        "bit-exactly (the oracle remains the oracle)",
    )


def _straggler_speeds(n: int):
    return [
        LognormalDuration(mean=4.0 if i == 0 else 1.0, sigma=0.1) for i in range(n)
    ]


def _straggler_1slow(n: int, n_steps: int) -> Scenario:
    return Scenario(
        name="straggler_1slow",
        speeds=_straggler_speeds,
        max_staleness=1,
        description="node 0 is 4x slower (lognormal jitter) under "
        "version-synchronous gossip (BSP): the paper's deployment model, "
        "where the straggler costs stall time but not quality",
    )


def _straggler_1slow_async(n: int, n_steps: int) -> Scenario:
    return Scenario(
        name="straggler_1slow_async",
        speeds=_straggler_speeds,
        max_staleness=8,
        description="same straggler under bounded-staleness asynchrony "
        "(SSP bound 8): neighbors mix the slow node's stale iterates — "
        "exposes momentum-staleness feedback (DecentLaM diverges here)",
    )


def _failstop_quarter(n: int, n_steps: int) -> Scenario:
    quarter = tuple(range(max(1, n // 4)))
    return Scenario(
        name="failstop_quarter",
        events=(FailStop(at_step=max(1, n_steps // 3), nodes=quarter),),
        description="a quarter of the cluster fail-stops a third of the way "
        "in; plan_recovery decides reroute vs consensus-collapse rescale",
    )


def _churn(n: int, n_steps: int) -> Scenario:
    victim = 1 % n
    victim2 = 2 % n
    q1, q2 = max(1, n_steps // 4), max(2, n_steps // 2)
    return Scenario(
        name="churn",
        speeds=lambda n: [LognormalDuration(1.0, 0.1) for _ in range(n)],
        events=(
            FailStop(at_step=q1, nodes=(victim,)),
            Rejoin(at_step=q2, nodes=(victim,)),
            Slowdown(at_step=q2, nodes=(victim2,), factor=2.0),
        ),
        max_staleness=1,
        description="a node leaves and rejoins (reroute + consensus re-entry) "
        "while another degrades to half speed; version-synchronous gossip",
    )


def _straggler_tail(n: int, n_steps: int) -> Scenario:
    # constant two-tier speeds (not lognormal): completions tie exactly, so
    # the vectorized engine keeps whole-fleet batches — this is the
    # heterogeneous scenario that stays tractable at n=1024, where per-node
    # jitter would collapse every batch to size 1
    k = max(1, n // 64)
    slow = tuple(range(0, n, max(1, n // k)))[:k]

    def speeds(m: int):
        return [ConstantDuration(3.0 if i in slow else 1.0) for i in range(m)]

    return Scenario(
        name="straggler_tail",
        speeds=speeds,
        max_staleness=8,
        description="a ~1.5% tail of nodes runs 3x slower at constant speed "
        "under SSP-8 asynchrony: the fleet-scale straggler regime (tied "
        "completion times keep the node-batched engine fast at n=1024)",
    )


def _stale_gossip(k: int):
    def make(n: int, n_steps: int) -> Scenario:
        return Scenario(
            name=f"stale_gossip_k{k}",
            engine="delayed",
            gossip_delay=k,
            description=f"synchronous rounds, every edge mixes iterates {k} "
            "steps old (AD-PSGD-style bounded staleness)",
        )

    return make


SCENARIOS: dict[str, Callable[[int, int], Scenario]] = {
    "homogeneous": _homogeneous,
    "straggler_1slow": _straggler_1slow,
    "straggler_1slow_async": _straggler_1slow_async,
    "failstop_quarter": _failstop_quarter,
    "churn": _churn,
    "straggler_tail": _straggler_tail,
    "stale_gossip_k1": _stale_gossip(1),
    "stale_gossip_k2": _stale_gossip(2),
    "stale_gossip_k4": _stale_gossip(4),
}


def get_scenario(name: str, n: int, n_steps: int) -> Scenario:
    try:
        factory = SCENARIOS[name]
    except KeyError as e:
        raise ValueError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from e
    return factory(n, n_steps)
