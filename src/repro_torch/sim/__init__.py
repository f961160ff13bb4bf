"""Discrete-event cluster simulator: heterogeneous nodes, stale gossip,
failure scenarios (the port of ``repro.sim``'s engines).

Any algorithm from :mod:`repro_torch.core.optimizers` runs under a virtual
cluster with per-node clocks, bounded-staleness gossip and
fail-stop/rejoin/slowdown/link-degrade schedules, its iterates on the
device of the initial parameters.  The reference's wall-clock projection
(``repro.sim.wallclock``, which prices a step from XLA's cost analysis) is
not ported yet.
"""

from .clock import (
    ConstantDuration,
    EventQueue,
    LognormalDuration,
    PeriodicStragglerDuration,
    node_rngs,
)
from .delayed_gossip import delay_matrix, run_delayed
from .events import (
    SCENARIOS,
    FailStop,
    LinkDegrade,
    Rejoin,
    Scenario,
    Slowdown,
    get_scenario,
)
from .metrics import SimResult, effective_batch_fraction, is_diverged
from .runner import SimSpec, simulate

__all__ = [
    "ConstantDuration",
    "EventQueue",
    "FailStop",
    "LinkDegrade",
    "LognormalDuration",
    "PeriodicStragglerDuration",
    "Rejoin",
    "SCENARIOS",
    "Scenario",
    "SimResult",
    "SimSpec",
    "Slowdown",
    "delay_matrix",
    "effective_batch_fraction",
    "get_scenario",
    "is_diverged",
    "node_rngs",
    "run_delayed",
    "simulate",
]
