"""Discrete-event cluster simulator: heterogeneous nodes, stale gossip,
failure scenarios (the port of ``repro.sim``'s engines).

Any algorithm from :mod:`repro_torch.core.optimizers` runs under a virtual
cluster with per-node clocks, bounded-staleness gossip and
fail-stop/rejoin/slowdown/link-degrade schedules, its iterates on the
device of the initial parameters.  :mod:`.wallclock` projects a run's
nominal steps onto wall-clock time: a step priced on the H100's roofline
from the port's cost model (:mod:`repro_torch.launch.costmodel`), or
pinned to a measured step (``calibrate_from_dryrun``).
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
from .wallclock import (
    MIN_STEP_S,
    calibrate_from_dryrun,
    payload_bytes,
    project_wallclock,
    step_costs,
    step_time_seconds,
)

__all__ = [
    "MIN_STEP_S",
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
    "calibrate_from_dryrun",
    "effective_batch_fraction",
    "get_scenario",
    "is_diverged",
    "node_rngs",
    "payload_bytes",
    "project_wallclock",
    "run_delayed",
    "simulate",
    "step_costs",
    "step_time_seconds",
]
