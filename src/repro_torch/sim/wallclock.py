"""Project simulated steps onto wall-clock time and throughput (the port of
``repro.sim.wallclock``).

The simulator's clock runs in *nominal steps*; this module prices one
nominal step in seconds on the hardware model of
:mod:`repro_torch.launch.roofline` (one H100) so every scenario reports
speed next to quality:

* compute + HBM terms come from the cost model
  (:func:`repro_torch.launch.costmodel.analyze`) over the *actual* stacked
  one-step program (divided by ``n`` — the stacked layout computes all
  replicas in one program, a real node runs one row);
* the gossip term prices per-node link egress with
  :func:`repro_torch.core.gossip.gossip_bytes_per_step` (edge-class
  ppermute model, optional compression).

The three terms combine as ``max`` (roofline: compute, memory and the
gossip fabric overlap) and scale the simulated duration:

    wallclock_s = sim_time * step_time_s
    throughput  = total completed steps / wallclock_s

The roofline terms are *work* prices; a real step also pays a
work-independent floor (kernel launches, collective setup, host dispatch
latency), so the combined price is clamped below by ``min_step_s`` (default
1 ms).  :func:`calibrate_from_dryrun` reads a measured step time (the
``--measure-json`` file ``repro_torch.launch.train`` writes) to replace the
roofline price outright.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable

import torch

from ..core.gossip import StackedChannel, gossip_bytes_per_step, make_stacked_mean
from ..core.optimizers import Optimizer
from ..core.topology import Topology
from ..launch.costmodel import analyze
from ..launch.roofline import HW, roofline_terms
from ..utils import tree_leaves
from .metrics import SimResult

Tree = Any

__all__ = [
    "MIN_STEP_S",
    "payload_bytes",
    "step_costs",
    "step_time_seconds",
    "calibrate_from_dryrun",
    "project_wallclock",
]

# Work-independent per-step latency floor (kernel launch + collective setup
# + host dispatch).  ~1 ms is optimistic for a real accelerator step; it
# exists so roofline prices of toy problems stay physically plausible.
MIN_STEP_S = 1e-3


def payload_bytes(params: Tree) -> float:
    """Gossip payload size: one f32 copy of every parameter row."""
    per_node = sum(float(math.prod(x.shape[1:])) for x in tree_leaves(params))
    return 4.0 * per_node


def step_costs(
    opt: Optimizer,
    topology: Topology,
    params0: Tree,
    grad_fn: Callable,
    *,
    lr: float = 1e-3,
) -> dict[str, float]:
    """Per-node FLOPs / HBM bytes of one optimizer step, from the cost model
    run over the same stacked step the simulator executes."""
    mean = make_stacked_mean(topology.n)
    channel = StackedChannel(topology)
    state = opt.init(params0)
    dev = tree_leaves(params0)[0].device

    def one(params, state):
        grads = grad_fn(params, 0)
        with torch.no_grad():
            params, state, _ = opt.step(
                params, grads, state,
                lr=torch.tensor(lr, dtype=torch.float32, device=dev), step_idx=0,
                gossip=channel, mean=mean,
            )
        return params, state

    costs = analyze(one, (params0, state))
    n = topology.n
    return {
        "flops_per_node": costs.flops / n,
        "hbm_bytes_per_node": costs.materialized_bytes / n,
    }


def step_time_seconds(
    topology: Topology,
    payload: float,
    *,
    flops_per_node: float = 0.0,
    hbm_bytes_per_node: float = 0.0,
    gossips_per_step: int = 1,
    compression: str | None = None,
    hw: HW = HW(),
    min_step_s: float = MIN_STEP_S,
) -> dict[str, float]:
    """Roofline price of one nominal step (seconds) + its terms.

    The combined price is ``max(compute, memory, collective, min_step_s)``:
    the roofline terms price the *work*, ``min_step_s`` the
    work-independent launch/dispatch floor — a 30-dim toy must not project
    a nanosecond step.  ``dominant`` reports ``"latency"`` when the floor
    binds.  Pass ``min_step_s=0`` for the raw roofline bound.
    """
    comm = gossip_bytes_per_step(
        topology, payload, impl="ppermute", compression=compression
    )
    terms = roofline_terms(
        flops_per_device=flops_per_node,
        bytes_per_device=hbm_bytes_per_node,
        collective_egress=comm["egress_bytes"] * max(1, gossips_per_step),
        hw=hw,
    )
    roofline_s = terms["step_time_lower_bound_s"]
    return {
        "step_time_s": max(roofline_s, min_step_s),
        "roofline_s": roofline_s,
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": terms["dominant"] if roofline_s >= min_step_s else "latency",
        "gossip_egress_bytes": comm["egress_bytes"] * max(1, gossips_per_step),
    }


def calibrate_from_dryrun(measured) -> float:
    """Per-step seconds measured by a real ``launch.train`` run.

    Accepts, in order of convenience:

    * a float — seconds per step, straight from a stopwatch;
    * a dict — the ``--measure-json`` artifact ``launch.train`` writes
      (``{"measured_step_s": ...}``);
    * a path to that JSON file.

    Returns the validated ``measured_step_s`` to pass to
    :func:`project_wallclock` so scenario throughput projections carry
    *real* units for the measured config instead of roofline estimates —
    the measured price subsumes the launch/dispatch floor, so
    ``min_step_s`` no longer applies when it is used.
    """
    if isinstance(measured, str):
        with open(measured) as f:
            measured = json.load(f)
    if isinstance(measured, dict):
        if "measured_step_s" not in measured:
            raise ValueError(
                "calibration dict must carry 'measured_step_s' (the "
                "launch.train --measure-json artifact)"
            )
        measured = measured["measured_step_s"]
    measured = float(measured)
    if not (measured > 0.0 and math.isfinite(measured)):
        raise ValueError(f"measured_step_s must be finite and positive: {measured}")
    return measured


def project_wallclock(
    result: SimResult,
    topology: Topology,
    *,
    opt: Optimizer | None = None,
    grad_fn: Callable | None = None,
    compression: str | None = None,
    hw: HW = HW(),
    min_step_s: float = MIN_STEP_S,
    measured_step_s: float | None = None,
) -> dict[str, float]:
    """Quality-AND-speed report for a finished scenario run.

    When ``opt``/``grad_fn`` are given, compute/memory terms come from the
    cost model; otherwise the step is priced on gossip bandwidth alone
    (payload from the result's parameter shapes).  ``min_step_s`` floors
    the per-step price (see :func:`step_time_seconds`).

    ``measured_step_s`` (see :func:`calibrate_from_dryrun`) replaces the
    roofline price outright: the nominal step is pinned to the measured
    wall-clock of a real ``launch.train`` run, the roofline terms stay in
    the report for reference, and ``dominant`` becomes ``"measured"``.
    """
    payload = payload_bytes(result.params)
    kw: dict[str, float] = {}
    gossips = 1
    if opt is not None:
        gossips = opt.gossips_per_step
        if grad_fn is not None:
            kw = step_costs(opt, topology, result.params, grad_fn)
    price = step_time_seconds(
        topology, payload,
        gossips_per_step=gossips, compression=compression, hw=hw,
        min_step_s=min_step_s, **kw,
    )
    if measured_step_s is not None:
        price = {
            **price,
            "step_time_s": float(measured_step_s),
            "dominant": "measured",
            "measured_step_s": float(measured_step_s),
        }
    total_steps = int(result.steps[result.alive].sum())
    wallclock_s = result.sim_time * price["step_time_s"]
    return {
        **price,
        "sim_time": result.sim_time,
        "wallclock_s": wallclock_s,
        "steps_per_s": (total_steps / wallclock_s) if wallclock_s > 0 else 0.0,
        "stall_s": float(result.stall_time.sum()) * price["step_time_s"],
        # fleet cost: device-hours burned by the run (wallclock x cluster
        # size) — the number a capacity plan actually budgets against
        "device_hours": wallclock_s * result.n_nodes / 3600.0,
    }
