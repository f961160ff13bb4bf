"""Stacked gossip with per-edge delay buffers (bounded staleness): the port
of ``repro.sim.delayed_gossip``.

The implementation lives in
:class:`repro_torch.core.gossip.DelayedStackedChannel`; this module keeps
:func:`run_delayed` — the delayed stacked harness the simulator's
``stale_gossip_k*`` scenarios and the bias experiments drive.

``x_i <- w_ii x_i(t) + sum_j w_ij x_j(t - d_ij)``: every edge ``(i, j)``
carries a fixed integer delay and the receiver mixes the sender's payload
from ``d_ij`` gossip rounds ago.  At uniform delay 0 the channel runs the
exact :class:`~repro_torch.core.gossip.StackedChannel` code path, so the
zero-staleness simulator equals the lockstep oracle bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.gossip import DelayedStackedChannel, delay_matrix
from ..core.optimizers import Optimizer
from ..core.reference import run_stacked
from ..core.topology import Topology

Tree = Any

__all__ = [
    "delay_matrix",
    "run_delayed",
]


def run_delayed(
    opt: Optimizer,
    topology: Topology,
    params0: Tree,
    grad_fn: Callable[[Tree, int], Tree],
    *,
    delay,
    lr,
    n_steps: int,
    record_every: int = 0,
    metric_fn: Callable[[Tree], torch.Tensor] | None = None,
    compression: str | None = None,
):
    """:func:`repro_torch.core.reference.run_stacked` with a delayed channel.

    At uniform delay 0 the computation is identical to ``run_stacked``, so
    results are bit-exact.  The exact-mean closure (PmSGD / SlowMo outer
    sync) is *not* delayed: staleness models gossip links, not the
    all-reduce fabric.  Staleness-aware algorithms (``decentlam-sa``) read
    their per-node version gaps straight from the channel state.
    """
    channel = DelayedStackedChannel(
        topology, delay, calls_per_step=opt.gossips_per_step, compression=compression,
    )
    return run_stacked(opt, topology, params0, grad_fn, lr=lr, n_steps=n_steps,
                       record_every=record_every, metric_fn=metric_fn, channel=channel)
