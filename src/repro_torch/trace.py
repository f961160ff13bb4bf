"""The port's profiler spans, entered only while a profiler records.

:func:`span` is ``torch.profiler.record_function(name)`` while a profiler
records (``torch.autograd._profiler_enabled()``) and one shared null context
otherwise: an unrecorded ``record_function`` still enters the dispatcher
(~13 us a span on a CPU host), the check costs under a microsecond.  There
is no other switch.  A recorded span is a CPU event in the profiler's
(Kineto) trace, on the clock of the device operations it launches.

The names, by module:

* ``train/step.py``: the phases of a train step, which tile it (every
  operation the step launches, on any thread, is launched inside exactly
  one of them; no span holds the whole step): ``train.prepare`` (the
  learning rate, the gradient planes), ``train.forward`` and
  ``train.backward`` (per node and microbatch; autograd's device thread
  launches the backward's kernels while the step's thread waits inside the
  span), ``train.guard`` (the finite guard), ``train.update`` (the update
  tail), ``train.metrics`` (the per-node metrics and their reduction);
* ``core/update_spec.py``: ``gossip.apply``, one gossip round of the tail;
* ``core/gossip.py``: ``gossip.codec``, one node's encode and decode of a
  compressed payload, and ``gossip.mix``, the ``W @`` sums of a stacked
  round;
* ``sync.<why>`` around each device-to-host read of the step and nothing
  else, so that one span is one host sync and its length the host's wait:
  ``sync.finite_guard`` (the guard's ``nonzero``), ``sync.metrics`` (a
  metric read off the device);
* the models' ``moe_router``, ``moe_dispatch``, ``moe_experts``,
  ``moe_combine``, ``moe_shared`` (``models/moe.py``), ``mla`` with
  ``mla_latent`` and ``mla_core`` inside it (``models/attention.py``),
  ``ssm_forward`` (``models/ssm.py``) and ``slstm_recurrence``
  (``models/xlstm.py``).

The dotted prefixes keep a span's name apart from every kernel's.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler span ``name`` while a profiler records, else a null context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
