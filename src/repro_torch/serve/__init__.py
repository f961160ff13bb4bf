"""Serving (the port of ``repro.serve`` at tensor-parallel degree 1).

* :mod:`repro_torch.serve.scheduler` — the continuous-batching request
  scheduler over the serve step builders (:class:`ServeEngine`), serving a
  parameter tree or a publisher's newest snapshot;
* :mod:`repro_torch.serve.publisher` — the consensus-gated, double-buffered
  plane-snapshot handoff from the training fleet (:class:`WeightPublisher`);
* :mod:`repro_torch.serve.sampling` — greedy sampling and the decode loop.
"""

from .publisher import Snapshot, WeightPublisher
from .sampling import greedy_decode_loop, greedy_token
from .scheduler import Completion, Request, ServeEngine

__all__ = ["Completion", "Request", "ServeEngine", "Snapshot", "WeightPublisher",
           "greedy_decode_loop", "greedy_token"]
