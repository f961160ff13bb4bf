"""Serving (the port of ``repro.serve``, without the weight publisher).

* :mod:`repro_torch.serve.scheduler` — the continuous-batching request
  scheduler over the serve step builders (:class:`ServeEngine`);
* :mod:`repro_torch.serve.sampling` — greedy sampling and the decode loop.

The publisher (``repro.serve.publisher``) comes with the port of the
parameter planes it is built on; until then the engine takes its weights
as a parameter tree.
"""

from .sampling import greedy_decode_loop, greedy_token
from .scheduler import Completion, Request, ServeEngine

__all__ = ["Completion", "Request", "ServeEngine", "greedy_decode_loop", "greedy_token"]
