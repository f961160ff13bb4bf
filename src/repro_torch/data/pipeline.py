"""Host-side input pipeline: background prefetch + host->device copy.

A producer thread keeps ``depth`` batches in flight.  On a CUDA device each
batch goes through pinned host memory and a non-blocking copy on the
current stream, so the copy itself queues behind the kernels already
issued; what overlaps the previous step is the host work (building and
pinning the batch).  An exception in the producer is re-raised in the
consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device"]


def _to_device(host: dict[str, np.ndarray], device: torch.device) -> dict:
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(
    batch_fn: Callable[[int], dict[str, np.ndarray]],
    device: torch.device,
    n_steps: int,
    *,
    depth: int = 2,
) -> Iterator[dict[str, torch.Tensor]]:
    """Yields device-placed batches for steps [0, n_steps)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    failure: list[BaseException] = []

    def produce():
        try:
            for s in range(n_steps):
                q.put(_to_device(batch_fn(s), device))
        except BaseException as e:  # handed to the consumer, which re-raises
            failure.append(e)
        finally:
            q.put(stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item
