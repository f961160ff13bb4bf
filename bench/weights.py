"""Seeded parameters of one node, made by the benchmark on the device.

One standard normal draw of every parameter at once from a
``torch.Generator`` on the device, seeded with ``--seed``, cut into the
leaves of the family's :func:`param_specs` (in their order) and scaled by
each leaf's standard deviation (zero: a zero init).  The same seed on the
same device gives the same numbers, so the reference makes ``x0`` again
after the window instead of keeping a copy beside the program's state.
"""

from __future__ import annotations

import math

import torch

Specs = list[tuple[str, tuple, float]]


def family(model: dict):
    """The reference module of a configuration's family (``bench/reference``)."""
    from . import reference

    return reference.load("family", model["run"]["family"])


def make(specs: Specs, seed: int, device) -> dict[str, torch.Tensor]:
    """``{path: tensor}`` in float32: views of one flat draw."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape, std in specs:
        size = math.prod(shape)
        out[path] = flat[at:at + size].view(shape).mul_(std)
        at += size
    return out
