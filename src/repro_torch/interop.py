"""Carry state across: the JAX package's trees <-> the port's tensors.

Parameter, optimizer-state, channel-state and serve-cache trees have the
same nested dict paths and the same leaf shapes in both packages (``repro``
stacks the node axis and the layer axis where the port does), so conversion
is leaf for leaf; integer leaves (a cache's int32 ``pos``) keep their dtype
both ways.  Trees come in as numpy arrays (``jax.device_get`` of a JAX tree
gives them); nothing here imports jax.  bfloat16 leaves travel as their
bits.  The two packages' RNGs never agree, so tests move a JAX-built
initial state into the port with :func:`from_numpy` and compare results
with :func:`to_numpy`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .utils import tree_map

Tree = Any

__all__ = ["from_numpy", "to_numpy"]


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy(tree: Tree, device: str | torch.device = "cpu") -> Tree:
    """A nested dict of numpy-convertible leaves -> the same tree of tensors."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def to_numpy(tree: Tree) -> Tree:
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return tree_map(_leaf_to_numpy, tree)
