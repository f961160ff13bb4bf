"""Carry state across: the JAX package's trees <-> the port's tensors.

Parameter, optimizer-state, channel-state and serve-cache trees have the
same nested dict paths and the same leaf shapes in both packages (``repro``
stacks the node axis and the layer axis where the port does), so conversion
is leaf for leaf; integer leaves (a cache's int32 ``pos``) keep their dtype
both ways, and an empty subtree (olmo's parameter-free norms, ``{}``) stays
an empty subtree.  Trees come in as numpy arrays (``jax.device_get`` of a JAX tree
gives them); nothing here imports jax.  bfloat16 leaves travel as their
bits.  The two packages' RNGs never agree, so tests move a JAX-built
initial state into the port with :func:`from_numpy` and compare results
with :func:`to_numpy`.

Flat parameter planes convert the same way: a reference plane dict
(``{bucket: (..., rows, LANES)}``, keyed by dtype name) and the port's have
the same keys, shapes and elements; :func:`planes_from_numpy` and
:func:`planes_to_numpy` also check the buckets against a
:class:`~repro_torch.core.planes.PlaneLayout`.

Tensor parallelism: :func:`shard` cuts a global tree (``repro``'s
``init_params(key, cfg, tp)`` as numpy, or the port's) into one rank's
shard along a tree of shard axes
(:func:`~repro_torch.models.transformer.param_shard_axes`), and
:func:`unshard` joins the ranks' shards back into the global tree (the
one cut and join of the port: :class:`~repro_torch.core.planes.PlaneLayout`
and the grid's checkpoint gather use them too).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.planes import LANES
from .utils import shard, tree_map, unshard

Tree = Any

__all__ = ["from_numpy", "to_numpy", "planes_from_numpy", "planes_to_numpy", "shard",
           "unshard"]


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


def _check_planes(planes: dict, layout, dtype_name) -> None:
    if layout is None:
        return
    if sorted(planes) != list(layout.buckets):
        raise ValueError(f"plane buckets {sorted(planes)}, the layout's {list(layout.buckets)}")
    for key, p in planes.items():
        if tuple(p.shape[-2:]) != (layout.rows[key], LANES) or dtype_name(p) != key:
            raise ValueError(f"bucket {key!r}: {tuple(p.shape)} {dtype_name(p)}, the layout "
                             f"wants (..., {layout.rows[key]}, {LANES}) {key}")


def planes_from_numpy(planes: dict, layout=None, device: str | torch.device = "cpu") -> dict:
    """A reference plane dict (numpy, ``jax.device_get`` of ``repro``'s
    ``PlaneLayout.pack``) -> the port's plane tensors, element for element;
    with ``layout``, the buckets are checked against it first."""
    _check_planes(planes, layout, lambda p: np.asarray(p).dtype.name)
    return from_numpy(planes, device)


def planes_to_numpy(planes: dict, layout=None) -> dict:
    """The port's plane tensors -> a plane dict of numpy arrays, as the
    reference's planes come out of ``jax.device_get``."""
    _check_planes(planes, layout, lambda p: str(p.dtype).removeprefix("torch."))
    return to_numpy(planes)
