"""Tree helpers and device selection shared by the port.

Parameter, gradient and optimizer-state trees are nested ``dict``s of
tensors whose paths match the JAX package's pytrees one for one.  JAX
flattens a dict in sorted-key order; :func:`tree_leaves` does the same, so
"leaf ``i``" means the same tensor in both packages.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Tree = Any

__all__ = [
    "tree_leaves",
    "tree_paths",
    "tree_map",
    "tree_unflatten",
    "shard",
    "unshard",
    "resolve_device",
]


def _is_node(t) -> bool:
    return isinstance(t, dict)


def tree_paths(tree: Tree, prefix: str = "") -> list[str]:
    """'/'-joined key paths of the leaves, in :func:`tree_leaves` order."""
    if not _is_node(tree):
        return [prefix]
    out: list[str] = []
    for k in sorted(tree):
        out += tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree: Tree) -> list:
    if not _is_node(tree):
        return [tree]
    out: list = []
    for k in sorted(tree):
        out += tree_leaves(tree[k])
    return out


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)

    def build(t):
        if not _is_node(t):
            return next(it)
        return {k: build(t[k]) for k in sorted(t)}

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if not _is_node(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def _cut(x, axis: int, tp: int, index: int):
    n = x.shape[axis]
    if n % tp:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not divisible by tp={tp}")
    size = n // tp
    return x[(slice(None),) * axis + (slice(index * size, (index + 1) * size),)]


def shard(tree: Tree, axes: Tree, tp: int, index: int, *, leading: int = 0) -> Tree:
    """Model rank ``index``'s shard of the global ``tree`` (numpy arrays or
    tensors; views): each leaf whose entry in ``axes`` is an int is cut
    along that axis (counted after ``leading`` axes), the others pass whole."""
    return tree_map(lambda x, ax: x if ax is None else _cut(x, ax + leading, tp, index),
                    tree, axes)


def unshard(shards: list, axes: Tree, *, leading: int = 0) -> Tree:
    """The global tree of the model ranks' ``shards`` (by index): sharded
    leaves concatenated along their axis, replicated ones rank 0's."""

    def join(ax, *xs):
        if ax is None:
            return xs[0]
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs, axis=ax + leading)
        return torch.cat(xs, dim=ax + leading)

    return tree_map(join, axes, *shards)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Asking for CUDA on a host without it raises — there is no silent
    CPU fallback.  Also pins float32 matmuls and convolutions to full
    precision (no TF32), as the JAX reference computes in full f32, and
    cuDNN to deterministic algorithms without autotuning (some of its
    weight-gradient algorithms accumulate with atomics), so that a run
    equals its repeat bit for bit."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; "
            "pass device='cpu' to run on the host"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev
