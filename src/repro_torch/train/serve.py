"""Serve step builders (prefill / decode), on one device or on a
``(nodes x tp)`` grid of ranks (the port of ``repro.train.serve``).

Serving uses the consensus model: one parameter tree, replicated over the
nodes and sharded over each node's model group in the serving layout
(:func:`serve_specs`: q heads, ``wo``, the MLP, the experts, the mLSTM
value columns, the SSM channels and the vocab sharded, k and v
replicated; the encoder-decoder serves at tp = 1 only,
:func:`~repro_torch.models.transformer.check_tp`).  A request batch splits over the nodes when the node count
divides it, and otherwise every node takes the whole batch (the
reference's ``_batch_axes`` fallback, hit by a single request on several
nodes).  The KV cache is sharded by sequence over the model group and
decode merges the ranks' partial attention split-K
(:mod:`repro_torch.models.attention`).  On a grid a step returns this
rank's block of the reference's jit-level outputs: the logits of its node's
rows as its vocab shard, and its cache shard; :func:`gather_logits` joins
them.  Both steps run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..models.layers import TPContext
from ..utils import tree_map

Tree = Any

__all__ = ["ServeConfig", "build_prefill_step", "build_decode_step", "serve_specs",
           "batch_splits", "abstract_cache", "gather_logits"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    runtime: T.RuntimeConfig = T.RuntimeConfig()
    target_len: int = 0  # cache capacity target (0 -> prefill length)


def batch_splits(global_batch: int, n_nodes: int) -> bool:
    """Whether the batch splits over the nodes (``_batch_axes``): the node
    count divides it and it has a row per node at least."""
    return global_batch % n_nodes == 0 and global_batch >= n_nodes


def serve_specs(cfg: ModelConfig, grid=None, *, global_batch: int):
    """``(param shard axes, cache shard axes, batch splits)`` on ``grid``
    (None: one device): the serving layout of the parameters
    (:func:`~repro_torch.models.transformer.param_shard_axes` with
    ``serve=True``), the cache's shard axes, and whether the batch splits
    over the nodes."""
    tp = 1 if grid is None else grid.tp
    nodes = 1 if grid is None else grid.nodes
    return (T.param_shard_axes(cfg, tp, serve=True), T.cache_shard_axes(cfg, tp),
            batch_splits(global_batch, nodes))


def _setup(cfg: ModelConfig, grid, global_batch: int | None, timing: bool):
    """The step's TP context (None at tp = 1) and its rows of the batch."""
    if grid is None:
        return None, None
    T.check_tp(cfg, grid.tp, serve=True)
    tp = TPContext(grid.model, timing=timing) if grid.tp > 1 else None
    rows = None
    if global_batch is not None and batch_splits(global_batch, grid.nodes):
        b = global_batch // grid.nodes
        rows = slice(grid.node.rank * b, (grid.node.rank + 1) * b)
    return tp, rows


def build_prefill_step(cfg: ModelConfig, scfg: ServeConfig, grid=None, *,
                       global_batch: int | None = None, timing: bool = False) -> Callable:
    """``(params, batch) -> (last-token logits, cache)``.  On ``grid`` the
    params are the rank's serving shard and ``batch`` the global batch of
    ``global_batch`` rows; the logits are the rank's rows by its vocab
    shard.  The step's ``tp`` attribute is its
    :class:`~repro_torch.models.layers.TPContext` (None at tp = 1), whose
    counters hold the model group's collectives (``timing``: see there)."""
    tp, rows = _setup(cfg, grid, global_batch, timing)

    def step(params: Tree, batch: dict):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        with torch.inference_mode():
            return T.prefill(params, batch, cfg, scfg.runtime,
                             target_len=scfg.target_len or batch["tokens"].shape[1], tp=tp)

    step.tp = tp
    return step


def build_decode_step(cfg: ModelConfig, scfg: ServeConfig, grid=None, *, target_len: int,
                      per_slot_t: bool = False, global_batch: int | None = None,
                      timing: bool = False) -> Callable:
    """``(params, tokens (B, 1), cache, t) -> (logits, cache)``; the cache is
    updated in place.  With ``per_slot_t`` the position argument is a
    ``(B,)`` vector (the continuous-batching scheduler runs slots whose
    request timelines are independent) instead of a shared scalar.  On
    ``grid`` as :func:`build_prefill_step`: ``tokens`` and a per-slot ``t``
    are global and the rank takes its node's rows."""
    tp, rows = _setup(cfg, grid, global_batch, timing)

    def step(params: Tree, tokens: torch.Tensor, cache: Tree, t):
        t = torch.as_tensor(t)
        want = (tokens.shape[0],) if per_slot_t else ()
        if tuple(t.shape) != want:
            raise ValueError(f"t has shape {tuple(t.shape)}, want {want} "
                             f"(per_slot_t={per_slot_t})")
        if rows is not None:
            tokens = tokens[rows]
            t = t[rows] if per_slot_t else t
        with torch.inference_mode():
            return T.decode_step(params, tokens, cache, t, cfg, scfg.runtime,
                                 target_len=target_len, tp=tp)

    step.tp = tp
    return step


def gather_logits(logits: torch.Tensor, grid, *, global_batch: int) -> torch.Tensor:
    """The global ``(global_batch, Vp)`` logits from every rank's block:
    the vocab shards over the model group, then the nodes' rows when the
    batch splits.  Every rank gets the same tensor."""
    if grid is None:
        return logits
    with torch.inference_mode():
        if grid.tp > 1:
            logits = TPContext(grid.model).all_gather(logits, dim=-1)
        if grid.nodes > 1 and batch_splits(global_batch, grid.nodes):
            logits = TPContext(grid.node).all_gather(logits, dim=0)
    return logits


def abstract_cache(cfg: ModelConfig, global_batch: int, target_len: int, tp: int,
                   scfg: ServeConfig) -> Tree:
    """The cache's global shapes and dtypes as meta tensors (the dry-run
    stand-in): :func:`~repro_torch.models.transformer.init_cache`'s per-rank
    shapes with each sharded axis scaled back by ``tp``."""
    local = T.init_cache(cfg, global_batch, target_len, scfg.runtime, device="meta", tp=tp)

    def to_global(x, ax):
        shape = list(x.shape)
        if ax is not None:
            shape[ax] *= tp
        return torch.empty(shape, dtype=x.dtype, device="meta")

    return tree_map(to_global, local, T.cache_shard_axes(cfg, tp))
