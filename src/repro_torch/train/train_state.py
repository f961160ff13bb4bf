"""TrainState: stacked per-node parameters + optimizer + channel state.

Every parameter and optimizer leaf carries a leading *node* axis of size
``n_nodes`` — one model replica per decentralized node, all on one device.
The ``"channel"`` bucket is the gossip transport's state.

With a plane layout (:func:`model_plane_layout`, the flat-plane path) the
parameters *live* in stacked ``(n, rows, LANES)`` planes, held under
``"planes"``: ``"params"`` is a tree of views into them (each leaf its
segment's rows, contiguous per node), the optimizer buckets and the channel
state are plane dicts, and the update writes the planes in place.  This
keeps the reference's numbers (its step packs ``params`` and the gradient
anew every step, ``repro/train/step.py:402-404``) without that per-step
pack and unpack: two copies of 10.6 GB at qwen3-0.6b x 4 nodes in f32.

On resume (:mod:`repro_torch.train.checkpoint`), :func:`reconcile_plane_state`
converts the optimizer buckets between tree and plane form, so checkpoints
are interchangeable across ``--flat-planes``, and (re)builds the parameter
planes; :func:`ensure_channel_state` keeps the restored channel state where
its structure and shapes match the current channel's and re-initializes the
rest.  The stacked channels' state has their layout (ring slots
``(ring, n, ...)``, scalar telemetry; see :mod:`repro_torch.core.gossip`).

The distributed trainer (one process per node) holds on each rank the
state of one node, every leaf with a node axis of 1: rank ``i``'s initial
state is :func:`init_train_state` with ``n_nodes=1``, equal to node ``i``
of the stacked one.  :func:`gather_state` concatenates the ranks' states
along that axis on rank 0 — the global state a checkpoint holds, with the
distributed channels' state in ``repro``'s trainer layout (ring slots
``(n, ring, ...)``, a ``count`` and telemetry per node) — and
:func:`scatter_state` is its inverse.

Tensor parallelism: on a ``(nodes x tp)`` grid each rank holds its model
rank's shard of its node (:func:`init_train_state` with ``tp_index``, its
planes the local planes of :func:`model_plane_layout` at that tp).
:func:`gather_grid_state` joins the shards into the global state a
checkpoint holds, the reference's: global parameter trees and plane-form
optimizer buckets as stacked shard planes ``(n, tp * rows, LANES)``;
:func:`scatter_grid_state` cuts a global state back into each rank's part,
converting the optimizer buckets from the layout the checkpoint was
written with (the manifest's ``plane_tp``), so a checkpoint written at one
tp resumes at another wherever both pad the model alike.  The channel
state stays behind at tp > 1 (ring buffers of local payloads): a resume
re-initializes it.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core.gossip import GossipChannel
from ..core.optimizers import Optimizer
from ..core.planes import PlaneLayout
from ..models import transformer as T
from ..utils import shard, tree_leaves, tree_map, tree_paths, tree_unflatten, unshard

Tree = Any

__all__ = ["init_train_state", "model_plane_layout", "ensure_channel_state",
           "reconcile_plane_state", "global_tree_state", "gather_state", "scatter_state",
           "gather_grid_state", "scatter_grid_state"]


def model_plane_layout(cfg: ModelConfig, tp: int = 1) -> PlaneLayout:
    """The flat-plane layout of this model's per-node parameter tree (from
    meta tensors, no allocation); at ``tp > 1`` one model rank's local
    layout, sharded along :func:`~repro_torch.models.transformer.
    param_shard_axes`.  The step, the state initializer and the publisher
    must all derive it from the same template."""
    template = T.init_params(cfg, torch.Generator(), device="meta", tp=tp)
    if tp == 1:
        return PlaneLayout.build(template)
    return PlaneLayout.build(template, tp=tp, shardings=T.param_shard_axes(cfg, tp))


def init_train_state(
    cfg: ModelConfig,
    opt: Optimizer,
    n_nodes: int,
    *,
    device: torch.device,
    seed: int = 0,
    channel: GossipChannel | None = None,
    plane_layout: PlaneLayout | None = None,
    tp: int = 1,
    tp_index: int = 0,
) -> Tree:
    """One init, copied to every node (as ``repro``'s ``make_train_state_fn``
    broadcasts it).  The copies are real (``repeat``), not an ``expand``:
    the nodes diverge after step 0 and the fused engine updates them in
    place.  With ``plane_layout`` the state is in plane form (module
    docstring): ``opt.init`` and ``channel.init`` of the f32 planes give the
    reference's packed optimizer and channel state, since every initial
    bucket is zeros or a copy of the parameters and pads stay zero.  At
    ``tp > 1`` the state is model rank ``tp_index``'s shard of the global
    init (a sharded ``plane_layout`` must have the same tp)."""
    device = torch.device(device)
    if device.type == "meta":  # shapes and dtypes only (the dry run): no generator there
        params = T.init_params(cfg, torch.Generator(), device=device, tp=tp)
    else:
        params = T.init_params(cfg, torch.Generator(device=device).manual_seed(seed), tp=tp)
    if tp > 1:
        params = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                          shard(params, T.param_shard_axes(cfg, tp), tp, tp_index))
    if plane_layout is not None:
        one = plane_layout.pack(params)
        del params
        planes = {k: p.unsqueeze(0).repeat(n_nodes, 1, 1) for k, p in one.items()}
        del one
        template = {k: p.to(torch.float32) for k, p in planes.items()}
        return {
            "step": 0,
            "params": plane_layout.view_unpack(planes, leading=1),
            "planes": planes,
            "opt": opt.init(template),
            "channel": channel.init(template) if channel is not None else {},
        }
    stacked = tree_map(lambda x: x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.ndim), params)
    del params
    return {
        "step": 0,
        "params": stacked,
        "opt": opt.init(stacked),
        "channel": channel.init(stacked) if channel is not None else {},
    }


def _merge_channel(abstract: Tree, old: Tree, device) -> Tree:
    """Keep restored leaves whose shape and dtype match the abstract spec;
    for anything missing or reshaped, ``channel.init``'s value: zeros on the
    device for payload-shaped leaves (built on meta tensors here), the host
    leaf itself for host bookkeeping."""
    if isinstance(abstract, dict):
        if not isinstance(old, dict):
            old = {}
        return {k: _merge_channel(v, old.get(k), device) for k, v in abstract.items()}
    if isinstance(old, torch.Tensor):
        if old.shape == abstract.shape and old.dtype == abstract.dtype:
            return old
    if abstract.device.type != "meta":  # a host leaf of channel.init: its own value
        return abstract  # (a trust mask is all-true at init)
    return torch.zeros(abstract.shape, dtype=abstract.dtype, device=device)


def _restructured(template: Tree, tree: Tree) -> Tree | None:
    """``tree``'s leaves in ``template``'s structure when both have the same
    leaf paths — which restores the empty subtrees (olmo's parameter-free
    norms, ``{}``) that a checkpoint does not store; else None."""
    if not isinstance(tree, dict) or tree_paths(tree) != tree_paths(template):
        return None
    if tree_map(lambda _: 0, tree) == tree_map(lambda _: 0, template):
        return tree  # the same structure already: the tree itself
    return tree_unflatten(template, tree_leaves(tree))


def _as_template(template: Tree, tree: Tree) -> Tree:
    """:func:`_restructured`, or ``tree`` itself where the paths differ."""
    out = _restructured(template, tree)
    return tree if out is None else out


def _subtree_matches(abstract: Tree, old: Tree) -> bool:
    if _restructured(abstract, old) is None:
        return False
    return all(isinstance(o, torch.Tensor) and o.shape == a.shape and o.dtype == a.dtype
               for a, o in zip(tree_leaves(abstract), tree_leaves(old)))


def _channel_template(state: Tree, plane_layout: PlaneLayout | None) -> Tree:
    """Meta tensors shaped like the step's gossip payload: the stacked f32
    planes on the plane path, else the stacked parameter tree."""
    if plane_layout is not None:
        n = tree_leaves(state["params"])[0].shape[0]
        return {k: torch.empty((n,) + shape, dtype=torch.float32, device="meta")
                for k, (shape, _) in plane_layout.plane_shapes().items()}
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                    state["params"])


def ensure_channel_state(state: Tree, channel: GossipChannel | None,
                         plane_layout: PlaneLayout | None = None) -> Tree:
    """Reconcile a restored state's ``"channel"`` bucket with the current
    channel's structure (``repro.train.train_state.ensure_channel_state``).

    Matching sub-nodes survive — error-feedback residuals and delay rings
    resume bit for bit on a same-shape restart; anything missing (an older
    checkpoint, a newly enabled delay or compression, an elastic reshape, a
    resume across ``--flat-planes``) is zero-initialized on the parameters'
    device.  The expected structure comes from ``channel.init`` on meta
    tensors, so nothing is allocated for what is kept.  Delay ring slots
    resume whole or not at all: a restored ``count`` beside a re-initialized
    ``hist`` would skip the warmup rule and mix zero payloads at full weight.

    One conversion goes beyond the reference's: ``repro``'s trainer keeps
    its telemetry per node (``(n,)``, every entry equal), the stacked
    channels as scalars; a per-node telemetry vector restores as its node-0
    entry, so a resume from a ``repro`` checkpoint keeps the telemetry.  The
    chaos and resilient wrappers' state (their inner channel's under
    ``"in"``; the round and miss counters, the trust mask, the last good
    payload) and the sparse channels' ``rows`` resume by the same rules."""
    if channel is None:
        return {**state, "channel": {}}
    device = tree_leaves(state["params"])[0].device
    abstract = channel.init(_channel_template(state, plane_layout))
    old = state.get("channel", {})
    return {**state, "channel": _ensure(abstract, old if isinstance(old, dict) else {}, device)}


def _ensure(abstract: dict, old: dict, device) -> dict:
    """:func:`ensure_channel_state`'s merge of one channel's state: the
    resilience wrappers nest their inner channel's state under ``"in"``,
    which merges by the same rules."""
    merged: Tree = {}
    for key, abs_v in abstract.items():
        old_v = old.get(key)
        if key == "in":
            merged[key] = _ensure(abs_v, old_v if isinstance(old_v, dict) else {}, device)
        elif key == "delay":
            merged[key] = {}
            for slot_key, abs_slot in abs_v.items():
                old_slot = old_v.get(slot_key) if isinstance(old_v, dict) else None
                merged[key][slot_key] = (_restructured(abs_slot, old_slot)
                                         if _subtree_matches(abs_slot, old_slot)
                                         else _merge_channel(abs_slot, None, device))
        elif key == "t" and isinstance(old_v, dict):
            per_node = {k: v[0] if isinstance(v, torch.Tensor) and v.ndim == 1
                        and abs_v.get(k) is not None and abs_v[k].ndim == 0
                        and bool((v == v[0]).all()) else v
                        for k, v in old_v.items()}
            merged[key] = _merge_channel(abs_v, per_node, device)
        else:
            merged[key] = _merge_channel(abs_v, old_v, device)
    return merged


def global_tree_state(host: Tree, stored_layout: PlaneLayout,
                      current_layout: PlaneLayout) -> Tree:
    """A restored global state whose plane-form optimizer buckets were
    written at another tp (``stored_layout``, rebuilt from the manifest's
    ``plane_tp``) with those buckets in global tree form (``unpack_global``),
    so that any layout can take them; the state itself where the tp agree.
    The global parameters must have the current layout's global shapes:
    tp-dependent padding (``vocab_padded``, ``n_heads_padded``) that differs
    between the two tp raises."""
    if stored_layout.tp == current_layout.tp:
        return host
    want = [tuple(t.shape) for t in tree_leaves(current_layout.global_template())]
    have = [tuple(t.shape[1:]) for t in tree_leaves(host["params"])]
    if want != have:
        raise ValueError(
            f"the checkpoint was written at tp={stored_layout.tp} and its global leaves "
            f"differ from tp={current_layout.tp}'s: tp-dependent padding (vocab_padded / "
            "n_heads_padded) differs between the two tp, so the state is not convertible")
    buckets = set(stored_layout.segments)
    opt = {k: stored_layout.unpack_global(v, dtype=torch.float32, leading=1)
           if isinstance(v, dict) and set(v) == buckets else v
           for k, v in host.get("opt", {}).items()}
    return {**host, "opt": opt}


def reconcile_plane_state(state: Tree, plane_layout: PlaneLayout, flat_planes: bool) -> Tree:
    """Bring a restored state into the form this run keeps (its parameters
    and optimizer buckets in ``plane_layout``'s local form: one rank's shard
    at tp > 1; a checkpoint written at another tp goes through
    :func:`global_tree_state` first).

    Each optimizer bucket converts between tree and plane form
    (``repro.train.train_state.reconcile_plane_state``): a plane-form bucket
    is recognized by its top-level keys being the layout's dtype-bucket
    names, and all optimizer buckets are f32, packed and unpacked with the
    stacked node axis.  With ``flat_planes`` the parameter tree is packed
    into stacked planes (``state["planes"]``) and ``"params"`` becomes views
    of them, as :func:`init_train_state` lays them out; without, a state
    that holds planes keeps its parameters as plain tensors.  The channel
    state is not converted (its structure is transport-internal):
    :func:`ensure_channel_state` re-initializes it across formats.  Tree-form
    parameters and optimizer buckets take the layout template's structure
    back, empty subtrees included (a checkpoint stores none)."""
    buckets = set(plane_layout.segments)
    template = plane_layout.template
    new_opt: Tree = {}
    for k, v in state.get("opt", {}).items():
        is_plane = isinstance(v, dict) and set(v) == buckets
        if flat_planes and not is_plane:
            new_opt[k] = plane_layout.pack(v, dtype=torch.float32, leading=1)
        elif not flat_planes and is_plane:
            new_opt[k] = plane_layout.unpack(v, dtype=torch.float32, leading=1)
        else:
            new_opt[k] = v if is_plane else _as_template(template, v)
    new = {k: v for k, v in state.items() if k != "planes"}
    new["opt"] = new_opt
    if flat_planes:
        planes = plane_layout.pack(state["params"], leading=1)
        new["planes"] = planes
        new["params"] = plane_layout.view_unpack(planes, leading=1)
    else:
        params = _as_template(template, state["params"])
        new["params"] = (tree_map(lambda x: x.clone(), params) if "planes" in state
                         else params)
    return new


def _set_path(tree: dict, path: str, leaf) -> None:
    *parents, last = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = leaf


def _checkpoint_tree(state: Tree) -> dict:
    """What a checkpoint holds of a state: everything but the planes (their
    parameters are the ``"params"`` views) and the step."""
    return {k: v for k, v in state.items() if k not in ("planes", "step")}


def gather_state(state: Tree, group) -> Tree | None:
    """The global state on rank 0 of ``group``: each leaf's ``(1, ...)``
    replicas concatenated over the ranks into ``(n, ...)`` host tensors, the
    step, and empty subtrees dropped as a checkpoint drops them; None on the
    other ranks.  Every rank calls it."""
    comm, pg, world = group.comm_device, group.pg, group.world
    tree = _checkpoint_tree(state)
    out: dict = {} if group.rank == 0 else None
    for path, leaf in zip(tree_paths(tree), tree_leaves(tree)):
        mine = leaf.detach().to(comm).contiguous()
        flat = mine.reshape(-1).view(torch.uint8)
        slots = None
        if group.rank == 0:
            slots = [torch.empty_like(flat) for _ in range(world)]
        dist.gather(flat, gather_list=slots, dst=0, group=pg)
        if out is not None:
            parts = [s.view(leaf.dtype).reshape(leaf.shape) for s in slots]
            _set_path(out, path, torch.cat(parts).cpu())
    if out is not None:
        out["step"] = int(state["step"])
    return out


def scatter_state(host: Tree | None, group) -> Tree:
    """This rank's node of a global state held on rank 0 (``host``, None on
    the other ranks; its node axis must be ``group.world``): every leaf's
    ``[rank:rank + 1]`` slice, on the host.  Every rank calls it."""
    comm, pg = group.comm_device, group.pg
    meta = [None]
    if group.rank == 0:
        tree = _checkpoint_tree(host)
        leaves = tree_leaves(tree)
        bad = [p for p, t in zip(tree_paths(tree), leaves) if t.ndim < 1
               or t.shape[0] != group.world]
        meta = [(int(host["step"]), [(p, tuple(t.shape[1:]), t.dtype)
                                     for p, t in zip(tree_paths(tree), leaves)], bad)]
    dist.broadcast_object_list(meta, src=0, group=pg)
    step, specs, bad = meta[0]
    if bad:  # on every rank, so that none waits for a scatter that never comes
        raise ValueError(f"{bad} do not have {group.world} nodes")
    out: dict = {"step": step}
    leaves = tree_leaves(_checkpoint_tree(host)) if group.rank == 0 else None
    for k, (path, shape, dtype) in enumerate(specs):
        mine = torch.empty((1,) + shape, dtype=dtype, device=comm)
        flat = mine.reshape(-1).view(torch.uint8)
        parts = None
        if group.rank == 0:
            parts = [t.reshape(-1).view(torch.uint8).to(comm)
                     for t in leaves[k].contiguous().split(1)]
        dist.scatter(flat, scatter_list=parts, src=0, group=pg)
        _set_path(out, path, mine.cpu())
    out.setdefault("opt", {})
    out.setdefault("channel", {})
    return out


def _model_shards(tree: Tree, n: int, tp: int) -> list:
    """A tree of ``(n * tp, ...)`` rank slices -> ``tp`` trees of ``(n,
    ...)`` nodes, one per model index."""
    return [tree_map(lambda x: x.reshape((n, tp) + tuple(x.shape[1:]))[:, m], tree)
            for m in range(tp)]


def gather_grid_state(state: Tree, grid, layout: PlaneLayout) -> Tree | None:
    """The global state on rank 0 of the grid (None elsewhere): at tp = 1
    :func:`gather_state` over the node group; at tp > 1 the global parameter
    trees and optimizer buckets (plane-form ones as stacked shard planes,
    ``(n, tp * rows, LANES)``), without the channel state (module
    docstring).  ``layout`` is the run's (local) plane layout, whose shard
    axes say how each leaf joins.  Every rank calls it."""
    if grid.tp == 1:
        return gather_state(state, grid.node)
    host = gather_state({k: v for k, v in state.items() if k != "channel"}, grid.world)
    if host is None:
        return None
    n, tp, axes = grid.nodes, grid.tp, layout.shard_axes()
    buckets = set(layout.segments)

    def join(tree, ax):
        return tree_map(torch.Tensor.contiguous,
                        unshard(_model_shards(tree, n, tp), ax, leading=1))

    out = {"step": host["step"], "params": join(host["params"], axes), "opt": {}}
    for k, v in host.get("opt", {}).items():
        out["opt"][k] = join(v, {b: 0 for b in v} if set(v) == buckets else axes)
    return out


def scatter_grid_state(host: Tree | None, grid, layout: PlaneLayout,
                       stored_layout: PlaneLayout | None = None) -> Tree:
    """This rank's part of a global state held on rank 0 of the grid (None
    elsewhere; its node axis must be the grid's node count), on the host:
    at tp = 1 :func:`scatter_state` over the node group; at tp > 1 its
    node's shard of the parameters and of the optimizer buckets, these in
    tree form (``reconcile_plane_state`` then packs them), and no channel
    state.  ``stored_layout`` is the layout the checkpoint was written with
    (default: ``layout``'s tp).  Every rank calls it."""
    if grid.tp == 1 and (stored_layout is None or stored_layout.tp == 1):
        return scatter_state(host, grid.node)
    world = None
    if grid.world.rank == 0:
        host = global_tree_state(host, stored_layout or layout, layout)
        glob = layout.global_layout()
        buckets = set(layout.segments)

        def per_rank(tree):
            tree = _as_template(glob.template, tree)
            parts = [layout.shard_slice(tree_map(lambda x: x[i:i + 1], tree), m, leading=1)
                     for i in range(grid.nodes) for m in range(grid.tp)]
            return tree_map(lambda *xs: torch.cat(xs), *parts)

        # plane-form buckets left are in the current layout's stacked form
        opt = {k: per_rank(layout.unpack_global(v, dtype=torch.float32, leading=1)
                           if isinstance(v, dict) and set(v) == buckets else v)
               for k, v in host.get("opt", {}).items()}
        world = {"step": host["step"], "params": per_rank(host["params"]), "opt": opt}
    out = scatter_state(world, grid.world)
    out["channel"] = {}
    return out
