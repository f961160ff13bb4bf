"""The node group: one process per decentralized node over ``torch.distributed``.

The counterpart of ``repro.launch.mesh``.  Where the reference lays its
nodes out as the node axes of a device mesh and runs the step inside
``shard_map``, the port runs one process per node, each holding its
replica with a node axis of size 1 (a shard_map block), and the gossip
channels talk between processes.

Each rank's device and backend are picked explicitly
(:func:`pick_backend`), printed at start and never changed after a
failure:

* **nccl** on ``cuda:<rank>`` when the host has at least one card per rank;
* **gloo** on ``cuda:0`` when several ranks share one card: gloo moves CPU
  tensors only, so every message is staged through pinned host memory
  (:attr:`NodeGroup.staged`);
* **gloo** on the CPU when the caller asks for ``device="cpu"``.

Tensor parallelism lays the world out as a ``(nodes x tp)`` grid
(:class:`Grid`, :func:`init_grid`): rank ``r`` is node ``r // tp`` at model
index ``r % tp``, ``jax.make_mesh((n, tp), ("data", "model"))``'s device
order.  The **model group** (the ranks of one node) carries the
tensor-parallel collectives; the **node group** (the ranks of one model
index) carries the gossip, as the node group of a tp = 1 run does.  The
backend rule is the world's: with fewer cards than ranks every group runs
over gloo, its messages staged through pinned host memory.
:func:`shrink_grid` keeps the first nodes of a grid with all their model
ranks (the failure drill), every rank of the old grid making the new
groups.

:func:`run_ranks` spawns a group on this host (the ``spawn`` start method,
never ``fork``), gives every rank a deadline and raises if any rank fails.

:func:`dry_grid` gives one rank's place on a grid of any size with no
process group (backend ``"dry"``, device ``meta``): the dry run
(:mod:`repro_torch.launch.dryrun`) builds a rank's program on it.  The
collective seams (``core.gossip._Wire``, ``models.layers.TPContext``)
record each collective and return a meta tensor of its result's shape, and
raise on a tensor that is not on the meta device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401  (registers the tensor reductions)
from multiprocessing.reduction import ForkingPickler

__all__ = ["NodeGroup", "Grid", "pick_backend", "init_node_group", "init_grid", "shrink_grid",
           "subgroup", "dry_grid", "n_nodes_of", "node_index", "run_ranks"]


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """This process's place in the node group.  ``pg`` is the process group
    the channels and means talk over (None: the default group).  ``axis``
    names the group in the cost model's records: ``"node"`` (gossip, the
    psum mean, metrics) or ``"model"`` (a node's tensor-parallel group)."""

    rank: int
    world: int
    backend: str  # "nccl" | "gloo" | "dry" (no process group: meta tensors only)
    device: torch.device
    pg: Any = None
    # the global rank of each group rank (None: the group rank itself)
    members: tuple[int, ...] | None = None
    axis: str = "node"

    def peer(self, r: int) -> int:
        """The global rank of group rank ``r`` (point-to-point ops and a
        collective's ``src``/``dst`` name global ranks)."""
        return r if self.members is None else self.members[r]

    @property
    def staged(self) -> bool:
        """Whether payloads on the device go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def dry(self) -> bool:
        """Whether this is a :func:`dry_grid` group (no process group)."""
        return self.backend == "dry"

    @property
    def comm_device(self) -> torch.device:
        """Where small collectives (metrics, gaps) put their tensors."""
        return self.device if self.backend in ("nccl", "dry") else torch.device("cpu")

    def describe(self) -> str:
        how = {"nccl": "NCCL, one card per rank", "dry": "dry: no process group, meta tensors",
               "gloo": ("gloo, the ranks share the card, messages staged through pinned "
                        "host memory" if self.staged else "gloo on the host CPU")}[self.backend]
        return f"rank {self.rank}/{self.world} on {self.device} ({how})"


def pick_backend(rank: int, world: int, device: str, cuda_count: int) -> tuple[str, str]:
    """``(backend, device)`` for one rank: nccl on ``cuda:<rank>`` when there
    are at least ``world`` cards, gloo on ``cuda:0`` when fewer cards than
    ranks, gloo on the CPU when ``device == "cpu"``.  Asking for CUDA on a
    host without it raises (no CPU fallback)."""
    if device == "cpu":
        return "gloo", "cpu"
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if cuda_count < 1:
        raise RuntimeError("CUDA was requested but no CUDA device is available; "
                           "pass device='cpu' to run on the host")
    if cuda_count >= world:
        return "nccl", f"cuda:{rank}"
    return "gloo", "cuda:0"


def init_node_group(rank: int, world: int, init_method: str, *, device: str = "cuda",
                    timeout_s: float = 600.0) -> NodeGroup:
    """Join the default process group as ``rank`` of ``world`` and return
    this rank's :class:`NodeGroup`.  An NCCL init that fails raises; the
    choice is never retried on another backend."""
    backend, dev = pick_backend(rank, world, device,
                                torch.cuda.device_count() if device == "cuda" else 0)
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return NodeGroup(rank=rank, world=world, backend=backend, device=dev)


def subgroup(group: NodeGroup, ranks: list[int]) -> NodeGroup | None:
    """The group of ``ranks`` (a prefix ``0..m-1`` of ``group``, so a rank
    keeps its index), or None on a rank outside it.  Every rank of
    ``group`` must call it."""
    if list(ranks) != list(range(len(ranks))):
        raise ValueError(f"a subgroup keeps the ranks 0..m-1, got {ranks}")
    pg = dist.new_group(ranks=list(ranks), backend=group.backend)
    if group.rank not in ranks:
        return None
    return dataclasses.replace(group, world=len(ranks), pg=pg)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on the ``(nodes x tp)`` grid: ``world`` every rank
    (the default group), ``node`` the ranks of this model index (gossip;
    its rank is the node index), ``model`` the ranks of this node (the
    tensor-parallel collectives; its rank is the model index)."""

    world: NodeGroup
    node: NodeGroup
    model: NodeGroup
    tp: int

    @property
    def nodes(self) -> int:
        return self.node.world

    def describe(self) -> str:
        return (f"{self.world.describe()}: node {self.node.rank} of {self.nodes}, model index "
                f"{self.model.rank} of {self.tp}")


def init_grid(world: NodeGroup, tp: int) -> Grid:
    """Lay the ranks of ``world`` out as ``world.world // tp`` nodes of
    ``tp`` model ranks and make the subgroups: every rank creates every
    model group (node by node), then every node group (index by index), in
    that order.  At tp = 1 the node group is ``world`` itself and the model
    group a group of one, and no subgroup is made."""
    if tp < 1 or world.world % tp:
        raise ValueError(f"{world.world} ranks do not form nodes of tp={tp} ranks")
    if tp == 1:
        return Grid(world=world, node=world,
                    model=dataclasses.replace(world, rank=0, world=1, pg=None,
                                              members=(world.rank,), axis="model"), tp=1)
    return _grid_groups(world, world.world // tp, tp, world.backend)


def _grid_groups(world: NodeGroup | None, n: int, tp: int, backend: str) -> Grid | None:
    """Make every model group, then every node group, of an ``(n x tp)``
    grid over global ranks ``0 .. n * tp - 1``, and this rank's place on it
    (None on a rank outside it, ``world`` None, which still enters every
    ``new_group``)."""
    i, m = divmod(world.rank, tp) if world is not None else (-1, -1)
    model = node = None
    for j in range(n):
        ranks = tuple(range(j * tp, (j + 1) * tp))
        pg = dist.new_group(ranks=list(ranks), backend=backend)
        if j == i:
            model = dataclasses.replace(world, rank=m, world=tp, pg=pg, members=ranks,
                                        axis="model")
    for k in range(tp):
        ranks = tuple(range(k, n * tp, tp))
        pg = dist.new_group(ranks=list(ranks), backend=backend)
        if k == m:
            node = dataclasses.replace(world, rank=i, world=n, pg=pg, members=ranks)
    return None if world is None else Grid(world=world, node=node, model=model, tp=tp)


def shrink_grid(grid: Grid, nodes: int) -> Grid | None:
    """The grid of ``grid``'s first ``nodes`` nodes with all their model
    ranks (global ranks ``0 .. nodes * tp - 1``, each keeping its rank), or
    None on a rank that leaves.  ``torch.distributed.new_group`` must be
    entered by every rank of the default group, members or not, so every
    rank of ``grid`` (the default group's ranks) calls this: it makes the
    survivors' world group, then every model and node group of the
    ``(nodes x tp)`` grid in :func:`init_grid`'s order, and only then does a
    leaving rank get its None."""
    if not 1 <= nodes <= grid.nodes:
        raise ValueError(f"cannot shrink {grid.nodes} nodes to {nodes}")
    world = subgroup(grid.world, list(range(nodes * grid.tp)))
    if grid.tp == 1:
        return None if world is None else init_grid(world, 1)
    return _grid_groups(world, nodes, grid.tp, grid.world.backend)


def dry_grid(nodes: int, tp: int, *, node: int = 0, index: int = 0) -> Grid:
    """Rank ``(node, index)`` of a ``(nodes x tp)`` grid with no process
    group: every group is ``"dry"`` on the meta device (module docstring)."""
    if not (0 <= node < nodes and 0 <= index < tp):
        raise ValueError(f"rank ({node}, {index}) is not on a ({nodes} x {tp}) grid")
    meta = torch.device("meta")
    world = NodeGroup(rank=node * tp + index, world=nodes * tp, backend="dry", device=meta)
    return Grid(world=world,
                node=NodeGroup(rank=node, world=nodes, backend="dry", device=meta,
                               members=tuple(range(index, nodes * tp, tp))),
                model=NodeGroup(rank=index, world=tp, backend="dry", device=meta,
                                members=tuple(range(node * tp, (node + 1) * tp)),
                                axis="model"),
                tp=tp)


def n_nodes_of(group: NodeGroup) -> int:
    """The number of decentralized nodes (``repro``'s ``n_nodes_of(mesh)``)."""
    return group.world


def node_index(group: NodeGroup) -> int:
    """This process's node (``repro``'s ``axis_index`` over the node axes)."""
    return group.rank


def _rank_entry(rank, world, init_method, device, call_path, results, timeout_s):
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        group = init_node_group(rank, world, init_method, device=device, timeout_s=timeout_s)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *args, device: str = "cuda",
              timeout_s: float | None = None) -> list:
    """Run ``fn(group, *args)`` in ``world`` spawned processes, one per node,
    and return their results by rank.  ``fn`` and ``args`` are pickled (a
    module-level function).  The ranks rendezvous through a file store in a
    fresh temporary directory, and read ``fn`` and ``args`` from a file
    there: a spawned process takes its start arguments through a pipe that
    the parent fills while the child imports, so large arguments there would
    start the ranks one after another.  A rank that raises, dies or outlives
    ``timeout_s`` (None: no deadline) fails the run: the others are killed
    and a RuntimeError carries the failing rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group.")
    init_method = "file://" + os.path.join(tmp, "store")
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        f.write(ForkingPickler.dumps((fn, args)))
    results = ctx.Queue()
    coll_timeout = 600.0 if timeout_s is None else float(timeout_s)
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, init_method, device, call_path, results, coll_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: dict[int, Any] = {}
    failure = None
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    time.sleep(1.0)  # let a dying rank's traceback arrive first
                    try:
                        rank, ok, val = results.get(timeout=0.1)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                elif deadline is not None and time.monotonic() > deadline:
                    failure = (f"the group of {world} ranks outlived its {timeout_s:.0f} s "
                               f"deadline ({sorted(out)} finished)")
                    break
                else:
                    continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
        for p in procs:
            p.join(timeout=30.0 if failure is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
