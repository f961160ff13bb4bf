"""Cost accounting of an eager torch program (the port of ``repro.launch.costmodel``).

The reference walks a jaxpr, multiplying scan bodies by their trip
counts.  Eager PyTorch has no scans: every op dispatches each time it
runs, so :func:`analyze` runs ``fn`` under a
``TorchDispatchMode`` (:class:`CostRecorder`) and counts each aten op as
often as it runs.  Autograd's backward dispatches through the mode too, so
gradients are counted.  ``naive_bytes_untripped`` therefore equals
``naive_bytes``.  The program runs for real (on meta tensors it allocates
nothing: :mod:`repro_torch.launch.dryrun`).

Outputs per program, as the reference's:

* ``flops`` — 2*M*N*K for ``mm``/``bmm``/``addmm``/``baddbmm`` (and
  ``linear``/``matmul`` where they reach the mode), the reference's rule for
  ``convolution`` (2 * output elements * kernel elements per output
  channel), one per output element for every other op but an ``empty``;
* ``naive_bytes`` — operand + result bytes of every op;
* ``materialized_bytes`` — the same for the ops of the reference's
  ``_MATERIALIZING`` set only (products, gathers and scatters,
  concatenations, sorts and scans, collectives), elementwise chains assumed
  fused;
* ``collective_bytes`` — per-device link egress under the ring rules of
  :func:`~repro_torch.launch.roofline.collective_egress`, with
  ``collective_counts`` by op and ``collective_breakdown`` by
  ``label@group@shape``.

**A hand-written kernel is one unit**, as ``pallas_call`` is in the
reference: each kernel entry point (the stage executor's per-leaf or
per-bucket call, ``flash_attention``, ``mlstm``, the model layer's ``gemm``,
whose FLOPs count as products) reports one launch with
the FLOPs and bytes of its kernel's ``work`` through :func:`kernel_unit`,
and the recorder ignores the aten ops inside that call — the plain
version's on the CPU, the launcher's allocations on the card — so a CPU
run and a card run of the same step count alike.  :func:`count_launches`
is the counterpart of ``count_primitive(jaxpr, "pallas_call")``.

**A loop traced once**: on meta tensors the sLSTM recurrence
(:mod:`repro_torch.models.xlstm`) runs one step of its time loop inside
:func:`trips`, which counts that step's ops (forward, and backward through
its autograd function) once per step of the sequence.

**Collectives** are recorded where the port issues them: ``_Wire``
(:mod:`repro_torch.core.gossip`: the distributed channels, the psum mean
and the distributed step's metric reductions) and ``TPContext._run``
(:mod:`repro_torch.models.layers`), by op, group and bytes, through
:func:`record_collective`.  A group's ``axis`` (``"node"`` or
``"model"``) names it in the keys, as a mesh axis names it in the
reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from .roofline import collective_egress

__all__ = [
    "Costs",
    "CostRecorder",
    "MemoryTracker",
    "analyze",
    "count_launches",
    "kernel_unit",
    "record_collective",
    "trips",
]


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    collective_bytes: float = 0.0
    naive_bytes: float = 0.0
    naive_bytes_untripped: float = 0.0
    # bytes of *materializing* ops only (products, gathers/scatters,
    # concatenations, sorts and scans, collectives, kernel units); pure
    # elementwise ops are assumed fused into their producers.  This is the
    # memory-roofline numerator.
    materialized_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    # per-(op, group, shape) egress bytes — the collective "profile"
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    # the port's own: the products' share of ``flops``, and the kernel
    # units by name (launches, and the FLOPs and bytes of their work)
    product_flops: float = 0.0
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    kernel_bytes: dict = dataclasses.field(default_factory=dict)


_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "linear", "matmul"}
_CONVS = {"convolution", "convolution_backward"}
# allocations that write nothing: no operations
_EMPTIES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
# the reference's _MATERIALIZING set in aten's names: products and
# convolutions, gathers and scatters (dynamic_slice/update_slice are views
# and slice_scatter here), concatenate, sort, the scans, top_k, argmax/min
_MATERIALIZING = _PRODUCTS | _CONVS | {
    "embedding", "embedding_dense_backward", "index", "index_select", "gather", "take",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl",
    "index_add", "index_copy", "slice_scatter", "select_scatter", "cat", "stack", "sort",
    "cumsum", "logcumsumexp", "cummax", "cummin", "topk", "argmax", "argmin",
}


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _product_flops(name: str, args, out: torch.Tensor) -> float:
    """2 * (output elements) * K of a product, K its contraction length
    (``addbmm`` also sums over its batch); the bias add of ``addmm`` and
    ``baddbmm`` is one more op per output element, as XLA's add is."""
    a = args[1] if name in ("addmm", "baddbmm", "addbmm") else args[0]
    k = a.shape[-1] * (a.shape[0] if name == "addbmm" else 1)
    flops = 2.0 * out.numel() * k
    return flops + out.numel() if name in ("addmm", "baddbmm", "addbmm") else flops


def _conv_flops(name: str, args, out) -> float:
    """2 * output elements * (kernel elements per output channel), the
    reference's rule; the backward counts that once for each gradient it
    computes (input, weight)."""
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    grad_out, w = args[0], args[2]
    mask = args[-1]
    per = 2.0 * grad_out.numel() * (w.numel() // w.shape[0])
    return per * sum(1 for m in mask[:2] if m)


class MemoryTracker:
    """Live device bytes of a program, from the storages its ops create.

    The arguments' storages are counted once as ``argument_bytes``; every
    other storage an op returns joins the live set until the last tensor on
    it dies (a ``weakref.finalize`` on the storage), and ``peak_bytes`` is
    the largest the live set grew.  Works alike on meta tensors (what the
    card would hold, allocating nothing) and on real ones."""

    def __init__(self, args=()):
        self._args: dict[int, float] = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            self._args.setdefault(st._cdata, float(st.nbytes()))
        self.argument_bytes = sum(self._args.values())
        self._live: dict[int, float] = {}
        self.live_bytes = 0.0
        self.peak_bytes = 0.0

    def track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._live:
                continue
            nb = float(st.nbytes())
            self._live[key] = nb
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0.0)

    def report(self, outputs) -> dict:
        """The reference's ``memory`` record: arguments, outputs (their
        storages, once each; ``alias_bytes`` those shared with an argument),
        and the peak of the other live storages as ``temp_bytes``."""
        seen: dict[int, float] = {}
        alias = 0.0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen[st._cdata] = float(st.nbytes())
            if st._cdata in self._args:
                alias += seen[st._cdata]
        return {"argument_bytes": self.argument_bytes, "output_bytes": sum(seen.values()),
                "temp_bytes": self.peak_bytes, "alias_bytes": alias}


class CostRecorder(TorchDispatchMode):
    """Counts every aten op ``fn`` dispatches into ``costs`` (the module
    docstring's rules), the kernel units and collectives the port reports,
    and, with a :class:`MemoryTracker`, the storages the ops create.
    ``group_sizes`` maps a group's axis (``"node"``, ``"model"``) to the
    size its collectives are priced at (default: the group's own)."""

    def __init__(self, group_sizes: dict[str, int] | None = None,
                 memory: MemoryTracker | None = None):
        super().__init__()
        self.costs = Costs()
        self.group_sizes = dict(group_sizes or {})
        self.memory = memory
        self._unit = 0
        self._trips = 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.memory is not None:
            self.memory.track(out)
        if self._unit:
            return out
        name = func._overloadpacket.__name__.rstrip("_")
        n = self._trips
        io = n * (sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(
            _nbytes(t) for t in _tensors(out)))
        c = self.costs
        c.naive_bytes += io
        c.naive_bytes_untripped += io
        if name in _MATERIALIZING:
            c.materialized_bytes += io
        if name in _PRODUCTS:
            f = n * _product_flops(name, args, out)
            c.flops += f
            c.product_flops += f
        elif name in _CONVS:
            first = out[0] if isinstance(out, (list, tuple)) else out
            f = n * _conv_flops(name, args, first)
            c.flops += f
            c.product_flops += f
        elif name not in _EMPTIES:
            c.flops += n * sum(float(t.numel()) for t in _tensors(out))
        return out

    def add_unit(self, name: str, flops: float, nbytes: float, product: bool = False) -> None:
        c = self.costs
        c.flops += flops
        if product:
            c.product_flops += flops
        c.naive_bytes += nbytes
        c.naive_bytes_untripped += nbytes
        c.materialized_bytes += nbytes
        c.kernel_launches[name] = c.kernel_launches.get(name, 0) + 1
        c.kernel_flops[name] = c.kernel_flops.get(name, 0) + flops
        c.kernel_bytes[name] = c.kernel_bytes.get(name, 0) + nbytes

    def add_collective(self, op: str, axis: str, group: int, shape, in_bytes: float,
                       out_bytes: float) -> None:
        g = self.group_sizes.get(axis, group)
        egress = collective_egress(op, out_bytes if op == "all-gather" else in_bytes, g)
        c = self.costs
        c.collective_bytes += egress
        c.naive_bytes += in_bytes + out_bytes
        c.naive_bytes_untripped += in_bytes + out_bytes
        c.materialized_bytes += in_bytes + out_bytes
        c.collective_counts[op] = c.collective_counts.get(op, 0) + 1
        key = f"{op}@{axis}@{tuple(shape)}"
        c.collective_breakdown[key] = c.collective_breakdown.get(key, 0.0) + egress


def _active() -> CostRecorder | None:
    """The innermost recorder on torch's (thread-local) dispatch-mode stack,
    which autograd carries into its backward threads."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostRecorder):
            return mode
    return None


@contextlib.contextmanager
def kernel_unit(name: str, work: Callable[[], tuple[float, float]], product: bool = False):
    """One launch of the hand-written kernel ``name``: under a recorder,
    ``work()``'s FLOPs and bytes are counted once and the aten ops inside
    the block are not (its allocations still count as memory); with
    ``product`` the FLOPs are a matrix product's (``product_flops``, as the
    ``mm`` the kernel stands for).  Without one it does nothing (``work`` is
    not called)."""
    rec = _active()
    if rec is None:
        yield
        return
    flops, nbytes = work()
    rec.add_unit(name, flops, nbytes, product)
    rec._unit += 1
    try:
        yield
    finally:
        rec._unit -= 1


@contextlib.contextmanager
def trips(n: int):
    """Count every aten op inside the block ``n`` times: the body of a loop
    of ``n`` like iterations, traced once (the reference's jaxpr walk
    multiplies a scan body by its trip count).  Memory is tracked as run.
    Without a recorder it does nothing."""
    rec = _active()
    if rec is None:
        yield
        return
    rec._trips *= n
    try:
        yield
    finally:
        rec._trips //= n


def record_collective(op: str, group, shape, in_bytes: float, out_bytes: float) -> None:
    """One collective over ``group`` (a :class:`~repro_torch.launch.mesh.
    NodeGroup`): ``op`` in the reference's labels (all-reduce, all-gather,
    collective-permute, ...), ``shape`` the operand's.  Counted only under
    a recorder, and not inside a kernel unit."""
    rec = _active()
    if rec is None or rec._unit:
        return
    rec.add_collective(op, getattr(group, "axis", "node"), group.world, shape, in_bytes,
                       out_bytes)


def analyze(fn: Callable, args, group_sizes: dict[str, int] | None = None) -> Costs:
    """Run ``fn(*args)`` under a :class:`CostRecorder` and return its
    :class:`Costs`.  ``group_sizes`` prices each group axis's collectives at
    that size (default: as run)."""
    rec = CostRecorder(group_sizes)
    with rec:
        fn(*args)
    return rec.costs


def count_launches(fn: Callable, args, name: str) -> int:
    """Launches of the hand-written kernel ``name`` (``"fused_update"``,
    ``"flash_attention"``, ``"mlstm_chunk"``) in one run of ``fn(*args)``:
    the counterpart of ``count_primitive(jaxpr, "pallas_call")``, counted
    whether each call launched the kernel (on the card) or ran its plain
    version (on the CPU) or its meta stand-in."""
    return analyze(fn, args).kernel_launches.get(name, 0)
