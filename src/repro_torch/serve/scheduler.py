"""Continuous-batching request scheduler over the serve step builders (the
port of ``repro.serve.scheduler``), on one device or on a ``(nodes x tp)``
grid of ranks.

A request queue feeds a fixed set of in-flight **decode slots**; each
engine tick admits waiting requests into free slots (one right-padded
prefill for the admission wave, merged per slot into the live KV cache)
and then advances every active slot one token in a single batched decode
step with **per-slot positions** (request timelines are independent).
Completed requests free their slot for the next admission.

The slot mechanics are the reference's:

* **Right-padded prefill.**  An admission wave pads prompts to the
  engine's static ``max_prompt`` with token 0.  The pad tail *is* written
  to the KV cache, but decode masks cache entries by true position
  (``pos <= t``), so pad entries are invisible until the slot's timeline
  reaches them — at which point the generated token overwrites exactly
  that slot (the write slot is ``t % capacity``).
* **First decode re-feeds the last prompt token.**  Prefill returns
  logits for the padded last column, which is wrong for any prompt shorter
  than ``max_prompt``; admission instead seeds the slot with
  ``tokens[len-1]`` at ``t = len-1``.  The decode step rewrites position
  ``len-1`` with identical k/v and returns the logits the first generated
  token is sampled from — uniform for all lengths.
* **Idle slots decode garbage.**  They run in the batch (the batch is the
  fixed slot count) with ``t`` pinned to 0 and their outputs ignored;
  admission replaces their entire per-slot cache under the admit mask.

Weight swaps happen at the tick boundary — *between* decode batches, never
inside one — by re-reading the :class:`~repro_torch.serve.publisher.
WeightPublisher`'s current snapshot: a newer published version is copied
to the device once (one copy per dtype bucket, the "swap stall"; the
reference takes one transfer per leaf) and the parameters become views of
those device planes; every later prefill and decode runs on them.
In-flight requests continue on the new weights, the standard
continuous-batching trade (the KV cache stays valid: the architecture is
fixed).

On a grid (``grid=``) every rank runs an engine with the same requests
and the same schedule: each holds its serving shard of the weights and its
shard of the cache (its node's slots when the node count divides the slot
count, the reference's batch split), and every decode batch's logits are
all-gathered (vocab over the model group, rows over the nodes) before the
greedy pick.  So every rank picks the same tokens from the same bits, and
admission and retirement, which read only those tokens and the request
queue, agree on every rank: no rank decides alone.  A publisher's
snapshots must be offered alike on every rank; they are global, and each
swap packs the rank's shard of one on the host (its own pinned planes) and
copies only that to the device.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.planes import PlaneLayout
from ..models import transformer as T
from ..train import serve as serve_mod
from ..utils import resolve_device, shard, tree_leaves, tree_map
from .publisher import WeightPublisher
from .sampling import greedy_token

Tree = Any

__all__ = ["Request", "Completion", "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    tokens: np.ndarray  # (len,) int32 prompt token ids
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray  # (n_generated,) int32
    submitted_s: float  # perf_counter timestamps
    admitted_s: float
    finished_s: float

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s


class ServeEngine:
    """Continuous-batching serving engine (see module docstring).

    ``slots`` is the decode batch size; ``max_prompt``/``max_new`` bound
    request sizes, and the KV capacity is ``max_prompt + max_new`` so any
    admissible request fits its slot.  ``params`` is the parameter tree
    served (tensors, :func:`repro_torch.interop.from_numpy` converts a JAX
    tree); it is moved to ``device`` (CUDA unless the caller passes a CPU
    device).  ``runtime`` defaults to float32 with the plain attention, as
    the reference engine's default runtime is float32.  ``on_logits``, if
    given, sees every decode step's logits ``(slots, vocab)`` with a dict
    that maps each active slot to ``(request id, index of the generated
    token its row yields)``; it observes and changes nothing.  Instead of
    ``params`` the engine may take a ``publisher`` and serve its newest
    snapshot, swapped in between decode batches; one of the two is required.
    With ``grid`` (a :class:`~repro_torch.launch.mesh.Grid`) the engine is
    one rank's part of the grid's engine (module docstring): ``params`` and
    the snapshots are global trees, of which it keeps its serving shard;
    ``timing`` makes the steps' TP counters (``prefill_step.tp``,
    ``decode_step.tp``) hold the collectives alone.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_prompt: int, max_new: int,
                 params: Tree | None = None, publisher: WeightPublisher | None = None,
                 runtime: T.RuntimeConfig | None = None,
                 eos_id: int | None = None, device=None,
                 on_logits: Callable[[torch.Tensor, dict[int, tuple[int, int]]], None]
                 | None = None, grid=None, timing: bool = False):
        if cfg.arch_kind == "encdec":
            # as repro's engine: requests carry token prompts only
            raise NotImplementedError(
                f"{cfg.name} is an encoder-decoder: its prefill needs 'enc_frames', which "
                "the engine's requests do not carry; serve it through "
                "models.transformer.prefill and decode_step")
        self.device = resolve_device(device)
        rt = runtime if runtime is not None else T.RuntimeConfig(dtype="float32")
        self.cfg = cfg
        self.slots = int(slots)
        self.max_prompt = int(max_prompt)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.on_logits = on_logits
        target_len = self.max_prompt + self.max_new
        scfg = serve_mod.ServeConfig(runtime=rt, target_len=target_len)
        self.grid = grid
        self.prefill_step = serve_mod.build_prefill_step(cfg, scfg, grid,
                                                         global_batch=self.slots, timing=timing)
        self.decode_step = serve_mod.build_decode_step(
            cfg, scfg, grid, target_len=target_len, per_slot_t=True, global_batch=self.slots,
            timing=timing,
        )
        self._rows = None  # this node's slots, when the slots split over the nodes
        if grid is not None and grid.nodes > 1 and serve_mod.batch_splits(self.slots,
                                                                          grid.nodes):
            b = self.slots // grid.nodes
            self._rows = (grid.node.rank * b, (grid.node.rank + 1) * b)
        if publisher is None and params is None:
            raise ValueError("pass a publisher or an initial params tree")
        self._publisher = publisher
        self._params: Tree | None = None
        self.version: int | None = None
        # at tp > 1 this rank's serving shard in plane form: its layout and
        # pinned host planes, which each swap packs from the snapshot
        self._shard_layout: PlaneLayout | None = None
        self._shard_host: dict | None = None
        if params is not None:
            # at tp > 1 each leaf is copied out of the global tree: the rank
            # keeps its shard, not views that keep the whole model alive
            own = grid is not None and grid.tp > 1
            self._params = tree_map(lambda x: x.to(self.device, copy=own), self._shard(params))
        self._cache: Tree | None = None

        # per-slot bookkeeping (host side)
        self._slot_req: list[Request | None] = [None] * self.slots
        self._slot_gen: list[list[int]] = [[] for _ in range(self.slots)]
        self._slot_admitted: list[float] = [0.0] * self.slots
        self._slot_submitted: list[float] = [0.0] * self.slots
        self._t = np.zeros(self.slots, np.int32)  # position of the fed token
        self._feed = np.zeros(self.slots, np.int32)  # token to feed next
        self._active = np.zeros(self.slots, bool)
        self._queue: deque[tuple[Request, float]] = deque()
        self.completions: list[Completion] = []

        self.ticks = 0
        self.waiting_ticks = 0
        self.decode_batches = 0
        self.prefills = 0
        self.swaps = 0
        self.swap_stall_s = 0.0

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        tokens = np.asarray(req.tokens, np.int32).reshape(-1)
        if not 1 <= tokens.size <= self.max_prompt:
            raise ValueError(f"request {req.rid}: prompt of {tokens.size} tokens, the "
                             f"engine takes 1..{self.max_prompt}")
        if not 1 <= req.max_new_tokens <= self.max_new:
            raise ValueError(f"request {req.rid}: max_new_tokens {req.max_new_tokens}, the "
                             f"engine takes 1..{self.max_new}")
        self._queue.append((dataclasses.replace(req, tokens=tokens), time.perf_counter()))

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return int(self._active.sum())

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active.any()

    def tick(self) -> bool:
        """One engine step: swap point, admission, then one decode batch.
        Returns False when there was nothing to do (engine idle)."""
        if self.idle:
            return False
        self.ticks += 1
        self._maybe_swap()
        if self._params is None:
            # waiting on the publisher's first admitted version (the
            # consensus gate may hold back early offers)
            self.waiting_ticks += 1
            return True
        with torch.inference_mode():
            self._admit()
            if self._active.any():
                self._decode_batch()
        return True

    def run_until_drained(self, max_ticks: int = 100_000) -> list[Completion]:
        for _ in range(max_ticks):
            if not self.tick():
                break
        else:
            raise RuntimeError(f"not drained after {max_ticks} ticks")
        return self.completions

    def stats(self) -> dict[str, Any]:
        return {
            "ticks": self.ticks,
            "decode_batches": self.decode_batches,
            "prefills": self.prefills,
            "completed": len(self.completions),
            "swaps": self.swaps,
            "swap_stall_s": self.swap_stall_s,
            "version": self.version,
        }

    # -- internals ----------------------------------------------------------

    def _shard(self, params: Tree) -> Tree:
        """This rank's serving shard of a global tree (itself at tp = 1)."""
        if self.grid is None or self.grid.tp == 1:
            return params
        axes = serve_mod.serve_specs(self.cfg, self.grid, global_batch=self.slots)[0]
        return shard(params, axes, self.grid.tp, self.grid.model.rank)

    def _maybe_swap(self) -> None:
        """Snapshot-swap point (between decode batches, never inside one)."""
        if self._publisher is None:
            return
        snap = self._publisher.current
        if snap is None or snap.version == self.version:
            return
        t0 = time.perf_counter()
        # one copy per dtype bucket off the publisher's host buffers (a copy
        # also on the CPU: the writer rewrites them two publishes later),
        # then the parameters as views of the device planes; at tp > 1 the
        # buffers are this rank's shard, packed on the host first, so that
        # only the shard reaches the device
        layout, host = self._publisher.layout, snap.planes
        if self.grid is not None and self.grid.tp > 1:
            layout, host = self._pack_shard(snap.params)
        planes = {k: v.to(self.device, copy=True) for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.swap_stall_s += time.perf_counter() - t0
        if self.version is not None:
            self.swaps += 1
        self._params = layout.view_unpack(planes)
        self.version = snap.version

    def _pack_shard(self, params: Tree) -> tuple[PlaneLayout, dict]:
        """This rank's serving shard of a snapshot's global ``params`` packed
        into its pinned host planes: ``(its layout, the planes)``."""
        if self._shard_layout is None:
            axes = serve_mod.serve_specs(self.cfg, self.grid, global_batch=self.slots)[0]
            self._shard_layout = PlaneLayout.build(self._publisher.layout.global_template(),
                                                   tp=self.grid.tp, shardings=axes)
            pin = self.device.type == "cuda"
            self._shard_host = {k: torch.zeros(shape, dtype=dt, pin_memory=pin) for k, (shape, dt)
                                in self._shard_layout.plane_shapes().items()}
        layout = self._shard_layout
        layout.host_pack(layout.shard_slice(params, self.grid.model.rank), out=self._shard_host)
        return layout, self._shard_host

    def _admit(self) -> None:
        free = [i for i in range(self.slots) if not self._active[i]]
        if not free or not self._queue:
            return
        toks = np.zeros((self.slots, self.max_prompt), np.int32)
        admit = np.zeros(self.slots, bool)
        now = time.perf_counter()
        for i in free:
            if not self._queue:
                break
            req, submitted = self._queue.popleft()
            n = req.tokens.size
            toks[i, :n] = req.tokens  # right-padded with token 0
            admit[i] = True
            self._slot_req[i] = req
            self._slot_gen[i] = []
            self._slot_submitted[i] = submitted
            self._slot_admitted[i] = now
            self._t[i] = n - 1
            self._feed[i] = req.tokens[n - 1]
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        _, new_cache = self.prefill_step(self._params, batch)
        self.prefills += 1
        if self._cache is None:
            self._cache = new_cache
        else:
            # keep the old per-slot cache except where admitted; every cache
            # leaf is layer-stacked (Lg, B, ...) with the batch at axis 1
            sel = np.flatnonzero(admit)
            if self._rows is not None:  # this node's slots only
                lo, hi = self._rows
                sel = sel[(sel >= lo) & (sel < hi)] - lo
            idx = torch.from_numpy(sel).to(self.device)
            for old, new in zip(tree_leaves(self._cache), tree_leaves(new_cache)):
                old[:, idx] = new[:, idx]
        self._active |= admit

    def _decode_batch(self) -> None:
        tokens = torch.from_numpy(self._feed[:, None].copy()).to(self.device)
        t = torch.from_numpy(np.where(self._active, self._t, 0).astype(np.int32))
        logits, self._cache = self.decode_step(self._params, tokens, self._cache, t)
        logits = serve_mod.gather_logits(logits, self.grid, global_batch=self.slots)
        self.decode_batches += 1
        if self.on_logits is not None:
            self.on_logits(logits, {i: (self._slot_req[i].rid, len(self._slot_gen[i]))
                                    for i in range(self.slots) if self._active[i]})
        nxt = greedy_token(logits).cpu().numpy()
        now = time.perf_counter()
        for i in range(self.slots):
            if not self._active[i]:
                continue
            tok = int(nxt[i])
            self._slot_gen[i].append(tok)
            self._t[i] += 1
            self._feed[i] = tok
            req = self._slot_req[i]
            done = len(self._slot_gen[i]) >= req.max_new_tokens or (
                self.eos_id is not None and tok == self.eos_id
            )
            if done:
                self.completions.append(Completion(
                    rid=req.rid,
                    tokens=np.asarray(self._slot_gen[i], np.int32),
                    submitted_s=self._slot_submitted[i],
                    admitted_s=self._slot_admitted[i],
                    finished_s=now,
                ))
                self._active[i] = False
                self._slot_req[i] = None
