"""Discrete-event cluster simulator for decentralized training (the port of
``repro.sim.runner``).

Drives any algorithm from :mod:`repro_torch.core.optimizers` in the stacked
layout under a virtual cluster: per-node clocks (:mod:`.clock`), scenario
schedules (:mod:`.events`), stale neighbor snapshots, and fail-stop
recovery through :func:`repro_torch.launch.elastic.plan_recovery` +
``Topology.exclude``.

Execution model (the *virtual stacked step*): when node ``i`` completes its
``k``-th optimizer step, the engine assembles a virtual stacked state whose
row ``j`` is the last snapshot of node ``j`` *visible* to ``i`` when the
step started (publication time + link delay <= start time), runs the same
stacked step as :func:`repro_torch.core.reference.run_stacked`, and keeps
only row ``i`` of the result.  Under equal constant speeds, zero link delay
and no events, every virtual state equals the true synchronous state, so
the simulation equals ``run_stacked`` bit for bit.

Staleness is bounded SSP-style with version-capped reads: a node may not
*start* a step that would put it more than ``scenario.max_staleness`` steps
ahead of any alive in-neighbor (it stalls instead, and stall time is
recorded), and a reader at step ``k`` never consumes a neighbor payload
newer than version ``k``.  ``max_staleness=1`` is therefore exactly
version-synchronous BSP.

Two event-loop strategies execute this model (``SimSpec.engine``):
``"pernode"`` — this module, one popped completion event and one stacked
step at a time (the reference implementation) — and ``"vectorized"``
(``"auto"``, :mod:`.vectorized`), which shares one step among same-time
completions with identical views.  The two agree bit for bit.

The schedule (which node steps when, stall times, version gaps, events) is
host-side numpy and equals the reference's for the same seed and scenario;
only the iterates differ, by f32 rounding.  Tensors are never updated in
place here: a mailbox holds rows of the state as it was published.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..core.gossip import DelayedStackedChannel, StackedChannel, make_stacked_mean
from ..core.optimizers import Optimizer
from ..core.reference import consensus_distance
from ..core.topology import Topology, build_topology
from ..launch.elastic import plan_recovery
from ..utils import tree_leaves, tree_map, tree_unflatten
from .clock import EventQueue, node_rngs
from .events import FailStop, LinkDegrade, Rejoin, Scenario, Slowdown, get_scenario
from .metrics import SimResult
from .spec import SimSpec

Tree = Any
GradFn = Callable[[Tree, Any], Tree]

__all__ = ["SimSpec", "simulate"]


def _row(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


def _set_row(tree: Tree, i: int, row: Tree) -> Tree:
    """A copy of ``tree`` with row ``i`` replaced (out of place)."""

    def put(a, r):
        out = a.clone()
        out[i] = r
        return out

    return tree_map(put, tree, row)


def _stack_rows(rows: list[Tree]) -> Tree:
    return tree_map(lambda *r: torch.stack(r), *rows)


def _take_rows(tree: Tree, idx) -> Tree:
    return tree_map(lambda a: a[torch.as_tensor(idx, dtype=torch.long, device=a.device)], tree)


def _mean_rows(tree: Tree, idx: list[int]) -> Tree:
    """f32 mean over the listed rows (consensus collapse)."""
    return tree_map(lambda a: torch.mean(a.to(torch.float32), dim=0).to(a.dtype),
                    _take_rows(tree, idx))


def _first_leaf(tree: Tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def _device(tree: Tree) -> torch.device:
    return _first_leaf(tree).device


def _make_step(opt: Optimizer, topology: Topology, grad_fn: GradFn, lr_fn, spec) -> tuple:
    """The stacked one-step — the computation of ``run_stacked``.

    ``node_gaps`` is the per-node snapshot-version staleness of the virtual
    stacked state (zeros under lockstep): the event engine observes
    staleness out of band (mailbox versions), so it hands the gaps to the
    step explicitly rather than through a delayed channel — staleness-aware
    algorithms (``decentlam-sa``) damp on it, everything else ignores it.

    ``spec.compression`` encodes/decodes every node's payload around the
    mix; the channel state — error-feedback residuals for top-k — is
    threaded per node exactly like the optimizer state.  ``None`` keeps the
    channel stateless and ``chstate`` an empty dict.

    ``spec.sparse`` swaps in a :class:`~repro_torch.sparse.channel.
    SparseStackedChannel` and marks each node's touched rows from its
    gradient support before the mix; the row masks live in ``chstate``
    with every leaf leading-n, so the event engines thread them per node
    like error-feedback residuals (a node's mask rides its snapshot).
    """
    if spec.sparse:
        from ..sparse import SparseStackedChannel, grad_row_masks

        channel = SparseStackedChannel(topology, mode=spec.sparse,
                                       crossover=spec.sparse_crossover,
                                       calls_per_step=opt.gossips_per_step,
                                       compression=spec.compression)
        mark = lambda ch, g: channel.mark(ch, grad_row_masks(g))  # noqa: E731
    else:
        channel = StackedChannel(topology, compression=spec.compression)
        mark = lambda ch, g: ch  # noqa: E731
    mean = make_stacked_mean(topology.n)

    def one(params, state, chstate, step: int, node_gaps: np.ndarray):
        grads = grad_fn(params, step)
        dev = _device(params)
        chstate = mark(chstate, grads)
        with torch.no_grad():
            return opt.step(
                params, grads, state,
                lr=torch.as_tensor(lr_fn(step), dtype=torch.float32, device=dev),
                step_idx=step, gossip=channel, mean=mean, comp_state=chstate,
                node_gaps=torch.as_tensor(node_gaps, dtype=torch.int32, device=dev),
            )

    return one, channel


def _in_neighbors(topology: Topology) -> list[set[int]]:
    """Union over period phases of each node's gossip in-edges — the dense
    *reference* computation (scans every ``W(t)`` row); the engines use the
    sparse equivalent ``Topology.in_neighbors()``."""
    nbrs: list[set[int]] = [set() for _ in range(topology.n)]
    for t in range(topology.period):
        W = topology.W(t)
        for i in range(topology.n):
            for j in np.nonzero(np.abs(W[i]) > 0)[0]:
                if j != i:
                    nbrs[i].add(int(j))
    return nbrs


def _new_mailboxes(n: int, depth: int) -> list[deque]:
    """Per-node snapshot mailboxes: bounded deques, oldest first.  Each entry
    is ``(version, pub_time, x_row, state_row, chstate_row)``; ``maxlen``
    keeps exactly the last ``depth`` snapshots."""
    return [deque(maxlen=depth) for _ in range(n)]


def _visible(box, deadline: float, version_cap: int):
    """Latest snapshot in ``box`` published by ``deadline`` whose version is
    <= ``version_cap`` (else the oldest retained): SSP parameter-server
    semantics, so ``max_staleness=1`` is version-synchronous BSP."""
    for snap in reversed(box):
        if snap[1] <= deadline and snap[0] <= version_cap:
            return snap
    return box[0]


class _DeltaMailbox:
    """Row-delta codec for the pernode engine's snapshot parameter payloads
    (the reference's, for its row-sparse mode).

    A published parameter snapshot is stored as the rows (leaf axis 0)
    changed since the node's *pinned base* snapshot, not as a full copy.
    Decode is bit-exact: the pinned base with the changed rows overwritten.
    A node re-pins (stores a full snapshot) whenever its changed-row
    fraction reaches ``crossover``, so delta chains never form; older bases
    are pruned past ``depth + 1``.  ``dense_bytes`` / ``actual_bytes``
    account what always-full mailboxes would have stored vs what this codec
    stored (4 bytes per shipped row index).  Leaves are host numpy arrays.
    """

    def __init__(self, n: int, depth: int, crossover: float):
        self.depth = depth
        self.crossover = crossover
        self.bases: list[dict[int, list]] = [{} for _ in range(n)]
        self.cur_bid: list[int | None] = [None] * n
        self.next_bid = 0
        self.like = None
        self.dense_bytes = 0.0
        self.actual_bytes = 0.0

    def reset(self, n: int) -> None:
        """Drop every pinned base (rescale restart: mailboxes are fresh)."""
        self.bases = [{} for _ in range(n)]
        self.cur_bid = [None] * n

    def _leaves(self, row: Tree) -> list[np.ndarray]:
        if self.like is None:
            self.like = row
        return [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                for v in tree_leaves(row)]

    def _pin(self, i: int, leaves: list) -> tuple:
        bid = self.next_bid
        self.next_bid += 1
        self.bases[i][bid] = leaves
        while len(self.bases[i]) > self.depth + 1:
            self.bases[i].pop(next(iter(self.bases[i])))
        self.cur_bid[i] = bid
        return ("full", leaves)

    def encode(self, i: int, row: Tree) -> tuple:
        leaves = self._leaves(row)
        dense = float(sum(v.nbytes for v in leaves))
        self.dense_bytes += dense
        bid = self.cur_bid[i]
        if bid is not None:
            base = self.bases[i][bid]
            deltas, actual, changed, total = [], 0.0, 0, 0
            for b, v in zip(base, leaves):
                if v.ndim == 0:  # scalar leaf: always shipped raw
                    deltas.append((None, v))
                    actual += v.nbytes
                    changed += int(v != b)
                    total += 1
                    continue
                diff = v != b
                if v.ndim > 1:
                    diff = diff.any(axis=tuple(range(1, v.ndim)))
                idx = np.nonzero(diff)[0].astype(np.int32)
                deltas.append((idx, v[idx]))
                actual += v[idx].nbytes + 4.0 * idx.size
                changed += int(idx.size)
                total += v.shape[0]
            if changed < self.crossover * max(total, 1):
                self.actual_bytes += min(actual, dense)
                return ("delta", bid, deltas)
        self.actual_bytes += dense
        return self._pin(i, leaves)

    def encode_full(self, i: int, row: Tree) -> tuple:
        """Force a full publish + re-pin (rejoin backfill), accounted once."""
        leaves = self._leaves(row)
        dense = float(sum(v.nbytes for v in leaves))
        self.dense_bytes += dense
        self.actual_bytes += dense
        return self._pin(i, leaves)

    def decode(self, i: int, enc: tuple) -> Tree:
        if enc[0] == "full":
            return tree_unflatten(self.like, enc[1])
        _, bid, deltas = enc
        out = []
        for b, (idx, vals) in zip(self.bases[i][bid], deltas):
            if idx is None:
                out.append(vals)
            elif idx.size == 0:
                out.append(b)
            else:
                v = b.copy()
                v[idx] = vals
                out.append(v)
        return tree_unflatten(self.like, out)


def _comm_summary(spec: SimSpec, chstate: Tree, codec=None) -> dict | None:
    """``SimResult.comm`` from a row-sparse channel's volume counters and the
    mailbox codec's totals; ``None`` for dense gossip."""
    if not spec.sparse:
        return None
    vol = tree_map(lambda a: a.detach().cpu().numpy(), chstate["rows"]["vol"])
    out = {
        "wire_sparse_bytes": float(np.sum(vol["sparse"])),
        "wire_dense_bytes": float(np.sum(vol["dense"])),
        "gossip_rounds": int(np.sum(vol["rounds"])),
    }
    if codec is not None:
        out["mailbox_bytes"] = float(codec.actual_bytes)
        out["mailbox_dense_bytes"] = float(codec.dense_bytes)
    return out


def simulate(opt: Optimizer, spec, *args, **kwargs) -> SimResult:
    """Run one scenario; terminates when every alive node has completed
    ``spec.n_steps`` steps (fast nodes may have done more).

    The signature is ``simulate(opt, spec, params0, grad_fn)`` with a
    :class:`SimSpec` carrying everything else.  The iterates live on
    ``params0``'s device.
    """
    if not isinstance(spec, SimSpec):
        raise TypeError(
            "simulate(opt, spec, params0, grad_fn) requires a repro_torch.sim."
            f"SimSpec as its second argument, got {type(spec).__name__}"
        )
    if kwargs or len(args) != 2:
        raise TypeError(
            "simulate(opt, spec, params0, grad_fn) takes exactly four "
            "arguments when called with a SimSpec"
        )
    params0, grad_fn = args
    scenario = spec.scenario
    if scenario is None:
        scenario = get_scenario("homogeneous", spec.n, spec.n_steps)
    elif isinstance(scenario, str):
        scenario = get_scenario(scenario, spec.n, spec.n_steps)
    lr = spec.lr
    lr_fn = lr if callable(lr) else (lambda _s, _v=float(lr): _v)

    if scenario.engine == "delayed":
        return _run_delayed_engine(opt, spec, params0, grad_fn, lr_fn, scenario)
    if spec.engine == "pernode":
        return _run_event_pernode(opt, spec, params0, grad_fn, lr_fn, scenario)
    from .vectorized import run_event_vectorized

    return run_event_vectorized(opt, spec, params0, grad_fn, lr_fn, scenario)


def _run_event_pernode(
    opt: Optimizer, spec: SimSpec, params0: Tree, grad_fn: GradFn, lr_fn,
    scenario: Scenario,
) -> SimResult:
    """The reference event loop: one completion event, one stacked step."""
    n = spec.n
    n_steps = spec.n_steps
    metric_fn = spec.metric_fn
    restrict = spec.restrict
    record_dt = spec.record_dt
    topology_ref = spec.topology

    base_topology = build_topology(topology_ref, n)
    topo = base_topology
    one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
    nbrs = topo.in_neighbors()

    x = params0
    state = opt.init(params0)
    chstate = channel.init(params0)  # {} unless the compressor is stateful
    n_cur = n
    steps = np.zeros(n, dtype=np.int64)
    stall = np.zeros(n, dtype=np.float64)
    speed_scale = np.ones(n, dtype=np.float64)
    # sparse per-edge extra latency: only LinkDegrade-touched edges appear
    link_delay: dict[tuple[int, int], float] = {}
    rngs = node_rngs(spec.seed, n)
    durations = scenario.duration_models(n)
    dead: set[int] = set()
    kept_indices = tuple(range(n))
    recovery_mode = "none"
    rescaled = False

    depth = scenario.max_staleness + 4
    mailbox = _new_mailboxes(n, depth)
    codec = _DeltaMailbox(n, depth, spec.sparse_crossover) if spec.sparse else None
    events_log: list[dict] = []
    trace: list[dict] = []
    next_record = record_dt if record_dt > 0 else None

    def publish(i: int, t: float) -> None:
        row_x = _row(x, i)
        if codec is not None:
            row_x = codec.encode(i, row_x)
        mailbox[i].append(
            (int(steps[i]), t, row_x, _row(state, i), _row(chstate, i))
        )

    def alive_nodes() -> list[int]:
        return [i for i in range(n_cur) if i not in dead]

    def blocked_by(i: int) -> list[int]:
        """Alive in-neighbors too far behind for ``i`` to start its next step."""
        horizon = steps[i] + 1 - scenario.max_staleness
        return [j for j in nbrs[i] if j not in dead and steps[j] < horizon]

    queue = EventQueue()
    start_time = np.zeros(n, dtype=np.float64)
    # per-node epoch: bumped on fail-stop so a dead node's still-queued
    # completion event cannot double-schedule it after a rejoin
    epoch = np.zeros(n, dtype=np.int64)
    waiting: dict[int, float] = {}  # node -> time it became ready-but-blocked

    def schedule(i: int, now: float) -> None:
        if blocked_by(i):
            waiting[i] = now
            return
        dur = durations[i](i, int(steps[i]), rngs[i]) * speed_scale[i]
        assert dur > 0.0, f"step durations must be positive (node {i}: {dur})"
        start_time[i] = now
        queue.push(now + dur, i, int(epoch[i]))

    def release_waiting(now: float) -> None:
        for i in sorted(waiting):
            if i in dead:
                del waiting[i]
                continue
            if not blocked_by(i):
                stall[i] += now - waiting.pop(i)
                schedule(i, now)

    def record(t: float) -> None:
        alive = alive_nodes()
        xa = _take_rows(x, alive)
        entry = {
            "t": round(t, 6),
            "min_step": int(steps[alive].min()),
            "max_step": int(steps[alive].max()),
            "consensus": float(consensus_distance(_first_leaf(xa))),
        }
        if metric_fn is not None:
            entry["metric"] = float(metric_fn(xa))
        trace.append(entry)

    # ---- scenario event application --------------------------------------
    pending = [
        e for _, e in sorted(enumerate(scenario.events), key=lambda p: (p[1].at_step, p[0]))
    ]
    ev_ptr = 0

    def apply_events(t: float) -> None:
        nonlocal ev_ptr, topo, one, channel, nbrs, dead, recovery_mode, rescaled
        nonlocal x, state, chstate, n_cur, steps, stall, speed_scale, link_delay
        nonlocal rngs, durations, mailbox, grad_fn
        while ev_ptr < len(pending):
            ev = pending[ev_ptr]
            alive = alive_nodes()
            if not alive or int(steps[alive].max()) < ev.at_step:
                return
            ev_ptr += 1
            if rescaled and isinstance(ev, (FailStop, Rejoin)):
                raise NotImplementedError(
                    "membership events after a rescale recovery are not "
                    "supported (node identities changed)"
                )
            if isinstance(ev, Slowdown):
                for i in ev.nodes:
                    if i < n_cur:
                        speed_scale[i] *= ev.factor
                events_log.append({"t": t, "event": f"slowdown{ev.nodes}x{ev.factor}"})
            elif isinstance(ev, LinkDegrade):
                for (u, v) in ev.edges:
                    if u < n_cur and v < n_cur:
                        link_delay[(u, v)] = link_delay[(v, u)] = ev.delay
                events_log.append({"t": t, "event": f"link_degrade{ev.edges}+{ev.delay}"})
            elif isinstance(ev, FailStop):
                dead |= set(int(d) for d in ev.nodes)
                for d in ev.nodes:
                    waiting.pop(int(d), None)
                    if int(d) < n_cur:
                        epoch[int(d)] += 1  # invalidate any queued completion
                plan = plan_recovery(topology_ref, n_cur, sorted(dead))
                recovery_mode = plan.mode
                events_log.append(
                    {"t": t, "event": f"failstop{tuple(sorted(ev.nodes))}->{plan.mode}"}
                )
                if plan.mode == "reroute":
                    topo = plan.topology
                    one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
                    nbrs = topo.in_neighbors()
                else:
                    _rescale(plan, t)
            elif isinstance(ev, Rejoin):
                back = [int(i) for i in ev.nodes if int(i) in dead]
                if not back:
                    continue
                alive = alive_nodes()
                xbar = _mean_rows(x, alive)
                sbar = _mean_rows(state, alive)
                sync_step = int(steps[alive].max())
                min_alive = int(steps[alive].min())
                for i in back:
                    dead.discard(i)
                    x = _set_row(x, i, xbar)
                    state = _set_row(state, i, sbar)
                    # error-feedback residuals do not survive re-entry
                    chstate = _set_row(chstate, i, tree_map(torch.zeros_like,
                                                            _row(chstate, i)))
                    steps[i] = sync_step
                    # backfill the consensus row under every version a
                    # lagging reader may request (the SSP read invariant
                    # holds across re-entry)
                    row_x, row_s, row_c = _row(x, i), _row(state, i), _row(chstate, i)
                    if codec is not None:
                        row_x = codec.encode_full(i, row_x)
                    mailbox[i] = deque(
                        ((v, t, row_x, row_s, row_c)
                         for v in range(max(0, min(min_alive, sync_step)), sync_step + 1)),
                        maxlen=depth,
                    )
                plan = plan_recovery(topology_ref, n_cur, sorted(dead)) if dead else None
                topo = plan.topology if plan else base_topology
                recovery_mode = plan.mode if plan else "reroute"
                one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
                nbrs = topo.in_neighbors()
                events_log.append({"t": t, "event": f"rejoin{tuple(back)}"})
                for i in back:
                    schedule(i, t)
            release_waiting(t)

    def _rescale(plan, t: float) -> None:
        nonlocal topo, one, channel, nbrs, dead, rescaled, x, state, chstate
        nonlocal n_cur, steps, stall, speed_scale, link_delay, rngs, durations
        nonlocal mailbox, grad_fn, kept_indices
        if restrict is None:
            raise ValueError(
                f"scenario requires a rescale to n={plan.n_nodes} but no "
                "`restrict` callback was given to rebuild grad_fn for the "
                "surviving nodes"
            )
        survivors = [i for i in range(n_cur) if i not in dead]
        kept = survivors[: plan.n_nodes]
        new_n = plan.n_nodes
        # consensus-collapse the alive replicas, broadcast to the new cluster
        xbar = _mean_rows(x, survivors)
        sbar = _mean_rows(state, survivors)
        x = _stack_rows([xbar] * new_n)
        state = _stack_rows([sbar] * new_n)
        # checkpoint-restore semantics: fresh (zero) channel state
        chstate = tree_map(lambda a: a.new_zeros((new_n,) + tuple(a.shape[1:])), chstate)
        sync_step = int(steps[survivors].max())
        steps = np.full(new_n, sync_step, dtype=np.int64)
        stall = stall[kept].copy()
        speed_scale = speed_scale[kept].copy()
        link_delay = {}
        epoch[:new_n] = epoch[kept] + 1  # queue was drained; invalidate stale pushes
        rngs = [rngs[i] for i in kept]
        durations = [durations[i] for i in kept]
        dead = set()
        rescaled = True
        n_cur = new_n
        kept_indices = tuple(kept_indices[i] for i in kept)
        grad_fn = restrict(kept_indices)
        topo = plan.topology
        one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
        nbrs = topo.in_neighbors()
        mailbox[:] = _new_mailboxes(new_n, depth)
        if codec is not None:
            codec.reset(new_n)
        waiting.clear()
        # drop every pending completion (the collapse is a sync barrier)
        while queue:
            queue.pop()
        for i in range(new_n):
            publish(i, t)
            schedule(i, t)

    # ---- main loop -------------------------------------------------------
    t = 0.0
    for i in range(n):
        publish(i, 0.0)
    for i in range(n):
        schedule(i, 0.0)

    while True:
        alive = alive_nodes()
        if alive and steps[alive].min() >= n_steps:
            break
        if not queue:
            if waiting:
                raise RuntimeError(f"deadlock: all runnable nodes waiting: {waiting}")
            break
        t, i, tag = queue.pop()
        if i in dead or i >= n_cur or tag != epoch[i]:
            continue  # stale event from before a failure/rejoin/rescale

        # assemble the virtual stacked state as seen from node i
        st = start_time[i]
        rows_x, rows_s, rows_c = [], [], []
        vers = np.zeros(n_cur, dtype=np.int64)
        for j in range(n_cur):
            if j == i:
                rows_x.append(_row(x, i))
                rows_s.append(_row(state, i))
                rows_c.append(_row(chstate, i))
                vers[j] = steps[i]
            else:
                snap = _visible(mailbox[j], st - link_delay.get((j, i), 0.0), int(steps[i]))
                rows_x.append(snap[2] if codec is None else tree_map(
                    lambda a: torch.as_tensor(a, device=_device(x)), codec.decode(j, snap[2])))
                rows_s.append(snap[3])
                rows_c.append(snap[4])
                vers[j] = snap[0]
        xv = _stack_rows(rows_x)
        sv = _stack_rows(rows_s)
        cv = _stack_rows(rows_c)

        # per-node version gap of this virtual state: the worst incident-
        # edge gap, both directions — snapshots this row consumed stale
        # (vers[r] - vers[j]) and how stale the node's readers consumed it
        # (steps[j] - 1 - vers[r]; exactly 0 in lockstep)
        gaps = np.zeros(n_cur, dtype=np.int64)
        for r in range(n_cur):
            for j in nbrs[r]:
                if j < n_cur and j not in dead:
                    gaps[r] = max(gaps[r], vers[r] - vers[j], int(steps[j]) - 1 - vers[r])

        pv, nv, ncv = one(xv, sv, cv, int(steps[i]), gaps)
        x = _set_row(x, i, _row(pv, i))
        state = _set_row(state, i, _row(nv, i))
        chstate = _set_row(chstate, i, _row(ncv, i))
        steps[i] += 1
        publish(i, t)

        if next_record is not None and t >= next_record:
            record(t)
            while next_record <= t:
                next_record += record_dt

        n_before = n_cur
        apply_events(t)
        if n_cur == n_before and i not in dead:
            # a rescale barrier (n shrinks) already rescheduled every node
            schedule(i, t)
        release_waiting(t)

    # nodes still SSP-blocked when the run terminates have been stalling
    # since they last became ready — flush that tail into the accounting
    for w, since in waiting.items():
        if w not in dead:
            stall[w] += t - since
    waiting.clear()

    return _result(spec, x, state, chstate, steps, stall, t, n_cur, recovery_mode, dead,
                   kept_indices, trace, events_log, alive_nodes(), next_record, record,
                   codec)


def _result(spec, x, state, chstate, steps, stall, t, n_cur, recovery_mode, dead,
            kept_indices, trace, events_log, alive, next_record, record,
            codec=None) -> SimResult:
    """The final metric, consensus and record of an event engine's run."""
    xa = _take_rows(x, alive)
    final_metric = float(spec.metric_fn(xa)) if spec.metric_fn is not None else None
    final_consensus = float(consensus_distance(_first_leaf(xa)))
    if next_record is not None:
        # the final snapshot supersedes a periodic record at the same instant
        if trace and trace[-1]["t"] == round(t, 6):
            trace.pop()
        record(t)
    return SimResult(
        params=x,
        opt_state=state,
        steps=steps.copy(),
        stall_time=stall.copy(),
        sim_time=float(t),
        n_nodes=n_cur,
        n_start=spec.n,
        target_steps=spec.n_steps,
        recovery_mode=recovery_mode,
        dead=tuple(sorted(dead)),
        kept=kept_indices,
        trace=trace,
        events_log=events_log,
        final_metric=final_metric,
        final_consensus=final_consensus,
        comm=_comm_summary(spec, chstate, codec),
    )


def _run_delayed_engine(opt, spec: SimSpec, params0, grad_fn, lr_fn, scenario) -> SimResult:
    """Synchronous bounded-staleness rounds (``engine="delayed"``)."""
    n = spec.n
    n_steps = spec.n_steps
    metric_fn = spec.metric_fn
    record_dt = spec.record_dt
    topology = build_topology(spec.topology, n)
    if spec.sparse:
        # exact-mode sparse composes with the delay ring (delta raises in the
        # constructor); the stationarity it needs (zero weight decay) is the
        # optimizer's, documented at the channel
        from ..sparse import SparseStackedChannel, grad_row_masks

        channel = SparseStackedChannel(
            topology, scenario.gossip_delay, mode=spec.sparse,
            crossover=spec.sparse_crossover, calls_per_step=opt.gossips_per_step,
            compression=spec.compression,
        )
        mark = lambda ch, g: channel.mark(ch, grad_row_masks(g))  # noqa: E731
    else:
        channel = DelayedStackedChannel(
            topology, scenario.gossip_delay, calls_per_step=opt.gossips_per_step,
            compression=spec.compression,
        )
        mark = lambda ch, g: ch  # noqa: E731
    mean = make_stacked_mean(n)
    chstate = channel.init(params0)
    state = opt.init(params0)
    dev = _device(params0)

    trace: list[dict] = []
    every = max(1, int(record_dt)) if record_dt > 0 else 0
    params = params0
    for k in range(n_steps):
        grads = grad_fn(params, k)
        chstate = mark(chstate, grads)
        with torch.no_grad():
            params, state, chstate = opt.step(
                params, grads, state,
                lr=torch.as_tensor(lr_fn(k), dtype=torch.float32, device=dev),
                step_idx=k, gossip=channel, mean=mean, comp_state=chstate,
            )
        if every and (k % every == 0 or k == n_steps - 1):
            entry = {
                "t": float(k + 1),
                "min_step": k + 1,
                "max_step": k + 1,
                "consensus": float(consensus_distance(_first_leaf(params))),
                # per-edge version gap: a first-class channel observable
                "max_gap": int(np.max(np.asarray(channel.version_gaps(chstate)))),
            }
            if metric_fn is not None:
                entry["metric"] = float(metric_fn(params))
            trace.append(entry)

    return SimResult(
        params=params,
        opt_state=state,
        steps=np.full(n, n_steps, dtype=np.int64),
        stall_time=np.zeros(n),
        sim_time=float(n_steps),
        n_nodes=n,
        n_start=n,
        target_steps=n_steps,
        recovery_mode="none",
        dead=(),
        trace=trace,
        events_log=[],
        kept=tuple(range(n)),
        final_metric=(float(metric_fn(params)) if metric_fn is not None else None),
        final_consensus=float(consensus_distance(_first_leaf(params))),
        comm=_comm_summary(spec, chstate),
    )
