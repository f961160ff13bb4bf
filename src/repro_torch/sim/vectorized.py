"""Node-vectorized discrete-event engine (``SimSpec.engine="vectorized"``):
the port of ``repro.sim.vectorized``.

The per-node loop in :mod:`.runner` pays one mailbox scan, one O(n) row
assembly and one stacked step per *node-step*.  This engine runs the same
model node-batched:

1. **Same-time batches.**  All completion events sharing the next
   timestamp are popped together (FIFO order preserved).  Step durations
   are strictly positive, so every batch member's step *started* strictly
   before the batch time — publications made inside the batch are never
   visible to other members.  The compute is deferred and grouped while
   the bookkeeping (step counters, mailbox metadata, SSP blocking, stall
   accounting, RNG draws) is replayed sequentially in pop order with numpy
   — equal to the per-node loop's by construction.
2. **Ring mailboxes.**  Snapshot data lives in per-node ring buffers —
   leaves of shape ``(n, depth, ...)`` — with numpy ``(n, depth)``
   version/publication-time metadata; a virtual stacked state is one
   gather per leaf.
3. **Shared-view grouping.**  Batch members whose virtual views are
   identical — same snapshot selection, same step index, same staleness
   gaps — share ONE stacked step; each keeps its own output row.  Under
   lockstep an n-node round costs one step instead of n.

Snapshot selection is memoized per ``(start_time, version_cap,
link-delay-adjustment)`` key, and a memoized selection is replayed only
after checking it references no ring slot overwritten by an earlier
in-batch publication.

The live state and the rings are updated in place (nothing here keeps a
view of them: gathers copy), starting from a copy of ``params0``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core.reference import consensus_distance
from ..core.topology import build_topology
from ..launch.elastic import plan_recovery
from ..utils import tree_map
from .clock import EventQueue, node_rngs
from .events import FailStop, LinkDegrade, Rejoin, Scenario, Slowdown
from .metrics import SimResult
from .runner import (
    _first_leaf,
    _make_step,
    _mean_rows,
    _result,
    _row,
    _set_row,
    _stack_rows,
    _take_rows,
)
from .spec import SimSpec

Tree = Any
GradFn = Callable[[Tree, Any], Tree]

__all__ = ["run_event_vectorized"]

_EMPTY_VER = -1  # mb_ver value for an unused ring slot


def _ring_init(stacked: Tree, depth: int) -> Tree:
    """Ring buffers from stacked rows: slot 0 holds the initial snapshot."""

    def ring(a):
        r = a.new_zeros((a.shape[0], depth) + tuple(a.shape[1:]))
        r[:, 0] = a
        return r

    return tree_map(ring, stacked)


def _gather(ring: Tree, sel: np.ndarray) -> Tree:
    def take(r):
        rows = torch.arange(sel.shape[0], device=r.device)
        return r[rows, torch.as_tensor(sel, device=r.device)]

    return tree_map(take, ring)


def run_event_vectorized(
    opt, spec: SimSpec, params0: Tree, grad_fn: GradFn, lr_fn, scenario: Scenario,
) -> SimResult:
    n = spec.n
    n_steps = spec.n_steps
    metric_fn = spec.metric_fn
    restrict = spec.restrict
    record_dt = spec.record_dt
    topology_ref = spec.topology

    base_topology = build_topology(topology_ref, n)
    topo = base_topology
    one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)

    x = tree_map(torch.clone, params0)
    state = opt.init(params0)
    chstate = channel.init(params0)
    n_cur = n
    steps = np.zeros(n, dtype=np.int64)
    stall = np.zeros(n, dtype=np.float64)
    speed_scale = np.ones(n, dtype=np.float64)
    link_delay: dict[tuple[int, int], float] = {}
    rngs = node_rngs(spec.seed, n)
    durations = scenario.duration_models(n)
    dead: set[int] = set()
    kept_indices = tuple(range(n))
    recovery_mode = "none"
    rescaled = False

    depth = scenario.max_staleness + 4
    # ring metadata: within a node's live window, chronological order is
    # ascending version order, so "latest visible" is an argmax over versions
    mb_ver = np.full((n, depth), _EMPTY_VER, dtype=np.int64)
    mb_pub = np.full((n, depth), np.inf, dtype=np.float64)
    mb_count = np.zeros(n, dtype=np.int64)
    ring_x = _ring_init(x, depth)
    ring_s = _ring_init(state, depth)
    ring_c = _ring_init(chstate, depth)
    mb_ver[:, 0] = 0
    mb_pub[:, 0] = 0.0
    mb_count[:] = 1

    # sparse in-neighbor structures from the topology's edge classes
    nbrs = topo.in_neighbors()
    e_dst = np.zeros(0, dtype=np.int64)
    e_src = np.zeros(0, dtype=np.int64)

    def rebuild_edges() -> None:
        nonlocal e_dst, e_src
        dsts, srcs = [], []
        for r in range(n_cur):
            for j in nbrs[r]:
                if j < n_cur and j not in dead:
                    dsts.append(r)
                    srcs.append(j)
        e_dst = np.asarray(dsts, dtype=np.int64)
        e_src = np.asarray(srcs, dtype=np.int64)

    rebuild_edges()

    events_log: list[dict] = []
    trace: list[dict] = []
    next_record = record_dt if record_dt > 0 else None

    queue = EventQueue()
    start_time = np.zeros(n, dtype=np.float64)
    epoch = np.zeros(n, dtype=np.int64)
    waiting: dict[int, float] = {}

    def alive_nodes() -> list[int]:
        return [i for i in range(n_cur) if i not in dead]

    def blocked_by(i: int) -> list[int]:
        horizon = steps[i] + 1 - scenario.max_staleness
        return [j for j in nbrs[i] if j not in dead and steps[j] < horizon]

    def schedule(i: int, now: float) -> None:
        if blocked_by(i):
            waiting[i] = now
            return
        dur = durations[i](i, int(steps[i]), rngs[i]) * speed_scale[i]
        assert dur > 0.0, f"step durations must be positive (node {i}: {dur})"
        start_time[i] = now
        queue.push(now + dur, i, int(epoch[i]))

    def release_waiting(now: float) -> None:
        # node i is releasable iff min over alive in-neighbors of steps[j]
        # >= steps[i] + 1 - max_staleness: one scatter-min over the edges;
        # release order stays sorted(waiting)
        if not waiting:
            return
        order = sorted(waiting)
        for i in order:
            if i in dead:
                del waiting[i]
        if not waiting:
            return
        min_nb = np.full(n_cur, np.iinfo(np.int64).max, dtype=np.int64)
        if e_dst.size:
            np.minimum.at(min_nb, e_dst, steps[e_src])
        horizon = steps[:n_cur] + 1 - scenario.max_staleness
        for i in order:
            if i in waiting and min_nb[i] >= horizon[i]:
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

    # ---- snapshot publication (metadata now, data at flush) --------------
    def publish_meta(i: int, t: float) -> tuple[int, bool]:
        slot = int(mb_count[i] % depth)
        evicted = mb_count[i] >= depth
        mb_ver[i, slot] = steps[i]
        mb_pub[i, slot] = t
        mb_count[i] += 1
        return slot, bool(evicted)

    # ---- snapshot selection ----------------------------------------------
    def select(st: float, cap: int, adj: tuple) -> tuple[np.ndarray, np.ndarray]:
        """Per-source ring slot of the latest snapshot published by the
        reader's deadline with version <= cap, else the oldest retained."""
        ver = mb_ver[:n_cur]
        pub = mb_pub[:n_cur]
        deadline = np.full(n_cur, st)
        for u, d in adj:
            deadline[u] = st - d
        ok = (pub <= deadline[:, None]) & (ver <= cap) & (ver > _EMPTY_VER)
        has = ok.any(axis=1)
        best = np.where(ok, ver, _EMPTY_VER).argmax(axis=1)
        oldest = np.where(ver > _EMPTY_VER, ver, np.iinfo(np.int64).max).argmin(axis=1)
        sel = np.where(has, best, oldest).astype(np.int64)
        vers = ver[np.arange(n_cur), sel]
        return sel, vers

    # ---- batch state ------------------------------------------------------
    groups: dict = {}
    memo: dict = {}
    ov_nodes = np.zeros(n, dtype=np.int64)  # ring slots overwritten this batch
    ov_slots = np.zeros(n, dtype=np.int64)
    ov_cnt = 0

    def flush() -> None:
        """One stacked step per view-group; each member's own output row
        into the live state and its published ring slot.  All gathers
        happen before any scatter: an early member may reference a slot a
        later member's publication evicts."""
        nonlocal groups
        if not groups:
            return
        runs = []
        for g in groups.values():
            sel, gaps, step_idx, members, slots = (
                g["sel"], g["gaps"], g["step"], g["members"], g["slots"],
            )
            xv, sv, cv = _gather(ring_x, sel), _gather(ring_s, sel), _gather(ring_c, sel)
            runs.append((members, slots, one(xv, sv, cv, step_idx, gaps)))
        for members, slots, outs in runs:
            for live, ring, out in zip((x, state, chstate), (ring_x, ring_s, ring_c), outs):
                def put(a, r, p):
                    m = torch.as_tensor(members, dtype=torch.long, device=a.device)
                    s = torch.as_tensor(slots, dtype=torch.long, device=a.device)
                    a[m] = p[m]
                    r[m, s] = p[m]

                tree_map(put, live, ring, out)
        groups = {}

    def republish_row(i: int, t: float, versions: list[int]) -> None:
        """Reset node ``i``'s ring to its *current* live row under each of
        ``versions`` (rejoin backfill), keeping the newest ``depth``."""
        versions = versions[-depth:]
        k = len(versions)
        assert 0 < k <= depth, (k, depth)
        mb_ver[i] = _EMPTY_VER
        mb_pub[i] = np.inf
        mb_ver[i, :k] = np.asarray(versions)
        mb_pub[i, :k] = t
        mb_count[i] = k

        def fill(r, row):
            r[i, :k] = row

        for ring, live in ((ring_x, x), (ring_s, state), (ring_c, chstate)):
            tree_map(fill, ring, _row(live, i))

    # ---- scenario event application --------------------------------------
    pending = [
        e for _, e in sorted(enumerate(scenario.events), key=lambda p: (p[1].at_step, p[0]))
    ]
    ev_ptr = 0

    def events_would_fire() -> bool:
        if ev_ptr >= len(pending):
            return False
        alive = alive_nodes()
        return bool(alive) and int(steps[alive].max()) >= pending[ev_ptr].at_step

    def apply_events(t: float) -> None:
        nonlocal ev_ptr, topo, one, channel, nbrs, dead, recovery_mode, rescaled
        nonlocal x, state, chstate, n_cur, steps, stall, speed_scale, link_delay
        nonlocal rngs, durations, grad_fn
        while ev_ptr < len(pending):
            ev = pending[ev_ptr]
            alive = alive_nodes()
            if not alive or int(steps[alive].max()) < ev.at_step:
                return
            ev_ptr += 1
            memo.clear()  # any event can change what a reader sees next
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
                        epoch[int(d)] += 1
                plan = plan_recovery(topology_ref, n_cur, sorted(dead))
                recovery_mode = plan.mode
                events_log.append(
                    {"t": t, "event": f"failstop{tuple(sorted(ev.nodes))}->{plan.mode}"}
                )
                if plan.mode == "reroute":
                    topo = plan.topology
                    one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
                    nbrs = topo.in_neighbors()
                    rebuild_edges()
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
                    chstate = _set_row(chstate, i, tree_map(torch.zeros_like,
                                                            _row(chstate, i)))
                    steps[i] = sync_step
                    republish_row(
                        i, t, list(range(max(0, min(min_alive, sync_step)), sync_step + 1)),
                    )
                plan = plan_recovery(topology_ref, n_cur, sorted(dead)) if dead else None
                topo = plan.topology if plan else base_topology
                recovery_mode = plan.mode if plan else "reroute"
                one, channel = _make_step(opt, topo, grad_fn, lr_fn, spec)
                nbrs = topo.in_neighbors()
                rebuild_edges()
                events_log.append({"t": t, "event": f"rejoin{tuple(back)}"})
                for i in back:
                    schedule(i, t)
            release_waiting(t)

    def _rescale(plan, t: float) -> None:
        nonlocal topo, one, channel, nbrs, dead, rescaled, x, state, chstate
        nonlocal n_cur, steps, stall, speed_scale, link_delay, rngs, durations
        nonlocal grad_fn, kept_indices, ring_x, ring_s, ring_c
        nonlocal mb_ver, mb_pub, mb_count
        if restrict is None:
            raise ValueError(
                f"scenario requires a rescale to n={plan.n_nodes} but no "
                "`restrict` callback was given to rebuild grad_fn for the "
                "surviving nodes"
            )
        survivors = [i for i in range(n_cur) if i not in dead]
        kept = survivors[: plan.n_nodes]
        new_n = plan.n_nodes
        xbar = _mean_rows(x, survivors)
        sbar = _mean_rows(state, survivors)
        x = _stack_rows([xbar] * new_n)
        state = _stack_rows([sbar] * new_n)
        chstate = tree_map(lambda a: a.new_zeros((new_n,) + tuple(a.shape[1:])), chstate)
        sync_step = int(steps[survivors].max())
        steps = np.full(new_n, sync_step, dtype=np.int64)
        stall = stall[kept].copy()
        speed_scale = speed_scale[kept].copy()
        link_delay = {}
        epoch[:new_n] = epoch[kept] + 1
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
        rebuild_edges()
        # fresh rings for the restarted cluster: slot 0 = the collapsed row
        mb_ver = np.full((new_n, depth), _EMPTY_VER, dtype=np.int64)
        mb_pub = np.full((new_n, depth), np.inf, dtype=np.float64)
        mb_count = np.zeros(new_n, dtype=np.int64)
        ring_x = _ring_init(x, depth)
        ring_s = _ring_init(state, depth)
        ring_c = _ring_init(chstate, depth)
        mb_ver[:, 0] = sync_step
        mb_pub[:, 0] = t
        mb_count[:] = 1
        waiting.clear()
        while queue:
            queue.pop()
        for i in range(new_n):
            schedule(i, t)

    # ---- main loop -------------------------------------------------------
    t = 0.0
    for i in range(n):
        schedule(i, 0.0)

    terminated = False
    while not terminated:
        alive = alive_nodes()
        if alive and steps[alive].min() >= n_steps:
            break
        if not queue:
            if waiting:
                raise RuntimeError(f"deadlock: all runnable nodes waiting: {waiting}")
            break
        t, i0, tag0 = queue.pop()
        batch = [(i0, tag0)]
        while queue and queue.peek_time() == t:
            _, node2, tag2 = queue.pop()
            batch.append((node2, tag2))

        memo.clear()
        ov_cnt = 0
        first = True
        for node, tag in batch:
            if not first:
                # the per-node loop re-checks termination before each pop
                alive = alive_nodes()
                if alive and steps[alive].min() >= n_steps:
                    terminated = True
                    break
            first = False
            if node in dead or node >= n_cur or tag != epoch[node]:
                continue

            st = float(start_time[node])
            cap = int(steps[node])
            adj = tuple(
                (u, d) for (u, v), d in sorted(link_delay.items()) if v == node and u < n_cur
            )
            key = (st, cap, adj)
            hit = memo.get(key)
            if hit is not None and not (
                ov_cnt and np.any(hit[0][ov_nodes[:ov_cnt]] == ov_slots[:ov_cnt])
            ):
                sel, vers = hit
            else:
                sel, vers = select(st, cap, adj)
                memo[key] = (sel, vers)

            gaps = np.zeros(n_cur, dtype=np.int64)
            if e_dst.size:
                term = np.maximum(vers[e_dst] - vers[e_src], steps[e_src] - 1 - vers[e_dst])
                np.maximum.at(gaps, e_dst, term)

            sig = (cap, sel.tobytes(), gaps.tobytes())
            g = groups.get(sig)
            if g is None:
                g = groups[sig] = {
                    "sel": sel, "gaps": gaps, "step": cap, "members": [], "slots": [],
                }
            g["members"].append(node)

            steps[node] += 1
            slot, evicted = publish_meta(node, t)
            g["slots"].append(slot)
            if evicted:
                ov_nodes[ov_cnt] = node
                ov_slots[ov_cnt] = slot
                ov_cnt += 1

            if next_record is not None and t >= next_record:
                flush()
                record(t)
                while next_record <= t:
                    next_record += record_dt

            n_before = n_cur
            if events_would_fire():
                flush()
                ov_cnt = 0  # rings rewritten below never alias batch reads
                apply_events(t)
            if n_cur == n_before and node not in dead:
                schedule(node, t)
            release_waiting(t)
        flush()

    flush()
    for w, since in waiting.items():
        if w not in dead:
            stall[w] += t - since
    waiting.clear()

    return _result(spec, x, state, chstate, steps, stall, t, n_cur, recovery_mode, dead,
                   kept_indices, trace, events_log, alive_nodes(), next_record, record)
