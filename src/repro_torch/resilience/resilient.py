"""Self-healing gossip mixing: redistribute lost weight, guard payloads
(``repro.resilience.resilient``).

DecentLaM's bias correction divides the momentum coupling by the learning
rate, so any deficiency in a mixing row (a row sum drifting below 1 when a
peer's payload goes missing) is amplified by ``1/lr`` into the update — the
W-stochasticity invariant is load-bearing.  :class:`ResilientChannel` wraps
any transport and keeps every round's effective mixing matrix row-stochastic
under faults:

* **dead-weight redistribution** — payloads of distrusted peers (the
  host-set :func:`with_trust` mask, typically driven by a
  :class:`~repro_torch.resilience.health.HealthMonitor`, optionally
  tightened by a ``suspect_gap`` bound on the inner channel's version gaps)
  are masked to zero before the inner mix, and the weight they would have
  carried is added back to the receiver's self-weight, from the
  topology's static per-phase edge tables.  The effective matrix is exactly
  :func:`healed_W`.
* **payload guards** — a node whose own payload goes non-finite publishes
  its last finite payload instead, and non-finite entries that still arrive
  in the mixed output are replaced elementwise by the receiver's own
  payload.  Both events count into ``quarantined``.

When every peer is trusted and every payload finite, the wrapper is
**bitwise transparent**: the trust mask and the version gaps are host
arrays in the port, so a clean round masks nothing and adds no healing
term, and the receiver guard leaves every (finite) mix as it is.  Each
guard reads its tensor once and costs one device-to-host read per round
(which nodes' payloads, and which mixes, hold a non-finite entry); only
the nodes found so are edited entry by entry.

Edits of the caller's payload (the last-good substitution, the masking of
distrusted senders) are made in place on the edited nodes' slices, which
are saved first and written back before ``apply`` returns, so the memory
cost is a node's slice per edited node, plus the last-good copy itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.gossip import GossipChannel, Tree
from ..core.topology import Topology
from ..utils import tree_leaves, tree_map
from .chaos import _restore, _Wrapper

__all__ = ["ResilientChannel", "healed_W", "with_trust"]


def _all_finite(t: torch.Tensor) -> torch.Tensor:
    """A 0-d bool: every entry of ``t`` finite, from one read of it (min and
    max carry a NaN or an infinity through)."""
    if t.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=t.device)
    lo, hi = torch.aminmax(t)
    return torch.isfinite(lo) & torch.isfinite(hi)


def healed_W(topology: Topology, t: int, alive) -> np.ndarray:
    """The effective mixing matrix one healed round applies (float64).

    Distrusted columns are zeroed, the lost weight moves to each surviving
    row's diagonal, and a distrusted row freezes to its own iterate
    (``e_i``).  Every row sums to 1 for any ``alive`` mask; with ``alive``
    all-true this is ``topology.W(t)``."""
    W = np.array(topology.W(t), dtype=np.float64)
    a = np.asarray(alive, bool)
    n = topology.n
    if a.shape != (n,):
        raise ValueError(f"alive mask must be ({n},), got {a.shape}")
    out = W.copy()
    for i in range(n):
        if not a[i]:
            out[i, :] = 0.0
            out[i, i] = 1.0
            continue
        lost = out[i, ~a].sum()
        out[i, ~a] = 0.0
        out[i, i] += lost
    return out


def with_trust(state: Tree, trust) -> Tree:
    """``state`` with the resilient wrapper's trust mask replaced (host-side).

    Accepts the stacked channel state (``trust`` ``(n,)``), a rank's
    (``(1, n)``) or a gathered one (``(n_nodes, n)``): the mask broadcasts
    over the leading axes."""
    if not (isinstance(state, dict) and "res" in state):
        raise ValueError(
            "with_trust expects a ResilientChannel state (a dict with a "
            f"'res' bucket), got keys {list(state) if isinstance(state, dict) else type(state)}")
    res = dict(state["res"])
    old = res["trust"]
    mask = torch.from_numpy(np.asarray(trust, bool).copy())
    if tuple(mask.shape) != tuple(old.shape[old.ndim - 1:]):
        raise ValueError(f"trust mask shape {tuple(mask.shape)} does not match state "
                         f"{tuple(old.shape)}")
    res["trust"] = mask.expand(old.shape).clone()
    return {**state, "res": res}


class ResilientChannel(_Wrapper):
    """Self-healing, payload-guarded wrapper around any gossip transport.

    State nests the inner channel under ``"in"`` and the resilience
    bookkeeping under ``"res"``: the host ``trust`` mask (``(n,)`` bool), a
    ``quarantined`` event counter per node (on the payload's device), and,
    with ``last_good=True``, the node's last finite payload (``lg``, f32)
    and its validity flag (``lg_ok``, host).  On a rank each leaf has a
    leading axis of 1.

    ``suspect_gap`` (optional) also distrusts any sender whose payload the
    inner channel reports at a version gap above the bound, in the round it
    goes quiet, before the host's health monitor reacts.
    """

    name = "resilient"

    def __init__(self, inner: GossipChannel, *, suspect_gap: int | None = None,
                 last_good: bool = True, guard: bool = True):
        self._wrap(inner)
        if suspect_gap is not None and suspect_gap < 0:
            raise ValueError("suspect_gap must be >= 0")
        self._suspect_gap = suspect_gap
        self._last_good = bool(guard and last_good)
        self._guard = bool(guard)
        # static per-phase edge tables: receiver i loses sum_j W[i, j] *
        # (1 - alive[j]) over its in-edges
        self._lost_tables = []
        for t in range(self.topology.period):
            src, dst, w = [], [], []
            for c in self.topology.edge_classes(t):
                rw = np.asarray(c.recv_weight, np.float32)
                for s, d in c.pairs:
                    src.append(int(s))
                    dst.append(int(d))
                    w.append(rw[int(d)])
            self._lost_tables.append((np.asarray(src, np.int64), np.asarray(dst, np.int64),
                                      np.asarray(w, np.float32)))

    def init(self, template: Tree) -> dict:
        n = self.topology.n
        dev = tree_leaves(template)[0].device
        nloc = (n,) if self._stacked_layout else (1,)
        res: dict = {
            "trust": self._host((n,), torch.bool).fill_(True),
            "quarantined": torch.zeros(nloc, dtype=torch.int32, device=dev),
        }
        if self._last_good:
            res["lg"] = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                                       device=a.device), template)
            res["lg_ok"] = torch.zeros(nloc, dtype=torch.bool)
        return {"in": self.inner.init(template), "res": res}

    def has_staleness(self) -> bool:
        return self.inner.has_staleness()

    def version_gaps(self, state: Tree) -> np.ndarray:
        return self.inner.version_gaps(state["in"])

    def lost_weight(self, step: int, alive: np.ndarray) -> np.ndarray:
        """``(n,)`` f32: the mixing weight each receiver loses to distrusted
        senders in the phase of ``step`` (summed in edge-table order)."""
        src, dst, w = self._lost_tables[int(step) % self.topology.period]
        lost = np.zeros(self.topology.n, np.float32)
        if len(src):
            np.add.at(lost, dst, w * (np.float32(1.0) - alive[src].astype(np.float32)))
        return lost

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        inner_state, res = state["in"], state["res"]
        trust = self._vec(res["trust"]).astype(bool)
        alive = trust.copy()
        if self._suspect_gap is not None and self.inner.has_staleness():
            sender_gap = np.max(self.inner.version_gaps(inner_state), axis=0)
            alive &= sender_gap <= self._suspect_gap
        local = self._local()
        leaves = tree_leaves(tree)
        inexact = [x.is_floating_point() for x in leaves]
        quar = res["quarantined"]
        new_res = dict(res)
        saved: list = []

        # ---- sender-side guard: quarantine a poisoned own payload ---------
        if self._guard:
            # per node and leaf, so that a temporary mask is one node's slice
            flags = [torch.stack([~_all_finite(x[row]) for x, ix in zip(leaves, inexact)
                                  if ix]).any() if any(inexact) else torch.zeros((), dtype=bool)
                     for row, _ in local]
            own_bad = torch.stack(flags).cpu().numpy()  # one device-to-host read
            if self._last_good:
                lg = tree_leaves(res["lg"])
                lg_ok = res["lg_ok"].cpu().numpy().copy()
                for (row, _), bad in zip(local, own_bad):
                    for x, g, ix in zip(leaves, lg, inexact):
                        if not ix:
                            continue
                        if not bad:
                            g[row].copy_(x[row])
                        elif lg_ok[row]:  # publish the last finite payload
                            saved.append((x, row, x[row].clone()))
                            x[row].copy_(g[row])
                lg_ok |= ~own_bad
                new_res["lg_ok"] = torch.from_numpy(lg_ok)
            quar = quar + torch.from_numpy(own_bad.astype(np.int32)).to(quar.device)
        published = len(saved)

        # ---- mask distrusted senders, mix, heal the lost weight -----------
        for row, node in local:
            if not alive[node]:
                for x, ix in zip(leaves, inexact):
                    saved.append((x, row, x[row].clone()))
                    x[row].zero_()
        inner_state, mixed = self.inner.apply(inner_state, tree, step)
        masked = saved[published:]
        del saved[published:]
        _restore(masked)
        del masked

        out = tree_leaves(mixed)
        if not alive.all():
            lost = self.lost_weight(step, alive)
            for o, p, ix in zip(out, leaves, inexact):
                if not ix:
                    continue
                for row, node in local:
                    heal = torch.mul(p[row].to(torch.float32), float(lost[node]))
                    o[row].copy_((o[row].to(torch.float32) + heal).to(o.dtype))
                    del heal

        # ---- receiver-side guard: drop non-finite arrivals elementwise ----
        if self._guard:
            # which nodes' mixes hold a non-finite entry (one read of the mix
            # and one device-to-host read); only those are selected entrywise
            flags = [torch.stack([~_all_finite(o[row]) for o, ix in zip(out, inexact)
                                  if ix]).any() if any(inexact) else torch.zeros((), dtype=bool)
                     for row, _ in local]
            rec_bad = torch.stack(flags).cpu().numpy()
            for (row, _), bad in zip(local, rec_bad):
                if not bad:
                    continue
                for o, p, ix in zip(out, leaves, inexact):
                    if ix:
                        fin = torch.isfinite(o[row])
                        torch.where(fin, o[row], p[row].to(o.dtype), out=o[row])
                        del fin
            quar = quar + torch.from_numpy(rec_bad.astype(np.int32)).to(quar.device)

        # a distrusted node freezes to its own payload (the e_i row)
        for row, node in local:
            if not alive[node]:
                for o, p in zip(out, leaves):
                    o[row].copy_(p[row])
        _restore(saved)

        new_res["trust"] = res["trust"]
        new_res["quarantined"] = quar
        return {"in": inner_state, "res": new_res}, mixed
