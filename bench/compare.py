"""The numbers that decide ``correct``: the program's readings of its first
steps against the plain reference's (the trainer's, ``bench/reference/<algorithm>.py``).

* ``loss``: the largest relative gap of a step's loss (the mean over nodes);
* ``grad``: the worst leaf's gap between the norms of the momentum after the
  first step, the gradient as the optimizer gets it (DecentLaM's
  ``(x - mix) / lr``: the gossiped gradient);
* ``change``: the worst leaf's gap between the norms of the parameters'
  change over the three steps;
* ``ef`` (compressed gossip): the worst leaf's gap between the norms of the
  error-feedback residual after the three steps;
* ``grad_block``, ``change_block``: as ``grad`` and ``change``, but by block
  (each matrix of a stacked leaf: a layer's, or a layer's expert's) and the
  median block's gap (the worst node's).  A near-tied MoE expert choice that
  f32 rounding flips, or the capacity drop it moves, changes a few blocks
  about as much as a lower precision does, but a lower precision moves
  them all.

A cell compares the numbers its limits file names (``bench/limits/<cell>.
json``); :func:`numbers` works out all of them.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and of the median leaf (of the same node), so
that a leaf whose value is all but zero does not blow up.  ``change`` leaves
out the leaves whose reference gradient is under a thousandth of the median
leaf's: nought to rounding, they move by round-off alone.  A missing or
non-finite reading gives ``inf``.
"""

from __future__ import annotations

import math
import statistics


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    worst = 0.0
    nodes = len(next(iter(ref.values())))
    for i in range(nodes):
        med = statistics.median(v[i] for v in ref.values())
        for k, r in ref.items():
            if keep is not None and not keep(k, i):
                continue
            p = prog.get(k)
            if p is None or not (math.isfinite(p[i]) and math.isfinite(r[i])):
                return math.inf
            scale = max(r[i], med)
            gap = abs(p[i] - r[i]) / scale if scale > 0 else abs(p[i] - r[i])
            worst = max(worst, gap)
    return worst


def median_block(prog: dict, ref: dict, keep=None) -> float:
    worst = 0.0
    nodes = len(next(iter(ref.values())))
    for i in range(nodes):
        med = statistics.median(b for k, r in ref.items() for b in r[i])
        gaps = []
        for k, r in ref.items():
            if keep is not None and not keep(k, i):
                continue
            p = prog.get(k)
            if p is None or len(p[i]) != len(r[i]):
                return math.inf
            for a, b in zip(p[i], r[i]):
                if not (math.isfinite(a) and math.isfinite(b)):
                    return math.inf
                scale = max(b, med)
                gaps.append(abs(a - b) / scale if scale > 0 else abs(a - b))
        if gaps:
            worst = max(worst, statistics.median(gaps))
    return worst


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) and math.isfinite(r) and r else math.inf
            for p, r in zip(prog["losses"], ref["losses"])]
    raw = ref["grad_raw"]
    nodes = len(next(iter(raw.values())))
    med = [statistics.median(v[i] for v in raw.values()) for i in range(nodes)]
    moved = lambda k, i: raw[k][i] >= 1e-3 * med[i]  # noqa: E731
    out = {"loss": max(gaps) if gaps else math.inf,
           "grad": worst_leaf(prog["m1"], ref["m1"]),
           "change": worst_leaf(prog["dx"], ref["dx"], keep=moved)}
    if "m1_blocks" in ref:
        out["grad_block"] = median_block(prog.get("m1_blocks", {}), ref["m1_blocks"])
        out["change_block"] = median_block(prog.get("dx_blocks", {}), ref["dx_blocks"],
                                           keep=moved)
    if "ef" in ref:
        out["ef"] = worst_leaf(prog.get("ef", {}), ref["ef"])
    return out


def checks(numbers: dict, limits: dict) -> dict:
    """Each number the limits name, beside its limit (a number the reading
    lacks is ``inf``)."""
    return {k: {"value": numbers.get(k, math.inf), "limit": lim} for k, lim in limits.items()}


def passes(checks: dict) -> bool:
    """Every number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
