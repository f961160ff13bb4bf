"""The cases that ``tests/test_torch_dist_gossip.py`` runs through both
packages' distributed channels (the dense ones, the row-sparse ones with
seeded row masks, chaos and the resilient layer): 8 nodes, seeded numpy
payloads, 3 steps.
numpy only, so that the JAX reference script and the spawned torch ranks
both import it."""

import numpy as np

N = 8
STEPS = 3
# per-node payload leaves: a matrix, two 1024-wide plane rows and a vector
LEAVES = {"a": (6, 33), "p": (2, 1024), "v": (257,)}
FAMILIES = ["exp", "ring", "one-peer-exp"]
COMPRESSORS = [None, "bf16", "int8-row-ef", "topk:0.25"]


def _cases() -> dict:
    cases = {}
    for fam in FAMILIES:
        for comp in COMPRESSORS:
            cases[f"ppermute-{fam}-{comp or 'none'}"] = {
                "kind": "ppermute", "family": fam, "compression": comp}
    for d in (0, 1, 2):
        cases[f"delayed-exp-d{d}"] = {"kind": "delayed", "family": "exp", "delay": d,
                                      "calls": 2}
    cases["allgather-exp"] = {"kind": "allgather", "family": "exp"}
    # node 3 dead: its edge classes are partial permutations (it receives
    # nothing and gets zeros, as ppermute gives)
    cases["ppermute-exp-partial"] = {"kind": "ppermute", "family": "exp", "compression": None,
                                     "dead": [3]}
    # row-sparse gossip: seeded per-node row masks marked before every round
    for fam, mode, comp in (("exp", "exact", None), ("ring", "exact", "bf16"),
                            ("one-peer-exp", "exact", "int8-row-ef"), ("exp", "delta", None),
                            ("one-peer-exp", "delta", None), ("ring", "delta", "int8-row")):
        cases[f"sparse-{mode}-{fam}-{comp or 'none'}"] = {
            "kind": "sparse", "family": fam, "mode": mode, "compression": comp, "delay": 0}
    cases["sparse-exact-exp-d1"] = {"kind": "sparse", "family": "exp", "mode": "exact",
                                    "compression": None, "delay": 1, "calls": 2}
    # every row dirty: the dense channels' bits (held within the port)
    for mode in ("exact", "delta"):
        cases[f"sparse-{mode}-exp-all"] = {"kind": "sparse", "family": "exp", "mode": mode,
                                           "compression": None, "delay": 0, "all": True}
    cases["sparse-exact-exp-d1-all"] = {"kind": "sparse", "family": "exp", "mode": "exact",
                                        "compression": None, "delay": 1, "calls": 2,
                                        "all": True}
    # chaos and the resilient layer over the ppermute channel
    cases["chaos-exp"] = {"kind": "chaos", "family": "exp", "faults": [
        ("silence", {"nodes": (1,), "start": 1, "stop": 3}), ("drop", {"prob": 0.3}),
        ("dup", {"nodes": (2, 5), "prob": 0.5}), ("delay", {"nodes": (6,), "prob": 0.7}),
        ("corrupt", {"nodes": (4,), "prob": 1.0, "frac": 0.05, "bit": 21})]}
    cases["resilient-one-peer-exp"] = {"kind": "resilient", "family": "one-peer-exp",
                                       "trust": [1, 1, 1, 0, 1, 1, 1, 1], "faults": [
                                           ("silence", {"nodes": (3,)}),
                                           ("dup", {"nodes": (0,), "prob": 0.5})]}
    cases["resilient-exp-clean"] = {"kind": "resilient", "family": "exp", "faults": []}
    return cases


CASES = _cases()


def payload(seed: int) -> dict:
    """Stacked ``(N, ...)`` f32 payloads from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in LEAVES.items()}


def masks(case: dict, seed: int) -> dict:
    """Per-node row masks ``(N, R)`` of a sparse case's round: every row, or
    about a quarter of them from ``default_rng(1000 + seed)``."""
    if case.get("all"):
        return {k: np.ones((N, s[0]), bool) for k, s in LEAVES.items()}
    rng = np.random.default_rng(1000 + seed)
    return {k: rng.random((N, s[0])) < 0.25 for k, s in LEAVES.items()}


def rounds(case: dict) -> list[tuple[int, int]]:
    """``(step, payload seed)`` of every apply: ``calls`` per step."""
    calls = case.get("calls", 1)
    return [(s, 1 + s * calls + c) for s in range(STEPS) for c in range(calls)]
