"""The cases that ``tests/test_torch_dist_gossip.py`` runs through both
packages' distributed channels: 8 nodes, seeded numpy payloads, 3 steps.
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
    return cases


CASES = _cases()


def payload(seed: int) -> dict:
    """Stacked ``(N, ...)`` f32 payloads from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in LEAVES.items()}


def rounds(case: dict) -> list[tuple[int, int]]:
    """``(step, payload seed)`` of every apply: ``calls`` per step."""
    calls = case.get("calls", 1)
    return [(s, 1 + s * calls + c) for s in range(STEPS) for c in range(calls)]
