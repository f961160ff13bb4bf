"""Network topologies and gossip weight matrices for decentralized training.

Implements the graphs used in the paper (Sec. 7 / App. G.3): ring, 2-D torus
("mesh"), symmetric exponential, one-peer exponential, bipartite random match,
plus fully-connected (reduces decentralized methods to their parallel
counterparts).  Weight matrices follow the Metropolis–Hastings rule
[Sayed 2014, Table 14.1] so that W is symmetric, doubly stochastic and
satisfies Assumption A.3 of the paper.

Two representations are kept in sync:

* ``W(step)`` — the dense ``(n, n)`` matrix, used by the stacked reference
  implementations, by the spectral-gap analysis (``rho``) and by tests.
* ``edge_classes(step)`` — a decomposition of the off-diagonal support of W
  into *permutations* of the node set.  Each edge class is executed on TPU as
  one ``jax.lax.ppermute`` (collective-permute) for the whole parameter
  pytree; the per-receiving-node weights are an ``(n,)`` vector so irregular
  (e.g. fault-degraded) graphs are expressible too.

Fault tolerance: ``Topology.exclude(dead)`` returns a topology on the
surviving nodes' *original indices* where dead nodes receive/contribute zero
weight and survivors are re-weighted (Metropolis on the induced subgraph), so
training can route around fail-stopped nodes without renumbering.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Sequence

import numpy as np

__all__ = [
    "EdgeClass",
    "Topology",
    "TopologySpec",
    "build_topology",
    "metropolis_weights",
    "rho",
    "TOPOLOGIES",
]


@dataclasses.dataclass(frozen=True)
class EdgeClass:
    """One permutation's worth of gossip communication.

    ``perm[src] = dst`` describes where each node's payload is sent;
    ``recv_weight[i]`` is the weight w_{i, perm^{-1}(i)} the *receiving* node i
    applies to the payload it gets.  Nodes that receive nothing (perm misses
    them) must have ``recv_weight == 0`` there.
    """

    perm: tuple[int, ...]
    recv_weight: np.ndarray  # (n,) float64

    @property
    def pairs(self) -> list[tuple[int, int]]:
        return [(s, d) for s, d in enumerate(self.perm) if d >= 0]

    def validate(self, n: int) -> None:
        dsts = [d for d in self.perm if d >= 0]
        assert len(set(dsts)) == len(dsts), "edge class is not a partial permutation"
        assert len(self.perm) == n
        assert self.recv_weight.shape == (n,)
        receivers = set(dsts)
        for i in range(n):
            if i not in receivers:
                assert self.recv_weight[i] == 0.0, (
                    f"node {i} receives nothing but has weight {self.recv_weight[i]}"
                )


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights for a symmetric 0/1 adjacency (no self loops).

    w_ij = 1 / (1 + max(deg_i, deg_j)) for edges, w_ii = 1 - sum_j w_ij.
    The result is symmetric and doubly stochastic (Assumption A.3).
    """
    adj = np.asarray(adj)
    assert adj.shape[0] == adj.shape[1]
    assert (adj == adj.T).all(), "adjacency must be symmetric"
    assert (np.diag(adj) == 0).all(), "no self loops in adjacency"
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n), dtype=np.float64)
    rows, cols = np.nonzero(adj)
    for i, j in zip(rows, cols):
        W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    W[np.diag_indices(n)] = 1.0 - W.sum(axis=1)
    return W


def rho(W: np.ndarray) -> float:
    """Spectral gap parameter: max(|lambda_2|, |lambda_n|) of W.

    Characterizes connectivity; rho in (0, 1) for connected graphs
    (paper eq. (28)).  rho -> 0 means well connected.
    """
    n = W.shape[0]
    M = W - np.ones((n, n)) / n
    return float(np.max(np.abs(np.linalg.eigvalsh((M + M.T) / 2.0))))


def _offsets_to_adj(n: int, offsets: Sequence[int]) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.int64)
    for off in offsets:
        for i in range(n):
            j = (i + off) % n
            if i != j:
                adj[i, j] = 1
                adj[j, i] = 1
    return adj


def _classes_from_W(W: np.ndarray) -> list[EdgeClass]:
    """Greedy decomposition of W's off-diagonal support into partial permutations.

    Exact for every topology here (all are unions of matchings / circulant
    shifts) and correct in general: repeatedly peel a partial permutation off
    the remaining support.
    """
    n = W.shape[0]
    remaining = [
        (i, j) for i in range(n) for j in range(n) if i != j and W[i, j] != 0.0
    ]
    classes: list[EdgeClass] = []
    while remaining:
        used_src: set[int] = set()
        used_dst: set[int] = set()
        perm = [-1] * n
        weight = np.zeros(n, dtype=np.float64)
        rest: list[tuple[int, int]] = []
        for (i, j) in remaining:
            # payload flows j -> i (receiver i applies W[i, j])
            if j not in used_src and i not in used_dst:
                used_src.add(j)
                used_dst.add(i)
                perm[j] = i
                weight[i] = W[i, j]
            else:
                rest.append((i, j))
        classes.append(EdgeClass(perm=tuple(perm), recv_weight=weight))
        remaining = rest
    return classes


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly time-varying) gossip topology over ``n`` nodes.

    ``period`` is the number of distinct weight matrices it cycles through;
    static topologies have ``period == 1``.

    The *sparse* per-edge representation (``edge_classes`` + per-phase self
    weights) is primary; the dense ``(n, n)`` matrix is materialized lazily
    on first ``W(step)`` access and cached.  Topologies built from a dense W
    (``_static`` / ``_cycle``) carry both eagerly; topologies built from
    edge classes (``_from_classes`` — the fleet-scale generators) never pay
    O(n^2) memory unless a dense consumer (spectral analysis, the stacked
    oracle channel) asks for it.
    """

    name: str
    n: int
    _W_cycle: tuple[np.ndarray, ...] | None
    _classes_cycle: tuple[tuple[EdgeClass, ...], ...]
    _self_weight_cycle: tuple[np.ndarray, ...] | None = None

    @property
    def period(self) -> int:
        return len(self._classes_cycle)

    def W(self, step: int = 0) -> np.ndarray:
        phase = step % self.period
        if self._W_cycle is not None:
            return self._W_cycle[phase]
        cache = self.__dict__.get("_W_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_W_cache", cache)
        if phase not in cache:
            W = np.diag(self.self_weight(phase)).astype(np.float64)
            for c in self._classes_cycle[phase]:
                for src, dst in c.pairs:
                    W[dst, src] += c.recv_weight[dst]
            cache[phase] = W
        return cache[phase]

    def self_weight(self, step: int = 0) -> np.ndarray:
        phase = step % self.period
        if self._self_weight_cycle is not None:
            return self._self_weight_cycle[phase].copy()
        return np.diag(self.W(phase)).copy()

    def edge_classes(self, step: int = 0) -> tuple[EdgeClass, ...]:
        return self._classes_cycle[step % self.period]

    def max_degree(self) -> int:
        if self._W_cycle is not None:
            return max(
                int((np.abs(W) > 0).sum(axis=1).max()) - 1 for W in self._W_cycle
            )
        return max(int(self.in_degree(t).max()) for t in range(self.period))

    def in_degree(self, step: int = 0) -> np.ndarray:
        """Per-node count of nonzero-weight in-edges at this phase (sparse)."""
        deg = np.zeros(self.n, dtype=np.int64)
        for c in self.edge_classes(step):
            for src, dst in c.pairs:
                if c.recv_weight[dst] != 0.0 and src != dst:
                    deg[dst] += 1
        return deg

    def in_neighbors(self) -> tuple[tuple[int, ...], ...]:
        """Sparse per-edge in-neighbor map: for each node, the sorted union
        over period phases of the nodes whose payload it mixes with nonzero
        weight.  Derived from ``edge_classes`` — no dense W materialization,
        so it stays O(edges) at fleet scale.  The simulator's SSP blocking
        and staleness-gap accounting key on this map."""
        nbrs: list[set[int]] = [set() for _ in range(self.n)]
        for t in range(self.period):
            for c in self.edge_classes(t):
                for src, dst in c.pairs:
                    if c.recv_weight[dst] != 0.0 and src != dst:
                        nbrs[dst].add(src)
        return tuple(tuple(sorted(s)) for s in nbrs)

    def in_neighbor_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR form of :meth:`in_neighbors`: ``(indptr, indices)`` with
        ``indices[indptr[i]:indptr[i+1]]`` = node ``i``'s in-neighbors —
        the vectorized event engine's edge list."""
        nbrs = self.in_neighbors()
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        for i, s in enumerate(nbrs):
            indptr[i + 1] = indptr[i] + len(s)
        indices = np.fromiter(
            (j for s in nbrs for j in s), dtype=np.int64, count=int(indptr[-1])
        )
        return indptr, indices

    def rho(self) -> float:
        """Spectral gap of the *average* mixing matrix over one period."""
        Wbar = sum(self.W(t) for t in range(self.period)) / self.period
        return rho(Wbar)

    def validate(self) -> None:
        for t in range(self.period):
            W, classes = self.W(t), self._classes_cycle[t]
            n = self.n
            assert W.shape == (n, n)
            np.testing.assert_allclose(W, W.T, atol=1e-12, err_msg="W not symmetric")
            np.testing.assert_allclose(
                W.sum(axis=1), np.ones(n), atol=1e-12, err_msg="W not stochastic"
            )
            # edge classes reconstruct W exactly
            R = np.diag(np.diag(W)).astype(np.float64)
            for c in classes:
                c.validate(n)
                for src, dst in c.pairs:
                    if c.recv_weight[dst] != 0.0:
                        R[dst, src] += c.recv_weight[dst]
            np.testing.assert_allclose(R, W, atol=1e-12, err_msg="classes != W")

    def exclude(self, dead: Sequence[int]) -> "Topology":
        """Route around fail-stopped nodes.

        Dead nodes keep weight 1 on themselves (their state is frozen and
        ignored); survivors get Metropolis weights on the induced subgraph, so
        W restricted to survivors remains symmetric doubly stochastic.
        """
        dead_set = set(int(d) for d in dead)
        assert all(0 <= d < self.n for d in dead_set)
        new_W = []
        for t in range(self.period):
            W = self.W(t)
            adj = (np.abs(W - np.diag(np.diag(W))) > 0).astype(np.int64)
            for d in dead_set:
                adj[d, :] = 0
                adj[:, d] = 0
            Wn = metropolis_weights(adj)
            new_W.append(Wn)
        classes = tuple(tuple(_classes_from_W(W)) for W in new_W)
        return Topology(
            name=f"{self.name}-exclude{sorted(dead_set)}",
            n=self.n,
            _W_cycle=tuple(new_W),
            _classes_cycle=classes,
        )


def _static(name: str, W: np.ndarray) -> Topology:
    t = Topology(
        name=name,
        n=W.shape[0],
        _W_cycle=(W,),
        _classes_cycle=(tuple(_classes_from_W(W)),),
    )
    t.validate()
    return t


def _cycle(name: str, Ws: Sequence[np.ndarray]) -> Topology:
    t = Topology(
        name=name,
        n=Ws[0].shape[0],
        _W_cycle=tuple(Ws),
        _classes_cycle=tuple(tuple(_classes_from_W(W)) for W in Ws),
    )
    t.validate()
    return t


def _from_classes(
    name: str,
    n: int,
    classes_cycle: Sequence[Sequence[EdgeClass]],
    self_weight_cycle: Sequence[np.ndarray],
) -> Topology:
    """Sparse constructor: edge classes + per-phase self weights, no dense W.

    The fleet-scale generators build through here so an n=1024 topology
    costs O(n * degree), not O(n^2); ``W(step)`` still materializes (and
    caches) the dense matrix on demand for the spectral analysis and the
    stacked oracle channel.  Classes are validated per phase (cheap); the
    dense symmetry/stochasticity check stays in ``validate()`` for callers
    that want it.
    """
    for classes in classes_cycle:
        for c in classes:
            c.validate(n)
    return Topology(
        name=name,
        n=n,
        _W_cycle=None,
        _classes_cycle=tuple(tuple(cs) for cs in classes_cycle),
        _self_weight_cycle=tuple(
            np.asarray(sw, dtype=np.float64) for sw in self_weight_cycle
        ),
    )


# ---------------------------------------------------------------------------
# Concrete topologies
# ---------------------------------------------------------------------------


def ring(n: int) -> Topology:
    if n == 1:
        return fully_connected(1)
    if n == 2:
        return _static("ring", metropolis_weights(_offsets_to_adj(2, [1])))
    return _static("ring", metropolis_weights(_offsets_to_adj(n, [1, -1])))


def torus(n: int) -> Topology:
    """2-D torus ("mesh" in the paper); n must factor into rows x cols."""
    rows = int(math.isqrt(n))
    while n % rows != 0:
        rows -= 1
    cols = n // rows
    if rows == 1:
        return ring(n)
    adj = np.zeros((n, n), dtype=np.int64)

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for (dr, dc) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = idx(r + dr, c + dc)
                if i != j:
                    adj[i, j] = 1
                    adj[j, i] = 1
    return _static("torus", metropolis_weights(adj))


def symmetric_exponential(n: int, *, degree: int | None = None) -> Topology:
    """Neighbors at hop distances +/- 2^k (paper App. G.3, [Assran et al.]).

    ``degree`` truncates the family to the first ``degree`` hop distances
    (1, 2, 4, ...), i.e. each node talks to ~``2 * degree`` peers — the
    sparse fleet setting where the full exponential graph would approach
    all-to-all.  ``None`` keeps every distance up to ``n // 2``.
    """
    if n <= 2:
        return ring(n)
    offsets: list[int] = []
    k = 0
    while (1 << k) <= n // 2:
        offsets.append(1 << k)
        k += 1
    if degree is not None:
        assert 1 <= degree <= len(offsets), (
            f"degree must be in [1, {len(offsets)}] for n={n}, got {degree}"
        )
        offsets = offsets[:degree]
    return _static(
        "symmetric-exponential", metropolis_weights(_offsets_to_adj(n, offsets))
    )


def one_peer_exponential(n: int, *, period: int | None = None) -> Topology:
    """Time-varying degree-1 exponential graph via XOR matchings (sparse).

    At step t each node exchanges with ``i XOR 2^(t mod period)``:
    W_t = (I + P_t) / 2, a perfect matching -> O(1) bandwidth *and* a single
    partner per step (maximal straggler tolerance).  Requires n power of two.

    Built directly from edge classes — one permutation + uniform 0.5 receive
    weight per phase — so an n=1024 fleet topology costs O(n log n), not the
    O(n^2 log n) of a dense cycle.  ``period`` truncates the distance cycle
    to the first ``period`` powers of two (default ``log2 n``, the full
    exponential sweep).
    """
    assert n >= 2 and (n & (n - 1)) == 0, "one-peer exponential needs power-of-two n"
    k_max = int(math.log2(n))
    if period is None:
        period = k_max
    assert 1 <= period <= k_max, (
        f"period must be in [1, log2(n)={k_max}], got {period}"
    )
    classes_cycle = []
    for k in range(period):
        perm = tuple(i ^ (1 << k) for i in range(n))
        classes_cycle.append(
            (EdgeClass(perm=perm, recv_weight=np.full(n, 0.5)),)
        )
    self_weights = [np.full(n, 0.5) for _ in range(period)]
    return _from_classes("one-peer-exponential", n, classes_cycle, self_weights)


def one_peer_ring(n: int) -> Topology:
    """Time-varying degree-1 ring: alternating even/odd edge matchings.

    Phase 0 pairs ``(0,1), (2,3), ...``; phase 1 pairs ``(1,2), (3,4), ...,
    (n-1,0)`` — the period-2 matching decomposition of the ring, so each
    node talks to exactly one peer per step but the union over a period is
    the full ring.  Requires even n.  Built sparsely from edge classes.
    """
    assert n >= 2 and n % 2 == 0, "one-peer ring needs even n"
    if n == 2:
        return one_peer_exponential(2)
    classes_cycle = []
    for phase in range(2):
        perm = [-1] * n
        for a in range(phase, n, 2):
            i, j = a, (a + 1) % n
            perm[i] = j
            perm[j] = i
        classes_cycle.append(
            (EdgeClass(perm=tuple(perm), recv_weight=np.full(n, 0.5)),)
        )
    self_weights = [np.full(n, 0.5) for _ in range(2)]
    return _from_classes("one-peer-ring", n, classes_cycle, self_weights)


def bipartite_random_match(n: int, *, seed: int = 0, pool: int = 8) -> Topology:
    """Random perfect matchings per iteration (paper App. G.3), seeded.

    A pool of ``pool`` matchings is pre-generated and cycled; every node uses
    the same seed so there are no deadlocks (as in the paper).
    """
    assert n % 2 == 0, "random matching needs even n"
    rng = np.random.default_rng(seed)
    Ws = []
    for _ in range(pool):
        order = rng.permutation(n)
        W = np.zeros((n, n), dtype=np.float64)
        for a in range(0, n, 2):
            i, j = int(order[a]), int(order[a + 1])
            W[i, j] = W[j, i] = 0.5
            W[i, i] = W[j, j] = 0.5
        Ws.append(W)
    return _cycle("bipartite-random-match", Ws)


def fully_connected(n: int) -> Topology:
    """W = (1/n) 11^T — decentralized methods reduce to their parallel forms."""
    W = np.full((n, n), 1.0 / n, dtype=np.float64)
    return _static("fully-connected", W)


def disconnected(n: int) -> Topology:
    """W = I — no communication (for ablation: pure local SGD)."""
    return _static("disconnected", np.eye(n, dtype=np.float64))


TOPOLOGIES = {
    "ring": ring,
    "torus": torus,
    "mesh": torus,  # the paper's name for the grid topology
    "exp": symmetric_exponential,
    "symmetric-exponential": symmetric_exponential,
    "one-peer-exp": one_peer_exponential,
    "one-peer-exponential": one_peer_exponential,
    "one-peer-ring": one_peer_ring,
    "random-match": bipartite_random_match,
    "bipartite-random-match": bipartite_random_match,
    "full": fully_connected,
    "fully-connected": fully_connected,
    "none": disconnected,
    "disconnected": disconnected,
}


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative topology: a registry family plus its parameters as fields.

    Promotes ``build_topology("one-peer-exp", n)`` string dispatch to a
    first-class spec so parameters that used to require bespoke factory
    kwargs (``period`` for the one-peer exponential's distance cycle,
    ``degree`` for the symmetric exponential's truncation, ``seed``/``pool``
    for random matchings) live in one frozen, hashable value that travels
    through ``SimSpec``, ``plan_recovery`` and checkpoints.  ``family`` is
    any :data:`TOPOLOGIES` key; string names everywhere else remain accepted
    shorthand that resolves through this registry.

    Fields that a family does not accept must stay ``None`` — ``build``
    raises otherwise rather than silently dropping them.
    """

    family: str = "ring"
    degree: int | None = None
    period: int | None = None
    seed: int | None = None
    pool: int | None = None

    def __post_init__(self):
        if self.family not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology family {self.family!r}; "
                f"available: {sorted(TOPOLOGIES)}"
            )

    def build(self, n: int) -> Topology:
        factory = TOPOLOGIES[self.family]
        accepted = inspect.signature(factory).parameters
        kwargs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "family" and getattr(self, f.name) is not None
        }
        unknown = set(kwargs) - set(accepted)
        if unknown:
            raise ValueError(
                f"topology family {self.family!r} does not take "
                f"{sorted(unknown)} (accepted: "
                f"{sorted(set(accepted) - {'n'})})"
            )
        return factory(n, **kwargs)


def build_topology(spec: str | TopologySpec | Topology, n: int, **kwargs) -> Topology:
    """Resolve a topology reference to a concrete :class:`Topology`.

    Accepts, in order of preference:

    * a :class:`TopologySpec` — the first-class form;
    * a string family name (+ optional factory kwargs) — shorthand that
      resolves through the :class:`TopologySpec` registry;
    * an already-built :class:`Topology` — passed through when its node
      count matches (it cannot be rebuilt at another size, e.g. by a
      rescale recovery; pass a name or spec for that).
    """
    if isinstance(spec, Topology):
        if kwargs:
            raise TypeError("cannot pass factory kwargs with a built Topology")
        if spec.n != n:
            raise ValueError(
                f"topology {spec.name!r} is built for n={spec.n}, not n={n}; "
                "pass a family name or TopologySpec so it can be rebuilt"
            )
        return spec
    if isinstance(spec, str):
        spec = TopologySpec(family=spec, **kwargs)
    elif kwargs:
        raise TypeError("factory kwargs only combine with a string family name")
    return spec.build(n)
