"""Seeded fault injection for gossip transports (``repro.resilience.chaos``).

:class:`ChaosChannel` wraps any :class:`~repro_torch.core.gossip.GossipChannel`
and perturbs each node's *published* payload before handing it to the inner
transport, so one fault vocabulary drives both the stacked channels
(payload leaves carry the ``(n, ...)`` node axis) and the distributed ones
(each rank's leaves ``(1, ...)``, its node the rank).  Faults are
sender-side: a silenced or dropped payload vanishes from every receiver's
mix in the same round, exactly like a lost wire message.

Faults come from a declarative :class:`ChaosSchedule` — static ``[start,
stop)`` step windows over a node subset, with per-round randomness derived
from ``fold_in(seed, round)`` (and ``fold_in(node)`` for per-entry masks).
The draws are ``repro``'s bit for bit: the port keeps its own copy of the
threefry hash in ``jax.random``'s layout (:mod:`._prng`).  The ``(n,)`` fire
vectors are drawn in numpy on the host; the per-entry masks of
:class:`BitCorrupt` and :class:`NaNInject` in int64 torch ops on the
payload's device, only for the nodes whose fault fired that round.
:meth:`ChaosSchedule.from_events` maps the simulator's membership events
(``FailStop`` / ``Rejoin``) onto silence windows.

An **empty schedule is bit-exact** with the unwrapped channel: ``apply`` is
a pure delegate.  A schedule whose windows are closed in a round edits
nothing, so it is bitwise transparent too.  A round that fires edits the
faulted nodes' slices of the payload in place, hands it to the inner
channel, and then writes the saved slices back: the caller's payload (which
the resilient layer one level up still reads) comes back unchanged, and the
extra memory is one node's slice per faulted node.  The wrapper offers no
payload slot (:meth:`payload_slot`), so that an inner delay ring records a
copy of the faulted payload, never the caller's buffer.

Liveness bookkeeping: the channel counts consecutive undelivered rounds per
sender (``miss``, host tensors, as is the round counter) and folds them into
:meth:`version_gaps`, so ``node_gaps`` / ``fleet_node_gaps`` /
:class:`~repro_torch.resilience.health.HealthMonitor` observe chaos-induced
staleness with no extra wiring.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.gossip import GossipChannel, Tree, _edge_mask, _incident_gaps
from ..sim.events import FailStop, Rejoin
from ..utils import tree_leaves, tree_map
from . import _prng

__all__ = [
    "BitCorrupt",
    "ChaosChannel",
    "ChaosSchedule",
    "Drop",
    "Duplicate",
    "ExtraDelay",
    "Fault",
    "NaNInject",
    "PeerSilence",
]


# ---------------------------------------------------------------------------
# Fault vocabulary (frozen, hashable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base fault: applies to ``nodes`` (``None`` = all) on optimizer steps
    in the half-open window ``[start, stop)`` (``stop=None`` = forever)."""

    nodes: tuple[int, ...] | None = None
    start: int = 0
    stop: int | None = None


@dataclasses.dataclass(frozen=True)
class PeerSilence(Fault):
    """Deterministic fail-stop: the node's payload never ships while the
    window is open (the wire image of ``sim.events.FailStop``)."""


@dataclasses.dataclass(frozen=True)
class Drop(Fault):
    """Lossy link: each round, the node's payload is lost with ``prob``."""

    prob: float = 0.1


@dataclasses.dataclass(frozen=True)
class Duplicate(Fault):
    """At-least-once transport: the payload is delivered twice (a doubled
    payload: receivers *and* the sender's own self-term double)."""

    prob: float = 0.1


@dataclasses.dataclass(frozen=True)
class ExtraDelay(Fault):
    """One-round retransmit: the previous round's payload ships instead of
    the current one (a 1-deep replay buffer lives in the chaos state)."""

    prob: float = 0.1


@dataclasses.dataclass(frozen=True)
class BitCorrupt(Fault):
    """With ``prob`` per round, flip ``bit`` of a seeded ``frac`` of the
    payload's f32 entries (bit 30, the exponent's top bit, by default)."""

    prob: float = 0.05
    frac: float = 1e-3
    bit: int = 30


@dataclasses.dataclass(frozen=True)
class NaNInject(Fault):
    """Poisoned update: a seeded ``frac`` of entries becomes NaN."""

    prob: float = 0.05
    frac: float = 1e-3


_KIND = {
    PeerSilence: "silence",
    Drop: "drop",
    Duplicate: "dup",
    ExtraDelay: "delay",
    BitCorrupt: "corrupt",
    NaNInject: "nan",
}
_EVENT_NAMES = tuple(_KIND.values())


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seeded, declarative fault script (empty = transparent wrapper)."""

    faults: tuple[Fault, ...] = ()
    seed: int = 0

    @staticmethod
    def from_events(events: Sequence, *, seed: int = 0,
                    extra: Sequence[Fault] = ()) -> "ChaosSchedule":
        """Map sim membership events onto silence windows: ``FailStop``
        opens a :class:`PeerSilence` at its ``at_step``; a later ``Rejoin``
        of the same node closes it.  Other events have no wire image and
        are ignored; ``extra`` appends hand-written faults."""
        open_at: dict[int, int] = {}
        out: list[Fault] = []
        for ev in sorted(events, key=lambda e: e.at_step):
            if isinstance(ev, FailStop):
                for i in ev.nodes:
                    open_at.setdefault(int(i), int(ev.at_step))
            elif isinstance(ev, Rejoin):
                for i in ev.nodes:
                    if int(i) in open_at:
                        out.append(PeerSilence(nodes=(int(i),), start=open_at.pop(int(i)),
                                               stop=int(ev.at_step)))
        out.extend(PeerSilence(nodes=(i,), start=s) for i, s in sorted(open_at.items()))
        return ChaosSchedule(faults=tuple(out) + tuple(extra), seed=seed)


# ---------------------------------------------------------------------------
# Wrapper plumbing shared with the resilient layer
# ---------------------------------------------------------------------------


class _Wrapper(GossipChannel):
    """A channel around ``inner``: its topology, compressor and layout, its
    telemetry left to the inner channel.  On the distributed layout the
    local node (row 0 of each leaf) is ``group.rank``; per-node host state
    carries a leading axis of 1 there, as every distributed channel leaf
    does (so that ``gather_state`` stacks it over the ranks)."""

    def _wrap(self, inner: GossipChannel):
        self.inner = inner
        self.topology = inner.topology
        self.compression = inner.compression
        self._impl = inner._impl
        self._telemetry = False  # the inner channel owns its telemetry
        self._compressor = inner._compressor
        self._stateful_comp = inner._stateful_comp
        self._stacked_layout = inner._stacked_layout
        self._tele_shape = inner._tele_shape

    def __getattr__(self, name):
        # the distributed channel's group, staged bytes, wire, ...
        if name == "inner" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def timings(self):
        return self.inner.timings

    @timings.setter
    def timings(self, value):
        self.inner.timings = value

    def _local(self) -> list[tuple[int, int]]:
        """``(row in the leaves, node)`` of each node this process holds."""
        if self._stacked_layout:
            return [(i, i) for i in range(self.topology.n)]
        return [(0, self.group.rank)]

    def _host(self, shape, dtype) -> torch.Tensor:
        """A zero per-node host tensor: ``shape`` on the stacked layout,
        ``(1,) + shape`` on a rank."""
        lead = () if self._stacked_layout else (1,)
        return torch.zeros(lead + tuple(shape), dtype=dtype)

    @staticmethod
    def _vec(t: torch.Tensor) -> np.ndarray:
        """A host per-node vector state leaf ((n,) or a rank's (1, n))."""
        return t.detach().cpu().numpy().reshape(-1, t.shape[-1])[0]

    def bytes_per_step(self, payload_bytes: float, state: Tree | None = None) -> dict:
        return self.inner.bytes_per_step(payload_bytes, None if state is None else state["in"])

    def collectives_per_round(self, payload: Tree, state: Tree | None = None) -> float:
        return self.inner.collectives_per_round(payload, None if state is None else state["in"])

    def payload_slot(self, state: Tree):
        return None

    def node_gaps(self, state: Tree):
        if not self.has_staleness():
            return 0
        gaps = _incident_gaps(self.version_gaps(state))
        if self._stacked_layout:
            return torch.from_numpy(gaps)
        me = self.group.rank
        return torch.from_numpy(gaps[me:me + 1].copy())


def _restore(saved: list) -> None:
    """Write saved node slices back, last edit first."""
    for leaf, row, old in reversed(saved):
        leaf[row].copy_(old)
    saved.clear()


def _flip_bit(y: torch.Tensor, bit: int) -> torch.Tensor:
    """Flip one bit of each entry's f32 representation (through f32, so a
    bf16 payload corrupts too)."""
    v = 1 << bit
    if v >= 1 << 31:
        v -= 1 << 32
    u = y.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_xor(u, v).view(torch.float32).to(y.dtype)


# ---------------------------------------------------------------------------
# The wrapper channel
# ---------------------------------------------------------------------------


class ChaosChannel(_Wrapper):
    """Fault-injecting wrapper around any gossip transport.

    State nests the inner channel's state under ``"in"`` and the chaos
    bookkeeping under ``"x"``: the round counter, per-sender consecutive
    missed-delivery counts (``miss``) and per-kind fired-event counters —
    all derived from ``(seed, round)`` alone, hence equal on every node,
    and host tensors — and, only when the schedule has :class:`ExtraDelay`
    faults, a 1-round replay buffer of the payload (``prev``, f32, on the
    payload's device).  On a rank every leaf has a leading axis of 1.
    """

    name = "chaos"

    def __init__(self, inner: GossipChannel, schedule: ChaosSchedule):
        self._wrap(inner)
        self.schedule = schedule
        n = self.topology.n
        for f in schedule.faults:
            if type(f) not in _KIND:
                raise TypeError(f"unknown fault type {type(f).__name__}")
            if f.nodes is not None:
                bad = [i for i in f.nodes if not 0 <= int(i) < n]
                if bad:
                    raise ValueError(f"fault nodes {bad} out of range for n={n}")
            if f.stop is not None and f.stop <= f.start:
                raise ValueError(f"empty fault window [{f.start}, {f.stop})")
        self._mask = _edge_mask(self.topology)
        self._liveness = any(isinstance(f, (PeerSilence, Drop)) for f in schedule.faults)
        self._has_delay = any(isinstance(f, ExtraDelay) for f in schedule.faults)

    def init(self, template: Tree) -> dict:
        n = self.topology.n
        x: dict = {
            "round": self._host((), torch.int32),
            "miss": self._host((n,), torch.int32),
            "events": {name: self._host((n,), torch.int32) for name in _EVENT_NAMES},
        }
        if self._has_delay:
            x["prev"] = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                                       device=a.device), template)
        return {"in": self.inner.init(template), "x": x}

    def has_staleness(self) -> bool:
        return self._liveness or self.inner.has_staleness()

    def version_gaps(self, state: Tree) -> np.ndarray:
        g = np.asarray(self.inner.version_gaps(state["in"]), np.int32)
        if self._liveness:
            miss = self._vec(state["x"]["miss"]).astype(np.int32)
            g = np.maximum(g, miss[None, :] * self._mask.astype(np.int32))
        return g

    # -- fault application --------------------------------------------------

    def _fires(self, rnd: int, step: int):
        """The round's draws: ``(bits, entry_faults)`` — per kind an ``(n,)``
        bool vector of nodes whose fault fired, and ``(fire, fault, key)``
        for each fault that edits entries."""
        n = self.topology.n
        key = _prng.fold_in(_prng.prng_key(self.schedule.seed), rnd)
        bits = {name: np.zeros(n, bool) for name in _EVENT_NAMES}
        entry = []
        for fi, f in enumerate(self.schedule.faults):
            member = np.zeros(n, bool)
            member[list(f.nodes) if f.nodes is not None else slice(None)] = True
            act = step >= f.start and (f.stop is None or step < f.stop)
            fire = member & act
            if not isinstance(f, PeerSilence):
                fire = fire & _prng.bernoulli(_prng.fold_in(key, fi), f.prob, (n,))
            name = _KIND[type(f)]
            bits[name] = bits[name] | fire
            if isinstance(f, (BitCorrupt, NaNInject)):
                entry.append((fire, f, _prng.fold_in(key, fi + 1000)))
        return bits, entry

    def _edit(self, leaves: list, prev: list | None, bits: dict, kill: np.ndarray,
              entry: list) -> list:
        """Fault the payload leaves in place, node slice by node slice;
        returns the saved slices for :func:`_restore`."""
        saved = []
        for li, leaf in enumerate(leaves):
            if not leaf.is_floating_point():
                continue
            for row, node in self._local():
                hit = [e for e in entry if e[0][node]]
                if not (kill[node] or bits["dup"][node] or hit
                        or (self._has_delay and bits["delay"][node])):
                    continue
                y = leaf[row]
                saved.append((leaf, row, y.clone()))
                if kill[node]:  # every other edit is overwritten by the zeros
                    y.zero_()
                    continue
                if self._has_delay and bits["delay"][node]:
                    y.copy_(prev[li][row])
                if bits["dup"][node]:
                    y.copy_((2.0 * y.to(torch.float32)).to(y.dtype))
                for _, f, kf in hit:
                    m = _prng.bernoulli_torch(_prng.fold_in(_prng.fold_in(kf, li), node),
                                              f.frac, y.shape, y.device)
                    if isinstance(f, BitCorrupt):
                        y.copy_(torch.where(m, _flip_bit(y, f.bit), y))
                    else:
                        y.masked_fill_(m, float("nan"))
                    del m
        return saved

    def apply(self, state: Tree, tree: Tree, step: int) -> tuple[Tree, Tree]:
        inner_state, x = state["in"], state["x"]
        if not self.schedule.faults:  # bit-exact passthrough
            inner_state, out = self.inner.apply(inner_state, tree, step)
            return {"in": inner_state, "x": x}, out
        rnd = int(x["round"].reshape(-1)[0])
        bits, entry = self._fires(rnd, int(step))
        kill = bits["silence"] | bits["drop"]
        leaves = tree_leaves(tree)
        prev = tree_leaves(x["prev"]) if self._has_delay else None
        saved = self._edit(leaves, prev, bits, kill, entry)
        inner_state, out = self.inner.apply(inner_state, tree, step)
        _restore(saved)

        lead = (1,) if not self._stacked_layout else ()
        miss = self._vec(x["miss"])
        new_x = {
            "round": torch.full(lead, rnd + 1, dtype=torch.int32).reshape(x["round"].shape),
            "miss": torch.from_numpy(np.where(kill, miss + 1, 0).astype(np.int32))
                         .reshape(x["miss"].shape),
            "events": {name: x["events"][name].cpu()
                       + torch.from_numpy(bits[name].astype(np.int32))
                       .reshape(x["events"][name].shape)
                       for name in _EVENT_NAMES},
        }
        if self._has_delay:
            for p, leaf in zip(prev, leaves):
                p.copy_(leaf)
            new_x["prev"] = x["prev"]
        return {"in": inner_state, "x": new_x}, out
