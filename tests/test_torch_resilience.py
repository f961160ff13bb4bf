"""The fault-tolerant gossip runtime in the port (``repro_torch.resilience``)
against the JAX package, on the CPU.

* The counter hash: ``PRNGKey``, ``fold_in`` and ``bernoulli`` in
  ``jax.random``'s partitionable threefry layout, bit for bit.
* ``ChaosChannel``: every case of ``tests/test_resilience.py`` on the port,
  and beside ``repro``'s on the same payloads: the same fires (so the same
  miss counters and event counts, exactly) and the same mixes (1e-6 of the
  payloads' scale where the reference's are finite; see ``_close`` for the
  non-finite entries); an empty schedule and closed windows bitwise
  transparent.
* ``HealthMonitor``: its state sequences equal ``repro``'s on seeded gap
  streams; ``fleet_sender_gaps`` equals the reference's.
* ``ResilientChannel``: ``healed_W`` equal to the reference's; a distrusted
  round equals ``healed_W @ x`` in float64 at 1e-6 and the reference's mix;
  the payload guards; a clean path bitwise transparent.
* ``reset_rows`` / ``rejoin_node`` / ``plan_rejoin`` as the reference's.
* The CLI's ``--chaos`` / ``--resilient`` on ``--nodes`` (the monitor's
  states per step equal the reference monitor's on the same gaps, the
  quarantine counts, resume == unbroken with the wrappers' state) and on
  ``--simulate-nodes`` (4 gloo ranks: the same health states and the final
  parameters within the reference's distributed-vs-oracle tolerance)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.resilience as jres
from repro.core import StackedChannel as JStacked
from repro.core import build_topology as jbuild_topology
from repro_torch.core import StackedChannel, build_topology
from repro_torch.launch import train
from repro_torch.resilience import (
    BitCorrupt,
    ChaosChannel,
    ChaosSchedule,
    Drop,
    Duplicate,
    ExtraDelay,
    HealthConfig,
    HealthMonitor,
    NaNInject,
    PeerSilence,
    ResilientChannel,
    _prng,
    fleet_sender_gaps,
    healed_W,
    plan_rejoin,
    rejoin_node,
    reset_rows,
    with_trust,
)
from repro_torch.sim.events import FailStop, Rejoin
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.utils import tree_leaves, tree_paths

RTOL = 1e-6
SCALE = 6.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(n=8, d=5, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _close(got, want, what=""):
    """Finite entries within 1e-6 of the scale; an entry non-finite in the
    port is non-finite in the reference.  (The reference's ``einsum`` mixes
    a corrupted peer's inf into every row, zero weights included, as 0 *
    inf = NaN; the port's mix skips zero weights, so those rows stay what
    their neighbours make them.)"""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert not (~np.isfinite(got) & fin).any(), what
    np.testing.assert_array_equal(np.isnan(got) & ~fin, np.isnan(got), err_msg=what)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), SCALE)
    np.testing.assert_allclose(got[fin].astype(np.float64), want[fin].astype(np.float64),
                               rtol=RTOL, atol=RTOL * scale, err_msg=what)


# ---------------------------------------------------------------------------
# the counter hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1])
def test_hash_matches_jax_random_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == _prng.prng_key(seed)
    for d in (0, 1, 7, 1000, 2 ** 32 - 1):
        assert tuple(np.asarray(jax.random.fold_in(key, d)).tolist()) == _prng.fold_in(
            _prng.prng_key(seed), d)
    for p, shape in ((0.3, (8,)), (1e-3, (6, 1000)), (0.5, (3, 7, 11)), (1.0, (5,)),
                     (0.0, (5,))):
        jk = jax.random.fold_in(jax.random.fold_in(key, 2), 1003)
        pk = _prng.fold_in(_prng.fold_in(_prng.prng_key(seed), 2), 1003)
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        np.testing.assert_array_equal(_prng.bernoulli(pk, p, shape), want)
        np.testing.assert_array_equal(_prng.bernoulli_torch(pk, p, shape, "cpu").numpy(), want)


def test_hash_device_draw_is_chunk_invariant(monkeypatch):
    """A device draw a chunk at a time equals one in a single chunk, and its
    frequency matches ``p``."""
    key = _prng.fold_in(_prng.prng_key(9), 4)
    whole = _prng.bernoulli_torch(key, 0.01, (300, 1000), "cpu")
    monkeypatch.setattr(_prng, "_CHUNK", 4099)
    assert torch.equal(_prng.bernoulli_torch(key, 0.01, (300, 1000), "cpu"), whole)
    assert abs(float(whole.float().mean()) - 0.01) < 1e-3


# ---------------------------------------------------------------------------
# ChaosChannel beside repro's
# ---------------------------------------------------------------------------

J_FAULTS = {"silence": jres.PeerSilence, "drop": jres.Drop, "dup": jres.Duplicate,
            "delay": jres.ExtraDelay, "corrupt": jres.BitCorrupt, "nan": jres.NaNInject}
T_FAULTS = {"silence": PeerSilence, "drop": Drop, "dup": Duplicate, "delay": ExtraDelay,
            "corrupt": BitCorrupt, "nan": NaNInject}

CHAOS_CASES = {
    "silence": ("ring", 4, [("silence", {"nodes": (1,)})]),
    "window": ("ring", 4, [("silence", {"nodes": (2,), "start": 1, "stop": 3})]),
    "dup": ("ring", 4, [("dup", {"nodes": (0,), "prob": 1.0})]),
    "delay": ("ring", 4, [("delay", {"nodes": (3,), "prob": 1.0})]),
    # exp at 4 nodes is the complete graph: a non-finite entry reaches every
    # row in both packages (see _close)
    "corrupt": ("exp", 4, [("corrupt", {"nodes": (2,), "prob": 1.0, "frac": 0.5})]),
    "nan": ("exp", 4, [("nan", {"nodes": (2,), "prob": 1.0, "frac": 0.5})]),
    "mixed": ("exp", 8, [("drop", {"prob": 0.3}), ("dup", {"prob": 0.2, "start": 1}),
                         ("delay", {"nodes": (4, 5), "prob": 0.5}),
                         ("corrupt", {"prob": 0.3, "frac": 0.1, "bit": 22}),
                         ("nan", {"nodes": (6,), "prob": 0.5, "frac": 0.05}),
                         ("silence", {"nodes": (7,), "start": 2, "stop": 4})]),
}


def _schedules(faults, seed=5):
    j = jres.ChaosSchedule(faults=tuple(J_FAULTS[k](**kw) for k, kw in faults), seed=seed)
    t = ChaosSchedule(faults=tuple(T_FAULTS[k](**kw) for k, kw in faults), seed=seed)
    return j, t


@pytest.mark.parametrize("key", sorted(CHAOS_CASES))
def test_chaos_matches_repro_round_by_round(key):
    topo_name, n, faults = CHAOS_CASES[key]
    js, ts = _schedules(faults)
    jch = jres.ChaosChannel(JStacked(jbuild_topology(topo_name, n)), js)
    tch = ChaosChannel(StackedChannel(build_topology(topo_name, n)), ts)
    x0 = _x(n, 64)
    jst, tst = jch.init(jnp.asarray(x0)), tch.init(torch.from_numpy(x0))
    for k in range(5):
        x = _x(n, 64, seed=k + 1)
        xt = torch.from_numpy(x)
        jst, jy = jch.apply(jst, jnp.asarray(x), jnp.int32(k))
        tst, ty = tch.apply(tst, xt, k)
        _close(ty, jy, f"{key} round {k}")
        assert np.array_equal(xt.numpy(), x), "the caller's payload comes back unchanged"
        np.testing.assert_array_equal(tst["x"]["miss"].numpy(), np.asarray(jst["x"]["miss"]))
        for name, v in jst["x"]["events"].items():
            np.testing.assert_array_equal(tst["x"]["events"][name].numpy(), np.asarray(v))
        np.testing.assert_array_equal(tch.version_gaps(tst), np.asarray(jch.version_gaps(jst)))
    assert int(tst["x"]["round"]) == 5
    fired = sum(int(v.sum()) for v in tst["x"]["events"].values())
    assert fired > 0


def test_chaos_empty_schedule_and_closed_windows_are_bitwise_transparent():
    topo = build_topology("ring", 8)
    plain = StackedChannel(topo)
    for sched in (ChaosSchedule(),
                  ChaosSchedule(faults=(PeerSilence(nodes=(0, 1), start=100),
                                        BitCorrupt(nodes=(2,), start=100, prob=1.0,
                                                   frac=1.0)))):
        chaos = ChaosChannel(StackedChannel(topo), sched)
        x = torch.from_numpy(_x())
        sp, cp = plain.init(x), chaos.init(x)
        for k in range(4):
            sp, yp = plain.apply(sp, x, k)
            cp, yc = chaos.apply(cp, x, k)
            assert torch.equal(yp, yc)
            x = yp + 0.1
        assert sum(int(v.sum()) for v in cp["x"]["events"].values()) == 0


def test_chaos_silence_gaps_feed_the_incident_plumbing():
    topo = build_topology("ring", 4)
    chaos = ChaosChannel(StackedChannel(topo), ChaosSchedule(faults=(PeerSilence(nodes=(1,)),)))
    x = torch.from_numpy(_x(4))
    st = chaos.init(x)
    W = np.asarray(topo.W(0))
    st, y = chaos.apply(st, x, 0)
    xz = x.numpy().copy()
    xz[1] = 0.0
    np.testing.assert_allclose(y.numpy(), W @ xz, atol=1e-6)
    st, _ = chaos.apply(st, x, 1)
    assert st["x"]["miss"].tolist() == [0, 2, 0, 0]
    gaps = chaos.version_gaps(st)
    assert gaps[0, 1] == 2 and gaps[2, 1] == 2 and gaps[1, 1] == 0 and gaps[3, 1] == 0
    assert chaos.has_staleness() and chaos.node_gaps(st).tolist() == [2, 2, 2, 0]
    from repro_torch.core.gossip import fleet_node_gaps

    assert fleet_node_gaps(chaos, st).tolist() == [2, 2, 2, 0]


def test_chaos_schedule_from_events_and_validation():
    sched = ChaosSchedule.from_events([FailStop(at_step=10, nodes=(0, 1)),
                                       Rejoin(at_step=20, nodes=(1,))], seed=3)
    assert sched.seed == 3
    by_node = {f.nodes: f for f in sched.faults}
    assert by_node[(1,)].start == 10 and by_node[(1,)].stop == 20
    assert by_node[(0,)].start == 10 and by_node[(0,)].stop is None
    topo = build_topology("ring", 4)
    with pytest.raises(ValueError, match="out of range"):
        ChaosChannel(StackedChannel(topo), ChaosSchedule(faults=(Drop(nodes=(9,)),)))
    with pytest.raises(ValueError, match="empty fault window"):
        ChaosChannel(StackedChannel(topo), ChaosSchedule(faults=(Drop(start=5, stop=5),)))


# ---------------------------------------------------------------------------
# HealthMonitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(), dict(suspect_after=1, dead_after=2, backoff=2.0,
                                              max_retries=1),
                                 dict(suspect_after=2, dead_after=1, max_retries=0,
                                      recover_after=2)])
def test_health_monitor_state_sequences_match_repro(cfg):
    rng = np.random.default_rng(len(cfg))
    jm, tm = jres.HealthMonitor(6, jres.HealthConfig(**cfg)), HealthMonitor(6, HealthConfig(**cfg))
    for r in range(40):
        gaps = rng.integers(0, 4, 6) * (rng.random(6) < 0.4)
        if r == 17:
            jm.report_dead([4]), tm.report_dead([4])
        if r == 25:
            jm.report_alive([4, 5]), tm.report_alive([4, 5])
        np.testing.assert_array_equal(tm.observe(gaps), jm.observe(gaps))
        assert tm.states() == jm.states() and tm.dead() == jm.dead()
    assert tm.rounds == jm.rounds == 40


def test_health_monitor_paper_trail_and_validation():
    """With the defaults a silent peer is SUSPECT from its first missed round
    and DEAD after 3 + 6 suspect rounds (one backed-off retry)."""
    m = HealthMonitor(3)
    seq = []
    for r in range(12):
        m.observe(np.array([0, r + 1, 0]))
        seq.append(m.states()[1])
    assert seq[:8] == ["suspect"] * 8 and seq[8:] == ["dead"] * 4
    assert m.trust.tolist() == [True, False, True] and m.dead() == (1,)
    with pytest.raises(ValueError):
        HealthConfig(suspect_after=0)
    with pytest.raises(ValueError):
        HealthConfig(backoff=0.5)
    with pytest.raises(ValueError, match="gaps"):
        m.observe(np.zeros(4))


def test_fleet_sender_gaps_attribute_staleness_to_the_sender():
    topo_j, topo_t = jbuild_topology("exp", 8), build_topology("exp", 8)
    faults = [("silence", {"nodes": (3,), "start": 1}), ("drop", {"prob": 0.4})]
    js, ts = _schedules(faults)
    jch, tch = jres.ChaosChannel(JStacked(topo_j), js), ChaosChannel(StackedChannel(topo_t), ts)
    x = _x(8)
    jst, tst = jch.init(jnp.asarray(x)), tch.init(torch.from_numpy(x))
    for k in range(4):
        jst, _ = jch.apply(jst, jnp.asarray(x), jnp.int32(k))
        tst, _ = tch.apply(tst, torch.from_numpy(x), k)
        np.testing.assert_array_equal(fleet_sender_gaps(tch, tst),
                                      jres.fleet_sender_gaps(jch, jst))
    assert fleet_sender_gaps(tch, tst)[3] >= 3  # silent from round 1 (and maybe dropped at 0)
    assert fleet_sender_gaps(StackedChannel(topo_t), {}).tolist() == [0] * 8


# ---------------------------------------------------------------------------
# ResilientChannel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ring", "exp", "one-peer-exp"])
def test_healed_w_matches_repro_and_stays_stochastic(name):
    rng = np.random.default_rng(1)
    topo_t, topo_j = build_topology(name, 8), jbuild_topology(name, 8)
    for t in range(topo_t.period):
        for _ in range(4):
            alive = rng.random(8) < 0.7
            Wh = healed_W(topo_t, t, alive)
            np.testing.assert_array_equal(Wh, jres.healed_W(topo_j, t, alive))
            np.testing.assert_allclose(Wh.sum(axis=1), 1.0, atol=1e-12)
        np.testing.assert_array_equal(healed_W(topo_t, t, np.ones(8, bool)),
                                      np.asarray(topo_t.W(t), np.float64))
    with pytest.raises(ValueError, match="alive mask"):
        healed_W(topo_t, 0, np.ones(7, bool))


def test_resilient_clean_path_is_bit_exact():
    topo = build_topology("exp", 8)
    plain, res = StackedChannel(topo), ResilientChannel(StackedChannel(topo))
    x = torch.from_numpy(_x())
    sp, sr = plain.init(x), res.init(x)
    for k in range(4):
        sp, yp = plain.apply(sp, x, k)
        sr, yr = res.apply(sr, x, k)
        assert torch.equal(yp, yr)
        x = yp * 0.9
    assert int(sr["res"]["quarantined"].sum()) == 0 and sr["res"]["lg_ok"].all()


@pytest.mark.parametrize("name", ["ring", "one-peer-exp"])
def test_resilient_distrust_applies_healed_w(name):
    topo, jtopo = build_topology(name, 8), jbuild_topology(name, 8)
    res, jres_ch = ResilientChannel(StackedChannel(topo)), jres.ResilientChannel(JStacked(jtopo))
    alive = np.array([1, 1, 0, 1, 1, 1, 1, 0], bool)
    x = _x()
    st = with_trust(res.init(torch.from_numpy(x)), alive)
    jst = jres.with_trust(jres_ch.init(jnp.asarray(x)), alive)
    xj = jnp.asarray(x)
    for k in range(topo.period):
        xt = torch.from_numpy(x)
        st, y = res.apply(st, xt, k)
        jst, xj_out = jres_ch.apply(jst, xj, jnp.int32(k))
        assert np.array_equal(xt.numpy(), x)
        want = healed_W(topo, k, alive) @ x.astype(np.float64)
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        _close(y, xj_out, f"{name} round {k}")
        x, xj = y.numpy().copy(), xj_out


def test_resilient_guards_quarantine_nan_payload():
    topo = build_topology("ring", 4)
    res = ResilientChannel(StackedChannel(topo))
    x = torch.from_numpy(_x(4))
    st = res.init(x)
    st, _ = res.apply(st, x, 0)  # a clean round seeds last-good
    poisoned = x.clone()
    poisoned[1, 2] = float("nan")
    st, y = res.apply(st, poisoned, 1)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(topo.W(1)) @ x.numpy(), atol=1e-6)
    assert st["res"]["quarantined"].tolist() == [0, 1, 0, 0]
    assert torch.isnan(poisoned[1, 2]), "the caller's payload comes back unchanged"


def test_resilient_receiver_guard_without_last_good():
    """First-round poison (no last-good yet): the receiver guard keeps the
    other nodes finite by falling back to their own payloads.  Node 3 is
    not a ring neighbour of node 1: the port's mix skips its zero weight,
    so node 3 keeps its real mix, where the reference's ``einsum`` makes it
    0 * NaN and falls back (ROADMAP.md, accepted differences)."""
    topo = build_topology("ring", 4)
    res, jres_ch = ResilientChannel(StackedChannel(topo)), jres.ResilientChannel(
        JStacked(jbuild_topology("ring", 4)))
    x = _x(4)
    x[1, :] = np.nan
    st, y = res.apply(res.init(torch.from_numpy(x)), torch.from_numpy(x), 0)
    jst, jy = jres_ch.apply(jres_ch.init(jnp.asarray(x)), jnp.asarray(x), jnp.int32(0))
    assert torch.isfinite(y[[0, 2, 3]]).all()
    _close(y[:3], np.asarray(jy)[:3])
    W = np.asarray(topo.W(0), np.float64)
    np.testing.assert_allclose(y[3].numpy(), W[3, [0, 2, 3]] @ x[[0, 2, 3]], atol=1e-6)
    assert st["res"]["quarantined"].tolist() == [1, 2, 1, 0]
    assert np.asarray(jst["res"]["quarantined"]).tolist() == [1, 2, 1, 1]


def test_with_trust_validates_and_broadcasts():
    res = ResilientChannel(StackedChannel(build_topology("ring", 4)))
    st = res.init(torch.from_numpy(_x(4)))
    with pytest.raises(ValueError, match="ResilientChannel state"):
        with_trust({"nope": 1}, np.ones(4, bool))
    with pytest.raises(ValueError, match="shape"):
        with_trust(st, np.ones(5, bool))
    bucket = {"res": {"trust": torch.ones((2, 4), dtype=torch.bool)}}
    out = with_trust(bucket, np.array([1, 0, 1, 1], bool))
    assert out["res"]["trust"].shape == (2, 4) and not out["res"]["trust"][:, 1].any()


def test_resilient_composes_over_chaos_as_repro():
    """Silence injected one layer down, healed one layer up: with the
    silent peer distrusted, the mix is healed_W's; with it trusted, the
    survivors mix its zeros; a NaN-poisoned peer is caught by the receiver
    guard (the reference's, round by round, on the complete graph of exp at
    4 nodes, where a non-finite entry reaches every row in both packages)."""
    n = 4
    for trust_it in (False, True):
        faults = [("silence", {"nodes": (3,)}), ("nan", {"nodes": (2,), "prob": 1.0,
                                                         "frac": 0.2, "start": 1})]
        js, ts = _schedules(faults)
        jch = jres.ResilientChannel(jres.ChaosChannel(JStacked(jbuild_topology("exp", n)), js))
        tch = ResilientChannel(ChaosChannel(StackedChannel(build_topology("exp", n)), ts))
        alive = np.ones(n, bool)
        alive[3] = trust_it
        x = _x(n, 16)
        jst = jres.with_trust(jch.init(jnp.asarray(x)), alive)
        tst = with_trust(tch.init(torch.from_numpy(x)), alive)
        for k in range(3):
            jst, jy = jch.apply(jst, jnp.asarray(x), jnp.int32(k))
            tst, ty = tch.apply(tst, torch.from_numpy(x), k)
            _close(ty, jy, f"trust={trust_it} round {k}")
            if not trust_it and k == 0:
                np.testing.assert_allclose(ty.numpy(), healed_W(build_topology("exp", n), 0,
                                                                alive) @ x, atol=1e-5)
            assert torch.isfinite(ty).all()
        np.testing.assert_array_equal(tst["res"]["quarantined"].numpy(),
                                      np.asarray(jst["res"]["quarantined"]))


# ---------------------------------------------------------------------------
# Checkpoint-free recovery
# ---------------------------------------------------------------------------


def test_reset_rows_and_rejoin_node_match_repro():
    n, d = 4, 3
    rng = np.random.default_rng(0)
    p, m = rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal(
        (n, d)).astype(np.float32)
    donor = {"w": np.full(d, 7.0, np.float32)}
    want = jres.rejoin_node({"params": {"w": jnp.asarray(p)}, "opt": {"m": {"w": jnp.asarray(m)}}},
                            2, donor)
    state = {"params": {"w": torch.from_numpy(p.copy())},
             "opt": {"m": {"w": torch.from_numpy(m.copy())}}}
    out = rejoin_node(state, 2, donor)
    np.testing.assert_array_equal(out["params"]["w"].numpy(), np.asarray(want["params"]["w"]))
    np.testing.assert_array_equal(out["opt"]["m"]["w"].numpy(), np.asarray(want["opt"]["m"]["w"]))
    with pytest.raises(ValueError, match="no leading node axis"):
        reset_rows({"bad": torch.zeros((n + 1, d))}, 0, n)
    with pytest.raises(ValueError, match="out of range"):
        rejoin_node(state, 9, donor)
    with pytest.raises(ValueError, match="does not match row"):
        rejoin_node(state, 1, {"w": np.zeros(d + 1, np.float32)})
    plan = plan_rejoin("ring", 8, still_dead=[])
    jplan = jres.plan_rejoin("ring", 8, still_dead=[])
    assert (plan.mode, plan.n_nodes, plan.dead) == (jplan.mode, jplan.n_nodes, jplan.dead)
    plan = plan_rejoin("exp", 8, still_dead=[5])
    jplan = jres.plan_rejoin("exp", 8, still_dead=[5])
    assert (plan.mode, plan.n_nodes, plan.dead) == (jplan.mode, jplan.n_nodes, jplan.dead)
    np.testing.assert_array_equal(plan.topology.W(0), np.asarray(jplan.topology.W(0)))


def test_rejoin_via_publisher_snapshot_round_trip():
    """The checkpoint-free path on the stacked layout: the donor publishes
    through the consensus gate, the rejoiner takes a materialized copy, then
    gossip pulls it back toward the survivors' consensus."""
    from repro_torch.core.planes import PlaneLayout
    from repro_torch.serve import WeightPublisher

    n, d = 8, 6
    topo = build_topology("ring", n)
    ch = StackedChannel(topo)
    x = torch.from_numpy(_x(n, d, seed=4))
    pub = WeightPublisher(PlaneLayout.build({"w": torch.zeros(d)}), gap_threshold=0)
    assert pub.offer({"w": x[0].clone()}, version=1, gap=0)
    snap = pub.current.materialize()
    assert pub.offer({"w": x[1].clone()}, version=2, gap=0)
    assert pub.offer({"w": x[2].clone()}, version=3, gap=0)
    state = {"params": {"w": x.clone()}, "opt": {"m": torch.ones((n, d))}}
    state = rejoin_node(state, 3, snap.params)
    assert torch.equal(state["params"]["w"][3], x[0])
    assert not state["opt"]["m"][3].any()
    y = state["params"]["w"]
    for k in range(40):
        _, y = ch.apply({}, y, k)
    assert float((y - y.mean(dim=0)).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# The CLI: --chaos and --resilient
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3-0.6b", "--smoke", "--seq-len", "16", "--per-node-batch", "2",
       "--fused-update", "--fused-impl", "torch", "--flat-planes", "--device", "cpu",
       "--log-every", "100"]


def _reference_states(gaps_per_step, n=4):
    m = jres.HealthMonitor(n)
    out = []
    for g in gaps_per_step:
        m.observe(np.asarray(g))
        out.append(m.states())
    return out


def test_cli_chaos_resilient_stacked_health_and_quarantine():
    """Node 1 silent for steps 2..11 under the defaults: its sender gap is
    the miss count, the monitor's states equal the reference monitor's on
    the same gaps (SUSPECT from the first missed round, distrusted; DEAD
    after 3 + 6 suspect rounds, and DEAD stays); then node 2's NaN round is
    quarantined and every loss stays finite."""
    res = train.main(["--nodes", "4", "--steps", "14", *CLI,
                      "--chaos", "silence,nodes=1,start=2,stop=12",
                      "--chaos", "nan,nodes=2,frac=0.01,start=12,stop=13,prob=1", "--resilient"])
    gaps = [[0, 0, 0, 0]] * 2 + [[0, k, 0, 0] for k in range(1, 11)] + [[0, 0, 0, 0]] * 2
    want = _reference_states(gaps)
    assert [s for _, s in res["health"]] == want
    assert want[2][1] == "suspect" and want[-1][1] == "dead"
    # exp at 4 nodes is the complete graph: every receiver sees the NaNs once
    assert res["quarantined"] == [1, 1, 1, 1]
    assert all(np.isfinite(res["losses"]))


def _final_state(path):
    host, _ = restore_checkpoint(str(path))
    tree = {"params": host["params"], "opt": host["opt"]}
    return dict(zip(tree_paths(tree), tree_leaves(tree))), host


def test_cli_resume_equals_unbroken_with_the_wrappers_state(tmp_path):
    """A run checkpointed at step 3 and resumed to 6 equals the unbroken
    run bit for bit: parameters, optimizer state, and the channel state —
    the chaos round counter and events, the last-good payload, the
    quarantine count, the inner channel's residual and telemetry."""
    args = ["--nodes", "4", *CLI, "--compression", "int8-row-ef",
            "--chaos", "dup,prob=0.4", "--chaos", "nan,nodes=1,frac=0.02,prob=0.5",
            "--resilient", "--ckpt-every", "3"]
    train.main(["--steps", "6", "--ckpt-dir", str(tmp_path / "a"), *args])
    # the unbroken run's step-3 checkpoint, resumed to step 6 (the same
    # --steps, so the same lr schedule)
    shutil.copytree(tmp_path / "a" / "step_00000003", tmp_path / "b" / "step_00000003")
    train.main(["--steps", "6", "--ckpt-dir", str(tmp_path / "b"), "--resume", *args])
    (a, ha), (b, hb) = _final_state(tmp_path / "a"), _final_state(tmp_path / "b")
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ca = dict(zip(tree_paths(ha["channel"]), tree_leaves(ha["channel"])))
    cb = dict(zip(tree_paths(hb["channel"]), tree_leaves(hb["channel"])))
    # resilient outside, chaos inside it, the compressed stacked channel in
    assert sorted(ca) == sorted(cb) and "in/x/round" in ca and "res/lg/float32" in ca
    for k in ca:  # by their bits: the NaN-poisoned node's residual holds NaNs
        assert ca[k].dtype == cb[k].dtype and torch.equal(
            ca[k].reshape(-1).view(torch.uint8), cb[k].reshape(-1).view(torch.uint8)), k
    assert int(ca["in/x/round"]) == 6 and int(ca["in/x/events/dup"].sum()) > 0
    assert float(ca["in/in/comp/float32"].abs().nansum()) > 0


def test_cli_chaos_resilient_simulate_nodes_matches_stacked(tmp_path):
    """4 gloo ranks under the same schedule: the same fires on every rank
    (so the same health states, gathered by ``fleet_sender_gaps``) and the
    final parameters within the reference's distributed-vs-oracle
    tolerance of the stacked run."""
    chaos = ["--chaos", "silence,nodes=1,start=1,stop=3", "--chaos", "drop,prob=0.3",
             "--resilient"]
    st = train.main(["--nodes", "4", "--steps", "4", *CLI, *chaos,
                     "--ckpt-dir", str(tmp_path / "s")])
    dt = train.main(["--simulate-nodes", "4", "--steps", "4", *CLI, *chaos, "--timeout", "120",
                     "--ckpt-dir", str(tmp_path / "d")])
    assert dt["health"] == st["health"] and any("suspect" in s for _, s in st["health"])
    np.testing.assert_allclose(dt["losses"], st["losses"], rtol=1e-5)
    a, _ = _final_state(tmp_path / "s")
    b, _ = _final_state(tmp_path / "d")
    assert sorted(a) == sorted(b)
    err = max(float((a[k] - b[k]).abs().max()) for k in a if k.startswith("params"))
    assert err < 2e-5
    assert dt["quarantined"] == st["quarantined"]
