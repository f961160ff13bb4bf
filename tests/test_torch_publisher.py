"""The port's weight publisher, the engine's snapshot swaps and serving
while training, mirroring ``tests/test_serve_publisher.py`` and the
engine's swap tests at tensor-parallel degree 1.

* the zero-copy snapshot views are byte-exact with ``unpack`` and alias the
  bucket buffers; the host pack equals the reference's;
* double buffering gives one publish of grace; the gate rejects a gap over
  the threshold (a stale node never publishes) and versions must advance;
  a plane-dict source is one copy per bucket;
* ``fleet_node_gaps`` of the staleness-free channel is all zeros;
* the engine swaps snapshots between decode batches, token for token with
  the reference's engine fed the same snapshots, and waits while the gate
  holds the first version back;
* ``--serve-while-training`` runs on the CPU at the smoke config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_lm as jtiny_lm
from repro.core import gossip as jgossip
from repro.core import topology as jtopo
from repro.core.planes import PlaneLayout as JPlaneLayout
from repro.models import transformer as jT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import WeightPublisher as JWeightPublisher
from repro_torch.configs import tiny_lm as ttiny_lm
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopo
from repro_torch.core.planes import LANES, PlaneLayout
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tT
from repro_torch.serve import Request, ServeEngine, WeightPublisher
from repro_torch.utils import tree_leaves, tree_map


def _tmpl(seed=0):
    """A mixed-dtype tree (the reference test's shapes) as numpy."""
    import ml_dtypes

    r = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    return {
        "emb": r.standard_normal((40, 33)).astype(bf),
        "w1": r.standard_normal((13, 7)).astype(np.float32),
        "w2": r.standard_normal((2000,)).astype(bf),
        "b": r.standard_normal((5,)).astype(np.float32),
    }


def _layout():
    return PlaneLayout.build(from_numpy(_tmpl()))


def _same_bytes(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def test_view_unpack_byte_exact_with_unpack_and_the_reference_host_pack():
    tree = from_numpy(_tmpl(1))
    lay = PlaneLayout.build(tree)
    planes = lay.host_pack(tree)
    views, full = lay.view_unpack(planes), lay.unpack(planes)
    for key in tree:
        assert _same_bytes(views[key], full[key]) and _same_bytes(views[key], tree[key])
        bucket = planes[str(views[key].dtype).removeprefix("torch.")]
        lo = bucket.data_ptr()
        assert lo <= views[key].data_ptr() < lo + bucket.numel() * bucket.element_size()
    jtree = jax.tree.map(jnp.asarray, _tmpl(1))
    want = JPlaneLayout.build(jtree).host_pack(jtree)
    got = to_numpy(planes)
    for key in want:
        assert got[key].shape == (lay.rows[key], LANES)
        assert got[key].tobytes() == want[key].tobytes()


def test_publisher_double_buffer_grace():
    """A held snapshot survives the next publish but its buffer is rewritten
    by the publish after that — the documented hazard; ``materialize`` keeps
    an owned copy."""
    pub = WeightPublisher(_layout(), gap_threshold=0, check_consistency=True)
    trees = [from_numpy(_tmpl(seed)) for seed in (3, 4, 5)]
    assert pub.current is None
    assert pub.offer(trees[0], version=1, gap=0)
    held = pub.current
    owned = held.materialize()
    assert torch.equal(held.params["w1"], trees[0]["w1"])
    assert pub.offer(trees[1], version=2, gap=0)
    assert torch.equal(held.params["w1"], trees[0]["w1"])  # still intact
    assert pub.current.version == 2 and torch.equal(pub.current.params["w1"], trees[1]["w1"])
    assert pub.offer(trees[2], version=3, gap=0)  # rewrites held's buffer
    assert torch.equal(held.params["w1"], trees[2]["w1"])
    assert torch.equal(owned.params["w1"], trees[0]["w1"])
    assert torch.equal(owned.planes["float32"], PlaneLayout.build(trees[0]).host_pack(
        trees[0])["float32"])


def test_publisher_gate_and_stats_mirror_the_reference():
    """The same offers through both publishers: the same decisions, errors
    and stats."""
    pubs = (WeightPublisher(_layout(), gap_threshold=1),
            JWeightPublisher(JPlaneLayout.build(jax.tree.map(jnp.asarray, _tmpl())),
                             gap_threshold=1))
    srcs = (lambda s: from_numpy(_tmpl(s)), lambda s: _tmpl(s))
    for pub, src in zip(pubs, srcs):
        assert not pub.offer(src(6), version=1, gap=2)  # over the threshold
        assert pub.current is None and pub.last_rejected_gap == 2
        assert pub.offer(src(6), version=1, gap=1)  # at the threshold: ships
        assert pub.current.version == 1 and pub.current.gap == 1
        with pytest.raises(ValueError, match="advance"):
            pub.offer(src(7), version=1, gap=0)
        assert pub.offer(src(7), version=4, gap=0)  # gaps in versions are fine
    assert pubs[0].stats() == pubs[1].stats()
    s = pubs[0].stats()
    assert s["offers"] == 4 and s["published"] == 2 and s["rejected"] == 1
    assert s["publish_rate"] == 0.5 and s["current_version"] == 4


def test_stale_node_never_publishes():
    """A node whose gap stays over the threshold after a warm-up ships only
    the warm-up rounds; a fresh node ships every round (the reference's
    gap sequence min(3, t) on its delayed ring)."""
    stale, fresh = (WeightPublisher(_layout(), gap_threshold=1) for _ in range(2))
    tree = from_numpy(_tmpl(9))
    for t in range(6):
        stale.offer(tree, version=t + 1, gap=min(3, t))
        fresh.offer(tree, version=t + 1, gap=0)
    assert stale.published == 2 and stale.current.version == 2
    assert stale.rejected == 4 and stale.last_rejected_gap == 3
    assert fresh.published == 6 and fresh.current.version == 6


def test_publisher_plane_dict_source_is_one_copy_per_bucket():
    tree = from_numpy(_tmpl(8))
    lay = PlaneLayout.build(tree)
    planes = lay.pack(tree)
    pub = WeightPublisher(lay, check_consistency=True)
    assert pub.offer(planes, version=1, gap=0)
    for key in tree:
        assert _same_bytes(pub.current.params[key], tree[key])
    planes["float32"].zero_()  # the publisher copied: the snapshot is intact
    assert torch.equal(pub.current.params["w1"], tree["w1"])
    with pytest.raises(ValueError, match="plane"):
        pub.offer({k: v[:1] for k, v in planes.items()}, version=2, gap=0)


def test_fleet_node_gaps_staleness_free_and_the_delayed_branch():
    ch = tgossip.StackedChannel(ttopo.build_topology("ring", 4))
    state = ch.init({"w": torch.zeros(4, 6)})
    gaps = tgossip.fleet_node_gaps(ch, state)
    assert gaps.dtype == np.int32 and gaps.tolist() == [0, 0, 0, 0]

    # the delayed branch: a ring with one edge of delay 3, against the
    # reference's gaps after each round (round 0 is fresh)
    D = np.zeros((4, 4), np.int64)
    D[1, 2] = 3
    tch = tgossip.DelayedStackedChannel(ttopo.build_topology("ring", 4), D)
    jch = jgossip.DelayedStackedChannel(jtopo.build_topology("ring", 4), D)
    tst, jst = tch.init({"w": torch.zeros(4, 6)}), jch.init({"w": jnp.zeros((4, 6))})
    for step in range(4):
        x = np.random.default_rng(step).standard_normal((4, 6)).astype(np.float32)
        tst, _ = tch.apply(tst, {"w": torch.from_numpy(x)}, step)
        jst, _ = jch.apply(jst, {"w": jnp.asarray(x)}, step)
        gaps = tgossip.fleet_node_gaps(tch, tst)
        assert gaps.dtype == np.int32
        np.testing.assert_array_equal(gaps, jgossip.fleet_node_gaps(jch, jst))
    assert gaps.tolist() == [0, 3, 3, 0]


# ---------------------------------------------------------------------------
# the engine's swaps, against the reference's engine
# ---------------------------------------------------------------------------

ECFG_J = jtiny_lm(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)
ECFG_T = ttiny_lm(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)
MAX_PROMPT, MAX_NEW = 12, 6


def _prompts(n, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, ECFG_J.vocab_size, size=int(r.integers(2, MAX_PROMPT + 1)))
            .astype(np.int32) for _ in range(n)]


def _engines(params):
    jpub = JWeightPublisher(JPlaneLayout.build(jax.tree.map(jnp.asarray, params)),
                            gap_threshold=0, check_consistency=True)
    tpub = WeightPublisher(PlaneLayout.build(from_numpy(params)), gap_threshold=0,
                           check_consistency=True)
    jeng = JServeEngine(ECFG_J, jax.make_mesh((1, 1), ("data", "model")), slots=2,
                        max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                        runtime=jT.RuntimeConfig(dtype="float32", remat=False), publisher=jpub)
    teng = ServeEngine(ECFG_T, slots=2, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                       publisher=tpub, device="cpu", runtime=tT.RuntimeConfig("float32"))
    return (jpub, jeng, JRequest, lambda p: p), (tpub, teng, Request, from_numpy)


def test_engine_swaps_between_decode_batches_token_for_token_with_jax():
    """Wave 1 on v1, v2 published mid-wave (the in-flight requests finish on
    it, the swap lands at a tick boundary), wave 2 on v2: the port's engine
    gives the reference engine's tokens, with one swap counted."""
    pa = jax.device_get(jT.init_params(jax.random.key(0), ECFG_J))
    pb = jax.device_get(jT.init_params(jax.random.key(1), ECFG_J))
    prompts = _prompts(4, seed=2)
    out = []
    for pub, eng, req, conv in _engines(pa):
        assert pub.offer(conv(pa), version=1, gap=0)
        for i in range(2):
            eng.submit(req(rid=i, tokens=prompts[i], max_new_tokens=MAX_NEW))
        for _ in range(2):
            eng.tick()
        batches = eng.decode_batches
        assert pub.offer(conv(pb), version=2, gap=0)
        assert eng.version == 1  # nothing swaps until the next tick
        eng.tick()
        assert eng.version == 2 and eng.decode_batches == batches + 1
        for i in range(2, 4):
            eng.submit(req(rid=i, tokens=prompts[i], max_new_tokens=MAX_NEW))
        done = {c.rid: np.asarray(c.tokens) for c in eng.run_until_drained()}
        assert eng.stats()["swaps"] == 1 and eng.stats()["version"] == 2
        out.append(done)
    want, got = out
    assert sorted(got) == [0, 1, 2, 3]
    for rid in range(4):
        np.testing.assert_array_equal(got[rid], want[rid], str(rid))


def test_engine_waits_on_gated_publisher_and_needs_weights():
    params = jax.device_get(jT.init_params(jax.random.key(0), ECFG_J))
    pub = WeightPublisher(PlaneLayout.build(from_numpy(params)), gap_threshold=0)
    eng = ServeEngine(ECFG_T, slots=2, max_prompt=MAX_PROMPT, max_new=3, publisher=pub,
                      device="cpu", runtime=tT.RuntimeConfig("float32"))
    prompt = _prompts(1, seed=3)[0]
    eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=3))
    assert not pub.offer(from_numpy(params), version=1, gap=5)  # the gate holds it
    for _ in range(3):
        assert eng.tick()
    assert eng.waiting_ticks == 3 and eng.decode_batches == 0 and eng.prefills == 0
    assert pub.offer(from_numpy(params), version=2, gap=0)
    done = eng.run_until_drained()
    ref = ServeEngine(ECFG_T, slots=2, max_prompt=MAX_PROMPT, max_new=3,
                      params=from_numpy(params), device="cpu",
                      runtime=tT.RuntimeConfig("float32"))
    ref.submit(Request(rid=0, tokens=prompt, max_new_tokens=3))
    np.testing.assert_array_equal(done[0].tokens, ref.run_until_drained()[0].tokens)
    assert eng.stats()["swaps"] == 0 and eng.version == 2
    with pytest.raises(ValueError, match="publisher"):
        ServeEngine(ECFG_T, slots=1, max_prompt=4, max_new=2, device="cpu")


# ---------------------------------------------------------------------------
# serving while training, on the CPU
# ---------------------------------------------------------------------------

CLI = ["--nodes", "4", "--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--seq-len", "16",
       "--per-node-batch", "2", "--log-every", "1", "--fused-update", "--device", "cpu"]
SERVE = ["--serve-while-training", "--publish-every", "2", "--serve-requests", "5"]


@pytest.mark.parametrize("flat", [True, False], ids=["flat-planes", "per-leaf"])
def test_serve_while_training_cli_on_cpu(flat, monkeypatch):
    """Node 0 publishes every 2 steps (a plane-dict source on the flat-plane
    path, a tree on the per-leaf path); every offer ships, each snapshot is
    node 0's parameters byte for byte, the engine swaps once and completes
    every request; the losses are those of the run without serving."""
    seen = {"checked": 0}
    build = tlaunch.build_train_step

    def build_spy(*args, **kw):
        step_fn, channel = build(*args, **kw)

        def spy(state, batch):
            state, met = step_fn(state, batch)
            seen["node0"] = tree_map(lambda t: t[0].clone(), state["params"])
            return state, met

        return spy, channel

    def hook(engine, pub):
        offer = pub.offer

        def checked(src, **kw):
            shipped = offer(src, **kw)
            for a, b in zip(tree_leaves(pub.current.params), tree_leaves(seen["node0"])):
                assert _same_bytes(a, b)
            seen["checked"] += 1
            return shipped

        pub.offer = checked
        seen["engine"] = engine

    extra = ["--flat-planes"] if flat else []
    monkeypatch.setattr(tlaunch, "build_train_step", build_spy)
    res = tlaunch.main(CLI + extra + SERVE, on_serve=hook)
    monkeypatch.undo()
    plain = tlaunch.main(CLI + extra)
    assert res["losses"] == plain["losses"]
    ps, es = res["serve"]["publisher"], res["serve"]["engine"]
    assert ps["offers"] == ps["published"] == seen["checked"] == 2
    assert es["swaps"] == 1 and es["version"] == 3 and res["serve"]["completed"] == 5
    assert seen["engine"].idle and "serve" not in plain
