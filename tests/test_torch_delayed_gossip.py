"""The port's stacked gossip channels — delayed, compressed, both — against
the JAX package's ``StackedChannel`` / ``DelayedStackedChannel`` on the
same numpy payloads: five rounds of mixes, ring buffers and residuals, and
the version gaps the staleness-aware algorithm and the serving gate read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import topology as jtopo
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopo
from repro_torch.core.planes import PlaneLayout
from repro_torch.interop import from_numpy, to_numpy

N = 4
ROUNDS = 5
# mixes sum a few f32 products in another order than XLA's einsum, and the
# reference's jitted branches (period > 1) may contract ``x32 - decoded``
# into an FMA: each compares at 1e-6 of the payloads' scale (standard
# normal draws, |x| < 5), which also bounds a residual's error
RTOL = 1e-6
SCALE = 5.0
# per-leaf payload shapes per node: a matrix, two 1024-wide plane rows and
# a vector (int8-row takes one scale per row of each)
LEAVES = {"a": (6, 33), "p": (2, 1024), "v": (257,)}
COMPRESSORS = [None, "bf16", "int8", "int8-row", "int8-row-ef", "topk:0.1"]
# a delay matrix: every edge its own delay (the diagonal is zeroed)
DMAT = np.array([[0, 1, 2, 0], [2, 0, 1, 1], [0, 3, 0, 2], [1, 0, 2, 0]])
DELAYS = {"d0": 0, "d1": 1, "d2": 2, "dmat": DMAT}


def _payload(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in LEAVES.items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), SCALE)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _tree_close(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], f"{what}/{k}")
        else:
            assert np.shape(got[k]) == np.shape(want[k]), (f"{what}/{k}", np.shape(got[k]),
                                                           np.shape(want[k]))
            _close(got[k], want[k], f"{what}/{k}")


def _channels(family, delay, compression, calls):
    jt, tt = jtopo.build_topology(family, N), ttopo.build_topology(family, N)
    kw = dict(calls_per_step=calls, compression=compression, telemetry=True)
    return (jgossip.DelayedStackedChannel(jt, delay, **kw),
            tgossip.DelayedStackedChannel(tt, delay, **kw))


def _run(family, delay, compression, calls=1):
    """Five steps of ``calls`` gossip calls each on fresh payloads, both
    packages; every mix, the final state and the gaps after every step are
    held against the reference."""
    jch, tch = _channels(family, delay, compression, calls)
    tmpl = _payload(0)
    jst = jch.init(jax.tree.map(jnp.asarray, tmpl))
    tst = tch.init(from_numpy(tmpl))
    for step in range(ROUNDS):
        for c in range(calls):
            x = _payload(1 + step * calls + c)
            jst, jmix = jch.apply(jst, jax.tree.map(jnp.asarray, x), step)
            tst, tmix = tch.apply(tst, from_numpy(x), step)
            _tree_close(to_numpy(tmix), jax.device_get(jmix), f"mix {step}.{c}")
        np.testing.assert_array_equal(tch.version_gaps(tst),
                                      np.asarray(jch.version_gaps(jst)))
        want_nodes = np.asarray(jch.node_gaps(jst))
        got_nodes = tch.node_gaps(tst)
        if want_nodes.ndim:
            assert got_nodes.dtype == torch.int32
            np.testing.assert_array_equal(got_nodes.numpy(), want_nodes)
        else:
            assert got_nodes == int(want_nodes) == 0
        np.testing.assert_array_equal(tgossip.fleet_node_gaps(tch, tst),
                                      jgossip.fleet_node_gaps(jch, jst))
    _tree_close(to_numpy(tst), jax.device_get(jst), "state")
    return tch, tst


@pytest.mark.parametrize("compression", COMPRESSORS, ids=str)
@pytest.mark.parametrize("delay", DELAYS, ids=str)
@pytest.mark.parametrize("family", ["exp", "one-peer-exp"])
def test_delayed_channel_matches_jax(family, delay, compression):
    _run(family, DELAYS[delay], compression)


@pytest.mark.parametrize("compression", [None, "int8-row-ef"], ids=str)
def test_two_calls_per_step_keep_their_own_rings(compression):
    """da-dmsgd's two gossips per step: one ring slot per call, rotated."""
    tch, tst = _run("exp", 1, compression, calls=2)
    assert sorted(tst["delay"]) == ["s0", "s1"]
    assert [int(s["count"]) for s in tst["delay"].values()] == [ROUNDS, ROUNDS]


@pytest.mark.parametrize("compression", COMPRESSORS, ids=str)
@pytest.mark.parametrize("family", ["exp", "one-peer-exp"])
def test_delay_zero_is_the_stacked_channel_bitwise(family, compression):
    """Within the port: delay 0 runs the stacked channel's code, bit for bit,
    state included; neither reports staleness."""
    topo = ttopo.build_topology(family, N)
    a = tgossip.DelayedStackedChannel(topo, 0, compression=compression, telemetry=True)
    b = tgossip.StackedChannel(topo, compression=compression, telemetry=True)
    sa, sb = a.init(from_numpy(_payload(0))), b.init(from_numpy(_payload(0)))
    assert "delay" not in sa and not a.has_staleness()
    for step in range(ROUNDS):
        x = _payload(10 + step)
        sa, ma = a.apply(sa, from_numpy(x), step)
        sb, mb = b.apply(sb, from_numpy(x), step)
        for k in LEAVES:
            assert torch.equal(ma[k], mb[k]), (step, k)
    for (ka, va), (kb, vb) in zip(sorted(to_numpy(sa).items()), sorted(to_numpy(sb).items())):
        assert ka == kb
        jax.tree.map(np.testing.assert_array_equal, va, vb)
    assert a.node_gaps(sa) == 0
    assert tgossip.fleet_node_gaps(a, sa).tolist() == [0] * N


@pytest.mark.parametrize("compression", COMPRESSORS, ids=str)
def test_stacked_channel_compressed_matches_jax(compression):
    """The undelayed compressed mix ``diag * x + Woff @ decode(encode(x))``
    and its residual, against the reference's stacked channel."""
    jch = jgossip.StackedChannel(jtopo.build_topology("exp", N), compression=compression,
                                 telemetry=True)
    tch = tgossip.StackedChannel(ttopo.build_topology("exp", N), compression=compression,
                                 telemetry=True)
    jst = jch.init(jax.tree.map(jnp.asarray, _payload(0)))
    tst = tch.init(from_numpy(_payload(0)))
    for step in range(ROUNDS):
        x = _payload(20 + step)
        jst, jmix = jch.apply(jst, jax.tree.map(jnp.asarray, x), step)
        tst, tmix = tch.apply(tst, from_numpy(x), step)
        _tree_close(to_numpy(tmix), jax.device_get(jmix), f"mix {step}")
    _tree_close(to_numpy(tst), jax.device_get(jst), "state")
    assert float(tst["t"]["bytes"]) == float(jst["t"]["bytes"])


def test_delay_matrix_and_warmup_gaps():
    D = tgossip.delay_matrix(N, DMAT)
    np.testing.assert_array_equal(D, jgossip.delay_matrix(N, DMAT))
    assert (np.diag(D) == 0).all()
    with pytest.raises(ValueError):
        tgossip.delay_matrix(N, -1)
    with pytest.raises(ValueError):
        tgossip.delay_matrix(N, np.zeros((3, 3)))
    ch = tgossip.DelayedStackedChannel(ttopo.build_topology("ring", N), 3)
    st = ch.init(from_numpy(_payload(0)))
    seen = []
    for step in range(5):
        st, _ = ch.apply(st, from_numpy(_payload(step)), step)
        seen.append(tgossip.fleet_node_gaps(ch, st).tolist())
    # round 0 is fresh; the gap grows with the rounds recorded, up to 3
    assert seen == [[0] * N, [1] * N, [2] * N, [3] * N, [3] * N]


@pytest.mark.parametrize("compression", [None, "int8-row-ef"], ids=str)
@pytest.mark.parametrize("delay", [0, 1], ids=["undelayed", "delay1"])
def test_a_leaf_mixes_to_the_same_bits_alone_and_inside_a_plane(delay, compression):
    """The mix is an elementwise sum in a fixed order, so each element of a
    leaf comes out the same whether the leaf is mixed alone or as rows of a
    plane (a BLAS product rounds a 3584-wide leaf otherwise than the plane
    holding it).  Compressed, leaves of 1024-wide rows, so that int8-row
    scales the same rows both ways (on a plane it scales each plane row)."""
    rng = np.random.default_rng(7)
    leaves = ({"a": (3, 1024), "b": (7, 512), "c": (5, 2048), "d": (3584,)} if compression is None
              else {"a": (3, 1024), "b": (2, 1024), "c": (5, 1024)})
    layout = PlaneLayout.build({k: torch.empty(s, device="meta") for k, s in leaves.items()})
    topo = ttopo.build_topology("exp", N)
    rounds = [{k: torch.from_numpy(rng.standard_normal((N,) + s).astype(np.float32))
               for k, s in leaves.items()} for _ in range(3)]
    make = lambda: tgossip.DelayedStackedChannel(topo, delay, compression=compression)
    per_leaf, plane = make(), make()
    sl = per_leaf.init(rounds[0])
    sp = plane.init(layout.pack(rounds[0], leading=1))
    for step, x in enumerate(rounds):
        sl, ml = per_leaf.apply(sl, x, step)
        sp, mp = plane.apply(sp, layout.pack(x, leading=1), step)
        views = layout.view_unpack(mp, leading=1)
        for k in leaves:
            assert torch.equal(views[k], ml[k]), (step, k)
