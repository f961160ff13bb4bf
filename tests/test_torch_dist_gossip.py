"""The port's distributed gossip channels — ``PpermuteChannel`` (every
compressor), ``DelayedPpermuteChannel``, ``AllgatherChannel``, the
row-sparse ppermute channels (exact, delta, delayed exact), ``ChaosChannel``
and ``ResilientChannel`` over ppermute, and ``make_psum_mean`` — on 8 gloo
CPU ranks, one process per node, against
``repro``'s channels inside ``shard_map`` on 8 simulated devices, on the
same seeded numpy payloads for 3 steps (``torch_dist_cases``).  The JAX side
runs in one subprocess per module (this process's jax has one device), the
port's in one spawned group of 8 ranks per module."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_cases as C
import torch_dist_workers as W
from repro.core import gossip as jgossip
from repro.core import topology as jtopo
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopo
from repro_torch.launch.mesh import NodeGroup, pick_backend, run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
# mixes in f32: the compressors are repro's bit for bit, the sums may round
# in another order; 1e-6 of the payloads' scale (standard normal, |x| < 6)
RTOL = 1e-6
SCALE = 6.0
# every spawned group's deadline, so that a hung rank fails its test
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_dist_ref.py"), out],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port():
    """The 8 ranks' results, each key's rank slices joined along the node
    axis (scalars and the per-channel counts from rank 0)."""
    per_rank = run_ranks(W.gossip_cases, C.N, device="cpu", timeout_s=TIMEOUT_S)
    out = {}
    for k, v in per_rank[0].items():
        if isinstance(v, np.ndarray) and "/fleet_gaps/" not in k:
            out[k] = np.concatenate([r[k] for r in per_rank])
        else:
            out[k] = v
    out["_ranks"] = per_rank
    return out


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    scale = max(float(np.abs(want).max(initial=0.0)), SCALE)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("key", sorted(C.CASES))
def test_channel_matches_repro_over_three_steps(key, ref, port):
    """Every round's mix, the final state (residuals, rings, counts,
    telemetry per node: ``repro``'s trainer layout) and the per-node gaps."""
    keys = [k for k in ref if k.startswith(f"{key}/")]
    assert keys and sorted(keys) == sorted(k for k in port if k.startswith(f"{key}/")
                                           and "/fleet_gaps/" not in k
                                           and k not in (f"{key}/collectives", f"{key}/bytes",
                                                         f"{key}/sent"))
    for k in keys:
        _close(port[k], ref[k], k)


@pytest.mark.parametrize("sparse,dense", [("sparse-exact-exp-all", "ppermute-exp-none"),
                                          ("sparse-delta-exp-all", "ppermute-exp-none"),
                                          ("sparse-exact-exp-d1-all", "delayed-exp-d1"),
                                          ("resilient-exp-clean", "ppermute-exp-none")])
def test_all_dirty_sparse_and_clean_resilient_equal_dense_bit_for_bit(sparse, dense, port):
    """Within the port: every row dirty, the sparse channels' mixes are the
    dense channel's bits (exact, delta, delayed exact); a clean resilient
    layer (no fault, every peer trusted) is transparent."""
    rounds = len(C.rounds(C.CASES[dense]))
    assert rounds == len(C.rounds(C.CASES[sparse]))
    for r in range(rounds):
        for k in C.LEAVES:
            a, b = port[f"{sparse}/mix/{r}/{k}"], port[f"{dense}/mix/{r}/{k}"]
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
                sparse, r, k)


@pytest.mark.parametrize("key", [k for k, c in C.CASES.items() if c["kind"] == "sparse"
                                 and c["mode"] == "exact" and not c["compression"]])
def test_sparse_wire_carries_only_the_dirty_rows(key, port):
    """Exact mode ships the agreed mask's rows and nothing else (their
    indices are implied by the mask): each rank sent, per round, its dirty
    rows' f32 bytes along each of the phase's edge classes it sends on."""
    case = C.CASES[key]
    topo = ttopo.build_topology(case["family"], C.N)
    for rank, res in enumerate(port["_ranks"]):
        sent, dirty = res[f"{key}/sent"]
        want = 0
        for (step, _), counts in zip(C.rounds(case), dirty):
            sends = sum(1 for c in topo.edge_classes(step % topo.period) if c.perm[rank] >= 0)
            for (name, shape), k in zip(sorted(C.LEAVES.items()), counts):
                want += sends * 4 * k * int(np.prod(shape[1:]))
        assert sent == want, (key, rank)
        dense = sum(sends * 4 * int(np.prod(s)) for s in C.LEAVES.values()
                    for sends in [len(topo.edge_classes(0))]) * len(dirty)
        if not case.get("all"):
            assert sent < dense


def test_psum_mean_matches_repro(ref, port):
    for k in C.LEAVES:
        _close(port[f"psum_mean/{k}"], ref[f"psum_mean/{k}"], k)


@pytest.mark.parametrize("key", ["delayed-exp-d0", "delayed-exp-d1", "delayed-exp-d2",
                                 "ppermute-exp-none"])
def test_fleet_node_gaps_gather_every_ranks_gap(key, ref, port):
    """fleet_node_gaps on any rank == the vector of every node's gap."""
    rounds = len(C.rounds(C.CASES[key]))
    for r in range(rounds):
        want = ref[f"{key}/gaps/{r}"]
        for rank in port["_ranks"]:
            np.testing.assert_array_equal(rank[f"{key}/fleet_gaps/{r}"], want)


@pytest.mark.parametrize("key", ["ppermute-exp-none", "ppermute-one-peer-exp-int8-row-ef",
                                 "ppermute-ring-topk:0.25", "delayed-exp-d1", "allgather-exp"])
def test_collectives_and_bytes_match_repro(key, port):
    """``collectives_per_round`` (classes x leaves x message parts; one
    all_gather per leaf) and ``bytes_per_step`` equal the reference's."""
    import jax.numpy as jnp

    case = C.CASES[key]
    topo = jtopo.build_topology(case["family"], C.N)
    if case["kind"] == "allgather":
        ch = jgossip.AllgatherChannel(topo, ("data",))
    elif case["kind"] == "delayed":
        ch = jgossip.DelayedPpermuteChannel(topo, ("data",), case["delay"])
    else:
        ch = jgossip.PpermuteChannel(topo, ("data",), compression=case["compression"])
    payload = {k: jnp.zeros(s) for k, s in C.LEAVES.items()}
    assert port[f"{key}/collectives"] == ch.collectives_per_round(payload)
    nbytes = 4.0 * sum(int(np.prod(s)) for s in C.LEAVES.values())
    assert port[f"{key}/bytes"] == pytest.approx(ch.bytes_per_step(nbytes))


def test_partial_permutation_delivers_nothing_to_the_dead_node(port):
    """Node 3 of the excluded exp graph receives nothing: its mix is its own
    payload at self-weight 1, as ppermute's zeros give."""
    key = "ppermute-exp-partial"
    for r, (_, seed) in enumerate(C.rounds(C.CASES[key])):
        for k, v in C.payload(seed).items():
            np.testing.assert_array_equal(port[f"{key}/mix/{r}/{k}"][3], v[3])


def _fake_group(world=8, rank=0):
    return NodeGroup(rank=rank, world=world, backend="gloo", device=torch.device("cpu"))


@pytest.mark.parametrize("kwargs,match", [
    ({"impl": "allgather", "delay": 1}, "no delayed variant"),
    ({"impl": "allgather", "compression": "int8"}, "cannot compress"),
    ({"impl": "ppermute", "delay": 1, "compression": "bf16"}, "does not support message"),
    ({"impl": "bogus"}, "unknown gossip impl"),
])
def test_build_channel_raises_as_repro(kwargs, match):
    impl = kwargs.pop("impl")
    topo = ttopo.build_topology("exp", 8)
    with pytest.raises(ValueError, match=match):
        tgossip.build_channel(impl, topo, _fake_group(), **kwargs)
    with pytest.raises(ValueError, match=match):
        jgossip.build_channel(impl, jtopo.build_topology("exp", 8), ("data",), **kwargs)


def test_build_channel_needs_a_group_and_a_matching_size():
    topo = ttopo.build_topology("ring", 8)
    with pytest.raises(ValueError, match="needs a node group"):
        tgossip.build_channel("ppermute", topo)
    with pytest.raises(ValueError, match="group of 4 ranks"):
        tgossip.build_channel("ppermute", topo, _fake_group(world=4))
    assert isinstance(tgossip.build_channel("stacked", topo, delay=1),
                      tgossip.DelayedStackedChannel)


@pytest.mark.parametrize("chunk_bytes", [40, 4096, 1 << 26])
def test_wire_chunks_and_host_staging_equal_one_unchunked_send(chunk_bytes):
    """The exchange helper at any chunk size, directly and through host
    buffers, delivers what the left neighbour sent; the staged path counts
    its bytes both ways."""
    got = run_ranks(W.wire_chunks, 3, chunk_bytes, device="cpu", timeout_s=TIMEOUT_S)
    for rank, res in enumerate(got):
        want = np.arange(10007, dtype=np.float32) + np.float32(1e5 * ((rank - 1) % 3))
        np.testing.assert_array_equal(res["plain"], want)
        np.testing.assert_array_equal(res["staged"], want)
        assert res["plain_bytes"] == 0 and res["staged_bytes"] == 2 * 4 * 10007


@pytest.mark.parametrize("rank,world,device,cards,want", [
    (0, 4, "cpu", 0, ("gloo", "cpu")),
    (2, 4, "cpu", 8, ("gloo", "cpu")),
    (3, 4, "cuda", 4, ("nccl", "cuda:3")),
    (1, 4, "cuda", 8, ("nccl", "cuda:1")),
    (3, 4, "cuda", 1, ("gloo", "cuda:0")),
    (1, 2, "cuda", 1, ("gloo", "cuda:0")),
])
def test_backend_and_device_per_rank(rank, world, device, cards, want):
    """NCCL with a card per rank, gloo on card 0 when ranks share it, gloo
    on the CPU on request."""
    assert pick_backend(rank, world, device, cards) == want


def test_backend_choice_never_falls_back_to_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_backend(0, 4, "cuda", 0)
    with pytest.raises(ValueError):
        pick_backend(0, 4, "tpu", 1)


BLOCK = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    if not n.endswith("._triton"):
        importlib.import_module(n)
import chip_smoke
bad = [n for n, m in sys.modules.items() if m is not None and n.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, import with ``jax`` and
    ``repro`` blocked in ``sys.modules``; so does a spawned rank, which then
    gossips one round."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.path.join(HERE, "..")]))
    proc = subprocess.run([sys.executable, "-c", BLOCK], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) > 30
    loaded = run_ranks(W.blocked_import, 2, device="cpu", timeout_s=TIMEOUT_S)
    assert loaded == [[], []]
