"""The JAX side of ``tests/test_torch_dist_gossip.py``: ``repro``'s
distributed channels (``PpermuteChannel``, ``DelayedPpermuteChannel``,
``AllgatherChannel``, the sparse ppermute channels, ``ChaosChannel`` and
``ResilientChannel`` over ppermute, ``make_psum_mean``) run inside ``shard_map`` on 8
simulated CPU devices, on the seeded payloads of ``torch_dist_cases``, and
their mixes, states and gaps written to an npz.

Run as a script (the test runs it in a subprocess, because the pytest
process's jax has one device)::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/torch_dist_ref.py out.npz
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_cases as C  # noqa: E402


def main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import gossip as G
    from repro.core.topology import build_topology

    if len(jax.devices()) != C.N:
        raise SystemExit(f"need {C.N} devices, have {len(jax.devices())}")
    mesh = jax.make_mesh((C.N,), ("data",))
    axes = ("data",)
    out: dict[str, np.ndarray] = {}

    def spec(tree):
        return jax.tree.map(lambda a: P("data", *([None] * (a.ndim - 1))), tree)

    def topo_of(case):
        topo = build_topology(case["family"], C.N)
        return topo.exclude(case["dead"]) if case.get("dead") else topo

    from repro import resilience as R
    from repro import sparse as S

    kinds = {"silence": R.PeerSilence, "drop": R.Drop, "dup": R.Duplicate,
             "delay": R.ExtraDelay, "corrupt": R.BitCorrupt, "nan": R.NaNInject}

    for key, case in C.CASES.items():
        topo = topo_of(case)
        if case["kind"] == "allgather":
            ch = G.AllgatherChannel(topo, axes, telemetry=True)
        elif case["kind"] == "delayed":
            ch = G.DelayedPpermuteChannel(topo, axes, case["delay"],
                                          calls_per_step=case["calls"], telemetry=True)
        elif case["kind"] == "sparse":
            ch = S.build_sparse_channel("ppermute", topo, axes, mode=case["mode"],
                                        delay=case["delay"], compression=case["compression"],
                                        calls_per_step=case.get("calls", 1), telemetry=True)
        elif case["kind"] in ("chaos", "resilient"):
            sched = R.ChaosSchedule(faults=tuple(kinds[k](**kw) for k, kw in case["faults"]),
                                    seed=11)
            ch = R.ChaosChannel(G.PpermuteChannel(topo, axes, telemetry=True), sched)
            if case["kind"] == "resilient":
                ch = R.ResilientChannel(ch)
        else:
            ch = G.PpermuteChannel(topo, axes, compression=case["compression"], telemetry=True)
        tmpl = jax.tree.map(lambda a: jnp.asarray(a[0]), C.payload(0))
        st = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (C.N,) + a.shape), ch.init(tmpl))
        if "trust" in case:
            st = R.with_trust(st, np.asarray(case["trust"], bool))
        sparse = case["kind"] == "sparse"

        def body(s, x, m, step, ch=ch, sparse=sparse):
            s1 = jax.tree.map(lambda a: a[0], s)
            x1 = jax.tree.map(lambda a: a[0], x)
            if sparse:
                s1 = ch.mark(s1, jax.tree.map(lambda a: a[0], m))
            s1, mix = ch.apply(s1, x1, step)
            gap = jnp.int32(ch.node_gaps(s1))
            return (jax.tree.map(lambda a: a[None], s1), jax.tree.map(lambda a: a[None], mix),
                    gap[None])

        x0 = {k: jnp.asarray(v) for k, v in C.payload(0).items()}
        m0 = {k: jnp.asarray(v) for k, v in C.masks(case, 0).items()}
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec(st), spec(x0), spec(m0), P()),
                               out_specs=(spec(st), spec(x0), P("data")),
                               axis_names={"data"}))
        for r, (step, seed) in enumerate(C.rounds(case)):
            x = {k: jnp.asarray(v) for k, v in C.payload(seed).items()}
            m = {k: jnp.asarray(v) for k, v in C.masks(case, seed).items()}
            st, mix, gaps = fn(st, x, m, jnp.int32(step))
            for k, v in mix.items():
                out[f"{key}/mix/{r}/{k}"] = np.asarray(v)
            out[f"{key}/gaps/{r}"] = np.asarray(gaps)
        for path, leaf in jax.tree_util.tree_flatten_with_path(st)[0]:
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            out[f"{key}/state/{name}"] = np.asarray(leaf)

    # the exact mean (pmsgd / slowmo), one call on payload 0
    mean = G.make_psum_mean(axes, C.N)
    x0 = {k: jnp.asarray(v) for k, v in C.payload(0).items()}
    fn = jax.jit(shard_map(lambda x: mean(x), mesh=mesh, in_specs=(spec(x0),),
                           out_specs=spec(x0), axis_names={"data"}))
    for k, v in fn(x0).items():
        out[f"psum_mean/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
