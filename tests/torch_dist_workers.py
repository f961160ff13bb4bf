"""Rank bodies that the distributed port tests spawn (one process per node,
gloo on the CPU).  Each is a module-level function, picklable by the spawn
start method; it imports the port inside, so that the blocked-import check
can hide ``jax`` and ``repro`` before the port loads."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_cases as C  # noqa: E402


def gossip_cases(group) -> dict:
    """Every case of ``torch_dist_cases`` through the port's distributed
    channels: this rank's mixes and gaps per round, its final channel
    state, the psum mean of payload 0, and each channel's
    ``collectives_per_round`` / ``bytes_per_step``."""
    import torch

    from repro_torch.core import gossip as G
    from repro_torch.core.topology import build_topology

    from repro_torch import resilience as R
    from repro_torch.sparse import build_sparse_channel
    from repro_torch.utils import tree_leaves

    kinds = {"silence": R.PeerSilence, "drop": R.Drop, "dup": R.Duplicate,
             "delay": R.ExtraDelay, "corrupt": R.BitCorrupt, "nan": R.NaNInject}
    me = slice(group.rank, group.rank + 1)
    out = {}
    for key, case in C.CASES.items():
        topo = build_topology(case["family"], C.N)
        if case.get("dead"):
            topo = topo.exclude(case["dead"])
        if case["kind"] == "allgather":
            ch = G.build_channel("allgather", topo, group, telemetry=True)
        elif case["kind"] == "delayed":
            ch = G.build_channel("ppermute", topo, group, delay=case["delay"],
                                 calls_per_step=case["calls"], telemetry=True)
        elif case["kind"] == "sparse":
            ch = build_sparse_channel("ppermute", topo, group, mode=case["mode"],
                                      delay=case["delay"], compression=case["compression"],
                                      calls_per_step=case.get("calls", 1), telemetry=True,
                                      chunk_bytes=4096)
        elif case["kind"] in ("chaos", "resilient"):
            sched = R.ChaosSchedule(faults=tuple(kinds[k](**kw) for k, kw in case["faults"]),
                                    seed=11)
            ch = R.ChaosChannel(G.build_channel("ppermute", topo, group, telemetry=True,
                                                chunk_bytes=4096), sched)
            if case["kind"] == "resilient":
                ch = R.ResilientChannel(ch)
        else:
            ch = G.build_channel("ppermute", topo, group, compression=case["compression"],
                                 telemetry=True, chunk_bytes=4096)
        st = ch.init({k: torch.from_numpy(v[me].copy()) for k, v in C.payload(0).items()})
        if "trust" in case:
            st = R.with_trust(st, np.asarray(case["trust"], bool))
        dirty = []
        for r, (step, seed) in enumerate(C.rounds(case)):
            x = {k: torch.from_numpy(v[me].copy()) for k, v in C.payload(seed).items()}
            if case["kind"] == "sparse":
                st = ch.mark(st, {k: torch.from_numpy(v[group.rank].copy())
                                  for k, v in C.masks(case, seed).items()})
            st, mix = ch.apply(st, x, step)
            if case["kind"] == "sparse" and case["mode"] == "exact":
                # what this round shipped: each leaf's agreed mask, its rows
                dirty.append([int(d[0].sum()) for d in tree_leaves(st["rows"]["dirty"])])
            for k, v in mix.items():
                out[f"{key}/mix/{r}/{k}"] = v.numpy()
            out[f"{key}/gaps/{r}"] = np.asarray(ch.node_gaps(st), np.int32).reshape(1)
            out[f"{key}/fleet_gaps/{r}"] = G.fleet_node_gaps(ch, st)
        for path, leaf in _flat(st):
            out[f"{key}/state/{path}"] = leaf.numpy()
        if case["kind"] == "sparse":
            out[f"{key}/sent"] = (ch.sent_bytes, dirty)
        payload = {k: torch.zeros((1,) + s) for k, s in C.LEAVES.items()}
        out[f"{key}/collectives"] = ch.collectives_per_round(payload)
        out[f"{key}/bytes"] = ch.bytes_per_step(4.0 * sum(int(np.prod(s))
                                                          for s in C.LEAVES.values()))
    mean = G.make_psum_mean(group, C.N)
    for k, v in mean({k: torch.from_numpy(v[me].copy())
                      for k, v in C.payload(0).items()}).items():
        out[f"psum_mean/{k}"] = v.numpy()
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def wire_chunks(group, chunk_bytes) -> dict:
    """One exchange around a ring through ``_Wire`` at ``chunk_bytes``, once
    directly and once through host buffers (the group marked ``staged``);
    returns what this rank received each way and the bytes it staged."""
    import dataclasses

    import torch

    from repro_torch.core.gossip import _Wire

    class Staged(type(group)):
        staged = True

    g = Staged(**{f.name: getattr(group, f.name) for f in dataclasses.fields(group)})
    out = {}
    for staged, grp in (("plain", group), ("staged", g)):
        wire = _Wire(grp, chunk_bytes)
        n = group.world
        send = torch.arange(10007, dtype=torch.float32) + 1e5 * group.rank
        got = torch.full((10007,), float("nan"))

        def consume(lo, hi, piece):
            got[lo:hi] = piece

        wire.stream(send, send.numel(), torch.float32, send.device, (group.rank + 1) % n,
                    (group.rank - 1) % n, consume)
        out[staged] = got.numpy()
        out[f"{staged}_bytes"] = wire.staged_bytes
    return out


def blocked_import(group) -> list:
    """Hide ``jax`` and ``repro`` from this rank's imports, then import every
    module of the port and run one gossip round; returns the modules of
    either package that got loaded (none)."""
    import importlib
    import pkgutil

    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            del sys.modules[name]
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch

    import repro_torch

    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if not info.name.endswith("._triton"):
            importlib.import_module(info.name)
    from repro_torch.core.gossip import build_channel
    from repro_torch.core.topology import build_topology

    ch = build_channel("ppermute", build_topology("ring", group.world), group)
    ch.apply(ch.init({"a": torch.ones(1, 4)}), {"a": torch.ones(1, 4)}, 0)
    return sorted(n for n, m in sys.modules.items()
                  if m is not None and n.split(".")[0] in ("jax", "jaxlib", "repro"))


# the distributed step against the stacked step: (name, model, TrainConfig
# fields, what the final parameters are held to: the reference's
# distributed-vs-oracle tolerance, "finite", or None for a run kept only for
# the bitwise pairs)
TRAIN_CASES = [
    ("smoke-ppermute-leaf", "smoke", {}, 2e-5),
    ("smoke-ppermute-planes", "smoke", {"flat_planes": True}, 2e-5),
    ("smoke-ppermute-planes-plain", "smoke", {"flat_planes": True, "fused_impl": "torch"}, None),
    ("smoke-optimizer-step", "smoke", {"fused_update": False}, 2e-5),
    ("smoke-allgather-planes", "smoke", {"flat_planes": True, "gossip_impl": "allgather"}, 2e-5),
    ("smoke-sa-delay1-planes", "smoke", {"flat_planes": True, "algorithm": "decentlam-sa",
                                         "gossip_delay": 1}, 2e-5),
    ("smoke-pmsgd-planes", "smoke", {"flat_planes": True, "algorithm": "pmsgd"}, 2e-5),
    ("smoke-da-dmsgd", "smoke", {"algorithm": "da-dmsgd"}, 2e-5),
    ("smoke-lars-clip-planes", "smoke", {"flat_planes": True, "algorithm": "pmsgd-lars",
                                         "grad_clip": 0.5, "weight_decay": 1e-2}, 2e-5),
    ("smoke-grad-accum-consensus", "smoke", {"grad_accum": 2, "track_consensus": True,
                                             "topology": "ring"}, 2e-5),
    ("smoke-bf16", "smoke", {"flat_planes": True, "compression": "bf16"}, 5e-2),
    ("smoke-int8-row-ef", "smoke", {"flat_planes": True, "compression": "int8-row-ef"}, "finite"),
    ("smoke-topk", "smoke", {"compression": "topk:0.05"}, "finite"),
    ("tiny-ppermute", "tiny", {}, 2e-5),
    ("tiny-sa-delay2", "tiny", {"algorithm": "decentlam-sa", "gossip_delay": 2}, 2e-5),
    # row-sparse gossip against the stacked step's dense gossip (exact mode
    # equals it); delta mode is lossy and only kept finite
    ("smoke-sparse-exact-planes", "smoke", {"flat_planes": True, "sparse_gossip": True}, 2e-5),
    ("moe-sparse-exact-planes", "moe", {"flat_planes": True, "sparse_gossip": True}, 2e-5),
    ("smoke-sparse-exact-sa-delay1", "smoke", {"flat_planes": True, "sparse_gossip": True,
                                               "algorithm": "decentlam-sa",
                                               "gossip_delay": 1}, 2e-5),
    ("smoke-sparse-delta-planes", "smoke", {"flat_planes": True, "sparse_gossip": True,
                                            "sparse_mode": "delta"}, None),
    # chaos and the resilient layer: every rank draws the same fires
    ("smoke-chaos-resilient-planes", "smoke", {"flat_planes": True, "resilient": True,
                                               "chaos": "silence,nodes=1,start=1,stop=3;"
                                                        "drop,prob=0.3;nan,nodes=2,frac=0.01,"
                                                        "prob=1,start=2"}, 2e-5),
]
TRAIN_LR = 3e-3
TRAIN_STEPS = 3
TRAIN_BITWISE = [("smoke-ppermute-planes", "smoke-ppermute-leaf"),
                 ("smoke-ppermute-planes", "smoke-ppermute-planes-plain")]


def _train_setup(model, fields):
    from repro_torch.configs import get_config, tiny_lm
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.train.step import TrainConfig

    from repro_torch.launch.train import _parse_chaos

    cfg = (get_config("qwen3-0.6b", smoke=True) if model == "smoke"
           else get_config("granite-moe-1b-a400m", smoke=True) if model == "moe"
           else tiny_lm(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=256))
    if "chaos" in fields:  # the CLI's specs, ";"-joined
        fields = {**fields, "chaos": _parse_chaos(fields["chaos"].split(";"), 0)}
    tcfg = TrainConfig(**{"fused_update": True, "fused_impl": "triton",
                          "schedule": ScheduleConfig(kind="warmup_cosine", peak_lr=TRAIN_LR,
                                                     warmup_steps=1, total_steps=TRAIN_STEPS),
                          **fields})
    return cfg, tcfg


def _comparable(state, layout):
    from repro_torch.utils import tree_leaves, tree_paths

    opt = state.get("opt", {})
    if layout is not None:
        opt = {k: layout.view_unpack(v, leading=1) for k, v in opt.items()}
    tree = {"params": state["params"], "opt": opt}
    return dict(zip(tree_paths(tree), tree_leaves(tree)))


def _run(group, build, n, cfg, tcfg, layout):
    import torch

    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.train_state import init_train_state

    step_fn, channel = build()
    state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), n, device=group.device,
                             channel=channel, plane_layout=layout)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         per_node_batch=4, n_nodes=group.world,
                                         heterogeneity=0.5))
    metrics = []
    for k in range(TRAIN_STEPS):
        batch = {key: torch.from_numpy(v) for key, v in data.batch(k).items()}
        state, m = step_fn(state, batch)
        metrics.append({key: float(v) for key, v in m.items()})
    return state, metrics


def train_cases(group) -> dict:
    """Every TRAIN_CASES configuration on the distributed step (this rank's
    node), gathered to rank 0, which runs the stacked step on the same
    config and returns per case the losses, the metrics, the largest
    differences of the final parameters and optimizer state, whether all
    is finite and the telemetry; and the bitwise pairs."""
    import dataclasses

    import torch

    from repro_torch.train.step import build_dist_train_step, build_train_step
    from repro_torch.train.train_state import gather_state, model_plane_layout

    out, finals = {}, {}
    for name, model, fields, tol in TRAIN_CASES:
        cfg, tcfg = _train_setup(model, fields)
        layout = model_plane_layout(cfg) if tcfg.flat_planes else None
        state, metrics = _run(group, lambda: build_dist_train_step(cfg, tcfg, group), 1, cfg,
                              tcfg, layout)
        host = gather_state(state, group)
        if host is None:
            continue
        got = _comparable(host, layout)
        inner = host["channel"]
        while "in" in inner:  # the resilience wrappers nest the transport's state
            inner = inner["in"]
        res = {"metrics": metrics,
               "finite": all(bool(torch.isfinite(v).all()) for v in got.values()),
               "tele": (inner["t"]["bytes"].numpy(), inner["t"]["rounds"].numpy()),
               "comp_nonzero": float(sum(v.abs().sum() for v in
                                         _leaves(inner.get("comp", {}))))}
        if "rows" in inner:
            res["vol"] = {k: v.numpy() for k, v in inner["rows"]["vol"].items()}
        if "res" in host["channel"]:
            res["quarantined"] = host["channel"]["res"]["quarantined"].numpy()
        if any(name in pair for pair in TRAIN_BITWISE):
            finals[name] = got
        if tol is not None and tol != "finite":
            # the stacked step gossips densely (exact sparse gossip equals it)
            scfg = dataclasses.replace(tcfg, sparse_gossip=False)
            sstate, smetrics = _run(group, lambda: build_train_step(cfg, scfg, group.world),
                                    group.world, cfg, scfg, layout)
            want = _comparable(sstate, layout)
            assert sorted(want) == sorted(got), name
            res["stacked_metrics"] = smetrics
            res["err"] = {part: max(float((got[k] - want[k]).abs().max()) for k in want
                                    if k.startswith(part)) for part in ("params", "opt")}
        out[name] = res
    if group.rank == 0:
        out["bitwise"] = {
            f"{a} == {b}": sorted(finals[a]) == sorted(finals[b]) and all(
                torch.equal(finals[a][k].view(torch.uint8), finals[b][k].view(torch.uint8))
                for k in finals[a])
            for a, b in TRAIN_BITWISE}
        out["delay0"] = _delay0_all_algorithms(group)
    else:
        _delay0_all_algorithms(group)
    return out


def _leaves(tree):
    from repro_torch.utils import tree_leaves

    return tree_leaves(tree) if tree else []


def _delay0_all_algorithms(group) -> dict:
    """``DelayedPpermuteChannel`` at delay 0 == ``PpermuteChannel``: two
    updates of every algorithm on seeded payloads, bit for bit (the
    reference's claim for its distributed channels); rank 0 returns the
    verdict of every rank per algorithm."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.gossip import DelayedPpermuteChannel, PpermuteChannel, make_psum_mean
    from repro_torch.core.optimizers import ALGORITHMS, OptimizerConfig, make_optimizer
    from repro_torch.core.topology import build_topology
    from repro_torch.core.update_spec import run_update, update_spec

    topo = build_topology("exp", group.world)
    rng = np.random.default_rng(40 + group.rank)
    verdict = {}
    for algo in ALGORITHMS:
        ocfg = OptimizerConfig(algorithm=algo, momentum=0.9)
        opt = make_optimizer(ocfg)
        x = {"a": torch.from_numpy(rng.standard_normal((1, 5, 7)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((1, 33)).astype(np.float32))}
        g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in x.items()}
        outs = []
        for ch in (PpermuteChannel(topo, group, telemetry=True),
                   DelayedPpermuteChannel(topo, group, 0, calls_per_step=opt.gossips_per_step,
                                          telemetry=True)):
            xs, st, cs = {k: v.clone() for k, v in x.items()}, opt.init(x), ch.init(x)
            for step in range(2):
                xs, st, cs = run_update(update_spec(ocfg), ocfg, x=xs, g=g, state=st, lr=0.05,
                                        step_idx=step, gossip=ch,
                                        mean=make_psum_mean(group, group.world), comp_state=cs)
            outs.append((xs, st))
        same = all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in x)
        flags = [None] * group.world
        dist.all_gather_object(flags, same, group=group.pg)
        verdict[algo] = all(flags)
    return verdict


def check_shrink(grid, gathered, now):
    """``on_shrink`` hook: the survivors' rebuilt state, gathered again to
    rank 0 (``now``), against ``elastic_reshape`` of the state gathered
    before the shrink; rank 0 returns ``(tensors compared, paths that
    differ, channel fresh)``."""
    import torch

    from repro_torch.train.checkpoint import elastic_reshape
    from repro_torch.utils import tree_leaves, tree_paths

    if now is None:
        return None
    want = elastic_reshape(gathered, grid.nodes)
    ta = {k: now[k] for k in ("params", "opt")}
    tb = {k: want[k] for k in ("params", "opt")}
    pa, pb = dict(zip(tree_paths(ta), tree_leaves(ta))), dict(zip(tree_paths(tb), tree_leaves(tb)))
    differ = [k for k in pb if k not in pa or not torch.equal(pa[k], pb[k])]
    fresh = all(not bool(t.any()) for t in tree_leaves(now.get("channel", {})))
    return len(pb), differ, fresh


def cost_ranks(group) -> dict:
    """One distributed train step of a small dense model per algorithm
    (decentlam: the ppermute gossip; pmsgd: the psum mean) under the cost
    model's recorder: this rank's collective bytes and counts, the f32
    payload's bytes, each leaf's bytes and the number of per-node sums the
    step's metrics all-reduce (test_torch_costmodel.py)."""
    import torch

    from repro_torch.configs import tiny_lm
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.launch.costmodel import CostRecorder
    from repro_torch.train.step import TrainConfig, build_dist_train_step
    from repro_torch.train.train_state import init_train_state
    from repro_torch.utils import tree_leaves

    cfg = tiny_lm(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128)
    out = {}
    for algo in ("decentlam", "pmsgd"):
        tcfg = TrainConfig(algorithm=algo, fused_update=True)
        step, channel = build_dist_train_step(cfg, tcfg, group)
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), 1,
                                 device=torch.device("cpu"), channel=channel)
        gen = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (group.world * 2, 8), generator=gen)
                 for k in ("tokens", "targets")}
        rec = CostRecorder()
        with rec:
            _, metrics = step(state, batch)
        leaves = [4 * p.numel() for p in tree_leaves(state["params"])]
        reduced = set(metrics) - {"lr", "skipped_nonfinite", "gossip_gap"}
        out[algo] = {"bytes": rec.costs.collective_bytes,
                     "counts": rec.costs.collective_counts,
                     "payload_bytes": float(sum(leaves)), "leaf_bytes": leaves,
                     "n_sums": len(reduced) + 1}
    return out
