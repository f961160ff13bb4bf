"""Rank bodies of ``tests/test_torch_tp.py`` (module-level, so that the
``spawn`` start method can pickle them): each runs on one gloo CPU rank of
a group that ``repro_torch.launch.mesh.run_ranks`` spawns, and returns
numpy results for the test to compare."""

import numpy as np

import torch_tp_cases as C


def _tree(z, prefix: str) -> dict:
    """The nested dict of an npz's ``prefix``-ed '/'-joined paths."""
    out: dict = {}
    for key in z.files:
        if key.startswith(prefix):
            *parents, last = key[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return out


def _unpadded(params, cfg, tp):
    """tp's global parameters cut to tp = 1's shapes (the padded q heads and
    vocabulary rows dropped): the same model at tp = 1."""
    import copy

    hd, h, v = cfg.hd, cfg.n_heads, cfg.vocab_size
    p = copy.deepcopy(params)
    p["embed"]["table"] = p["embed"]["table"][:v]
    if "lm_head" in p:
        p["lm_head"]["w"] = p["lm_head"]["w"][:, :v]
    for g in [*p["groups"].values(), *p.get("enc", {}).values()]:
        for name in ("attn", "cross"):
            if name in g:
                g[name]["wq"] = g[name]["wq"][..., :h * hd]
                g[name]["wo"] = g[name]["wo"][:, :h * hd]
    return p


def serve_ranks(world, npz_path: str) -> dict:
    """On the (4, 2) grid: each SERVE_CASES case's sharded prefill and
    decode logits (the full batch and the one-request fallback) from
    repro's global parameters, gathered; then, on ENGINE_CASE, the
    continuous-batching engine on the grid, its completions and its first
    decode batch's logits, beside rank 0's engine on one process (tp = 1)."""
    import torch

    from repro_torch.configs import tiny_lm
    from repro_torch.interop import from_numpy, shard
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine, WeightPublisher
    from repro_torch.train import serve as S
    from repro_torch.train.train_state import model_plane_layout
    from repro_torch.utils import tree_leaves

    grid = init_grid(world, C.TP)
    rt = T.RuntimeConfig(dtype="float32")
    out = {}
    with np.load(npz_path) as z:
        for name, kw in C.SERVE_CASES.items():
            cfg = tiny_lm(**kw)
            params = from_numpy(_tree(z, f"{name}/params/"))
            toks = torch.from_numpy(C.serve_tokens(cfg.vocab_size).astype(np.int64))
            scfg = S.ServeConfig(runtime=rt, target_len=C.S + C.EXTRA)
            axes, _, split = S.serve_specs(cfg, grid, global_batch=C.B)
            mine = shard(params, axes, C.TP, grid.model.rank)
            for tag, b, per_slot in (("b8", C.B, False), ("b1", 1, True)):
                pre = S.build_prefill_step(cfg, scfg, grid, global_batch=b)
                dec = S.build_decode_step(cfg, scfg, grid, target_len=C.S + C.EXTRA,
                                          per_slot_t=per_slot, global_batch=b)
                lg, cache = pre(mine, {"tokens": toks[:b, :C.S]})
                t = torch.full((b,), C.S) if per_slot else torch.tensor(C.S)
                lg2, _ = dec(mine, toks[:b, C.S:C.S + 1], cache, t)
                out[f"{name}/{tag}/prefill"] = S.gather_logits(lg, grid, global_batch=b).numpy()
                out[f"{name}/{tag}/decode"] = S.gather_logits(lg2, grid, global_batch=b).numpy()
                out[f"{name}/{tag}/slots"] = int(cache["g0"]["kv"]["k"].shape[2])
            out[f"{name}/split"] = split

            def engine(g, publish=False):
                seen = {}
                src = params if g is not None else _unpadded(params, cfg, C.TP)
                pub = None
                if publish:  # the global tree through a publisher's snapshot
                    pub = WeightPublisher(model_plane_layout(cfg, C.TP))
                    pub.offer(src, version=1, gap=0)
                e = ServeEngine(cfg, slots=C.B, max_prompt=16, max_new=6,
                                params=None if publish else src, publisher=pub,
                                device="cpu", grid=g,
                                on_logits=lambda lg, act: seen.setdefault("lg", lg.clone()))
                rng = np.random.default_rng(3)
                for i in range(11):
                    n = int(rng.integers(1, 17))
                    e.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n)
                                     .astype(np.int32), max_new_tokens=int(rng.integers(1, 7))))
                done = {c.rid: c.tokens.tolist() for c in e.run_until_drained()}
                # the bytes the engine's parameters hold (their distinct
                # storages), the bytes of their leaves, of the global leaves,
                # and of the serving shard's planes (swapped-in weights)
                mine = tree_leaves(e._params)
                held = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                        for x in mine}
                size = lambda xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
                planes = None if e._shard_layout is None else sum(
                    size([torch.empty(sh, dtype=dt, device="meta")])
                    for sh, dt in e._shard_layout.plane_shapes().values())
                memory = (sum(held.values()), size(mine), size(tree_leaves(src)), planes)
                return done, seen["lg"].numpy(), e.stats(), memory

            if name == C.ENGINE_CASE:
                out["engine"] = engine(grid)
                out["engine_pub"] = engine(grid, publish=True)
                if world.rank == 0:
                    out["engine1"] = engine(None)
    return out


def grad_ranks(world) -> dict:
    """Every GRAD_CASES case on a (world / tp, tp) grid: the loss and each
    leaf's gradient at tp, joined over the model group, beside rank 0's
    tp = 1 loss and gradient of the same model; per leaf the largest
    difference relative to the leaf's gradient scale, and the largest
    gradient on the padding."""
    import torch

    from repro_torch.configs import tiny_lm
    from repro_torch.interop import shard, unshard
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import TPContext
    from repro_torch.utils import tree_leaves, tree_paths, tree_unflatten

    out = {}
    for name, (kw, tp) in C.GRAD_CASES.items():
        cfg = tiny_lm(**kw)
        grid = init_grid(world, tp)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), tp=tp)
        axes = T.param_shard_axes(cfg, tp)
        batch = {k: torch.from_numpy(v) for k, v in C.grad_batch(cfg.vocab_size).items()}
        mine = shard(params, axes, tp, grid.model.rank)
        leaves = [x.detach().requires_grad_() for x in tree_leaves(mine)]
        loss, _ = T.forward_loss(tree_unflatten(mine, leaves), batch, cfg,
                                 tp=TPContext(grid.model))
        grads = tree_unflatten(mine, list(torch.autograd.grad(loss, leaves)))
        parts = [None] * tp
        torch.distributed.all_gather_object(parts, grads, group=grid.model.pg)
        if world.rank:
            continue
        full = unshard(parts, axes)
        p1 = _unpadded(params, cfg, tp)
        l1 = [x.detach().requires_grad_() for x in tree_leaves(p1)]
        loss1, _ = T.forward_loss(tree_unflatten(p1, l1), batch, cfg)
        g1 = torch.autograd.grad(loss1, l1)
        res = {"loss": float((loss - loss1).abs())}
        for path, a, b in zip(tree_paths(full), tree_leaves(full), g1):
            cut = tuple(slice(0, n) for n in b.shape)
            pad = a.clone()
            pad[cut] = 0
            res[path] = (float((a[cut] - b).abs().max() / b.abs().max().clamp(min=1e-30)),
                         float(pad.abs().max()))
        out[name] = res
    return out


TRAIN_CASES = {
    # name: TrainConfig fields
    "planes-decentlam": dict(algorithm="decentlam", topology="exp", flat_planes=True,
                             fused_update=True, track_consensus=True),
    "leaf-clip-dmsgd": dict(algorithm="dmsgd", topology="exp", grad_clip=0.5,
                            track_consensus=True),
    # exp at 2 nodes mixes fully, so its consensus is about 0: with no gossip
    # the nodes part, and the consensus metric has something to measure
    "leaf-disconnected": dict(algorithm="dmsgd", topology="disconnected",
                              track_consensus=True),
    "planes-lars": dict(algorithm="pmsgd-lars", topology="exp", flat_planes=True,
                        fused_update=True),
}
TRAIN_STEPS = 2


def grad_and_train_ranks(world) -> dict:
    """:func:`grad_ranks` and :func:`train_ranks` in one spawned group of 4."""
    return {"grads": grad_ranks(world), "train": train_ranks(world)}


def train_ranks(world, arch: str | None = None, cases=None) -> dict:
    """On the (2, 2) grid: TRAIN_STEPS steps of each TRAIN_CASES case (or
    ``cases``, on ``arch``'s smoke config) on the
    distributed step at tp = 2, gathered to the global state, beside rank
    0's stacked step (the port's tp = 1 step) on the same model and
    batches: the largest differences of the parameters and of the optimizer
    state (each relative to its leaf's scale), the metrics, and the last
    step's consensus metric beside ``repro``'s formula on the gathered
    parameters (each model rank's squared distances over its shard, the
    mean over the model group) and beside the unsharded sum.  Then the
    gathered checkpoint state (which holds no channel state at tp > 1)
    scattered back equals each rank's state bit for bit, and the publisher
    takes the sharded plane form of node 0."""
    import torch

    from repro_torch.configs import tiny_lm
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.schedules import ScheduleConfig
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.mesh import init_grid
    from repro_torch.serve import WeightPublisher
    from repro_torch.train.step import TrainConfig, build_dist_train_step, build_train_step
    from repro_torch.train.train_state import (
        gather_grid_state, init_train_state, model_plane_layout, reconcile_plane_state,
        scatter_grid_state,
    )
    from repro_torch.utils import shard, tree_leaves, tree_map, tree_paths

    from repro_torch.configs import get_config

    tp = 2
    grid = init_grid(world, tp)
    cfg = (get_config(arch, smoke=True) if arch else
           tiny_lm(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256))
    layout2, layout1 = model_plane_layout(cfg, tp), model_plane_layout(cfg)
    out = {}

    def run(build, n, **kw):
        step_fn, channel = build()
        state = init_train_state(cfg, make_optimizer(tcfg.opt_config()), n, device="cpu",
                                 channel=channel, **kw)
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                             per_node_batch=4, n_nodes=grid.nodes,
                                             heterogeneity=0.5))
        metrics = []
        for k in range(TRAIN_STEPS):
            batch = {key: torch.from_numpy(v) for key, v in data.batch(k).items()}
            state, m = step_fn(state, batch)
            metrics.append({key: float(v) for key, v in m.items()})
        return state, metrics

    def trees(state, layout, glob):
        opt = state.get("opt", {})
        unpack = layout.unpack_global if glob else layout.unpack
        opt = {k: unpack(v, leading=1) if isinstance(v, dict) and set(v) == set(
            layout.segments) else v for k, v in opt.items()}
        tree = {"params": state["params"], "opt": opt}
        return dict(zip(tree_paths(tree), tree_leaves(tree)))

    for name, fields in (cases or TRAIN_CASES).items():
        tcfg = TrainConfig(fused_impl="triton", **fields, schedule=ScheduleConfig(
            kind="warmup_cosine", peak_lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS))
        flat = tcfg.flat_planes
        state, metrics = run(lambda: build_dist_train_step(cfg, tcfg, grid), 1,
                                       plane_layout=layout2 if flat else None, tp=tp,
                                       tp_index=grid.model.rank)
        host = gather_grid_state(state, grid, layout2)
        back = scatter_grid_state(host, grid, layout2)
        back = reconcile_plane_state(back, layout2, flat)
        mine = trees(state, layout2, False)
        again = trees(back, layout2, False)
        res = {"no_channel": "channel" not in host if world.rank == 0 else True,
               "roundtrip": sorted(mine) == sorted(again) and all(
                   torch.equal(mine[k], again[k]) for k in mine)}
        if world.rank == 0:
            sstate, smetrics = run(lambda: build_train_step(cfg, tcfg, grid.nodes),
                                      grid.nodes, plane_layout=layout1 if flat else None)
            got, want = trees(host, layout2, True), trees(sstate, layout1, False)
            assert sorted(got) == sorted(want), name
            res["err"] = {part: max(float((got[k] - want[k]).abs().max()
                                          / want[k].abs().max().clamp(min=1e-30))
                                    for k in want if k.startswith(part))
                          for part in ("params", "opt")}
            res["metrics"] = (metrics, smetrics)
            if tcfg.track_consensus:
                def sq(tree):  # (1/n) sum_i ||x_i - x_bar||^2 over the leaves, in f64
                    return sum(float(((x.double() - x.double().mean(0)) ** 2).sum())
                               for x in tree_leaves(tree)) / grid.nodes

                axes = layout2.shard_axes()
                res["consensus"] = (
                    metrics[-1]["consensus_sq"],
                    sum(sq(shard(host["params"], axes, tp, m, leading=1))
                        for m in range(tp)) / tp,
                    sq(host["params"]))
            if name == "planes-decentlam" and arch is None:
                pub = WeightPublisher(layout2)
                node0 = tree_map(lambda x: x[0], host["params"])
                pub.offer(layout2.pack_global(node0), version=1, gap=0)
                res["publisher"] = all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(node0),
                                                      tree_leaves(pub.current.params)))
        out[name] = res
    return out


def check_snapshots(engine, pub) -> dict:
    """``on_serve`` hook of the CLI's serving while training: each offer
    that ships is held against the publisher's snapshot, bit for bit (the
    plane dict of a plane-form source, else the parameter tree).  Returns
    the counts, which the offers fill."""
    import torch

    from repro_torch.utils import tree_leaves

    seen = {"checked": 0, "equal": 0}
    offer = pub.offer

    def checked(src, **kw):
        shipped = offer(src, **kw)
        if shipped:
            snap = pub.current
            got = snap.planes if set(src) == set(snap.planes) else snap.params
            seen["checked"] += 1
            seen["equal"] += all(
                torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8))
                for a, b in zip(tree_leaves(src), tree_leaves(got)))
        return shipped

    pub.offer = checked
    return seen


def _joined_grads(world, cfg, tp, batch_np):
    """On a (world / tp, tp) grid: the loss and each leaf's gradient of
    ``cfg``'s model (init seed 0, padded for tp) at tp, joined over the
    model group; on rank 0 beside the tp = 1 loss and gradient of the same
    model: per leaf the largest difference relative to the leaf's gradient
    scale and the largest gradient on the padding.  Both run on float64
    parameters and activations (the router, the loss and the recurrent
    cells compute in float32 at any dtype): in float32 the tp = 1 gradient
    of an mLSTM gate (``w_f``) is itself 1.4e-5 of its scale from the
    float64 one, at the tolerance, so float32 would test the rounding, not
    the sharding."""
    import torch

    from repro_torch.interop import shard, unshard
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import TPContext
    from repro_torch.utils import tree_leaves, tree_map, tree_paths, tree_unflatten

    grid = init_grid(world, tp)
    f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    params = tree_map(f64, T.init_params(cfg, torch.Generator().manual_seed(0), tp=tp))
    rt = T.RuntimeConfig(dtype="float64")
    axes = T.param_shard_axes(cfg, tp)
    batch = {k: f64(torch.from_numpy(v)) for k, v in batch_np.items()}
    mine = shard(params, axes, tp, grid.model.rank)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(mine)]
    loss, _ = T.forward_loss(tree_unflatten(mine, leaves), batch, cfg, rt,
                             tp=TPContext(grid.model))
    grads = tree_unflatten(mine, list(torch.autograd.grad(loss, leaves)))
    parts = [None] * tp
    torch.distributed.all_gather_object(parts, grads, group=grid.model.pg)
    if world.rank:
        return None
    full = unshard(parts, axes)
    p1 = _unpadded(params, cfg, tp)
    l1 = [x.detach().requires_grad_() for x in tree_leaves(p1)]
    loss1, _ = T.forward_loss(tree_unflatten(p1, l1), batch, cfg, rt)
    g1 = torch.autograd.grad(loss1, l1)
    res = {"loss": float((loss - loss1).abs() / loss1.abs())}
    for path, a, b in zip(tree_paths(full), tree_leaves(full), g1):
        cut = tuple(slice(0, n) for n in b.shape)
        pad = a.clone()
        pad[cut] = 0
        res[path] = (float((a[cut] - b).abs().max() / b.abs().max().clamp(min=1e-30)),
                     float(pad.abs().max()))
    return res


def zoo_grad_ranks(world, archs, tp) -> dict:
    """:func:`_joined_grads` of each smoke config in ``archs`` at ``tp``."""
    from repro_torch.configs import get_config

    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        out[arch] = _joined_grads(world, cfg, tp, C.zoo_grad_batch(cfg))
    return out


def zoo_serve_ranks(world, npz_path: str) -> dict:
    """On the (4, 2) grid: each ZOO_SERVE config's sharded prefill and its
    EXTRA decode steps (fed repro's tokens) from repro's global parameters,
    gathered, and its cache's local shapes; for the recurrent families,
    the continuous-batching engine on the grid beside rank 0's engine on
    one process (tp = 1); then whisper-tiny's training loss at tp 2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import from_numpy, shard
    from repro_torch.launch.mesh import init_grid
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import TPContext
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import serve as S
    from repro_torch.utils import tree_map

    grid = init_grid(world, C.TP)
    rt = T.RuntimeConfig(dtype="float32")
    tl = C.ZOO_S + C.EXTRA
    out = {}
    with np.load(npz_path) as z:
        for arch in C.ZOO_SERVE:
            cfg = get_config(arch, smoke=True)
            params = from_numpy(_tree(z, f"{arch}/params/"))
            inputs = C.zoo_serve_inputs(cfg)
            scfg = S.ServeConfig(runtime=rt, target_len=tl)
            axes = S.serve_specs(cfg, grid, global_batch=C.ZOO_B)[0]
            mine = shard(params, axes, C.TP, grid.model.rank)
            pre = S.build_prefill_step(cfg, scfg, grid, global_batch=C.ZOO_B)
            dec = S.build_decode_step(cfg, scfg, grid, target_len=tl, global_batch=C.ZOO_B)
            batch = {"tokens": torch.from_numpy(inputs["tokens"][:, :C.ZOO_S].astype(np.int64))}
            if "patch_embeds" in inputs:
                batch["patch_embeds"] = torch.from_numpy(inputs["patch_embeds"])
            lg, cache = pre(mine, batch)
            out[f"{arch}/prefill"] = S.gather_logits(lg, grid, global_batch=C.ZOO_B).numpy()
            out[f"{arch}/cache"] = tree_map(lambda x: tuple(x.shape), cache)
            for j in range(C.EXTRA):
                feed = torch.from_numpy(z[f"{arch}/feed{j}"].astype(np.int64))
                lg, cache = dec(mine, feed, cache, torch.tensor(C.ZOO_S + j))
                out[f"{arch}/decode{j}"] = S.gather_logits(lg, grid,
                                                           global_batch=C.ZOO_B).numpy()

            def engine(g):
                e = ServeEngine(cfg, slots=C.ZOO_B, max_prompt=12, max_new=5, params=params,
                                device="cpu", grid=g)
                rng = np.random.default_rng(7)
                for i in range(11):
                    n = int(rng.integers(1, 13))
                    e.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n)
                                     .astype(np.int32), max_new_tokens=int(rng.integers(1, 6))))
                return {c.rid: c.tokens.tolist() for c in e.run_until_drained()}

            if cfg.xlstm or cfg.ssm:
                out[f"{arch}/engine"] = engine(grid)
                if world.rank == 0:
                    out[f"{arch}/engine1"] = engine(None)
        # whisper-tiny's training loss at tp 2 from repro's parameters (every
        # node the same batch)
        cfg = get_config("whisper-tiny", smoke=True)
        params = from_numpy(_tree(z, "whisper-tiny/params/"))
        mine = shard(params, T.param_shard_axes(cfg, C.TP), C.TP, grid.model.rank)
        batch = {k: torch.from_numpy(v) for k, v in C.zoo_grad_batch(cfg).items()}
        with torch.no_grad():
            out["whisper-tiny/loss_tp2"] = float(
                T.forward_loss(mine, batch, cfg, tp=TPContext(grid.model))[0])
    return out


# the MoE train cases: expert mode (granite-moe-1b's 4 experts) and ffn mode
# (granite-moe-3b's 5), on planes and per leaf with the clip norm
ZOO_TRAIN = {"granite-moe-1b-a400m": {k: TRAIN_CASES[k] for k in ("planes-decentlam",
                                                                   "leaf-clip-dmsgd")},
             "granite-moe-3b-a800m": {k: TRAIN_CASES[k] for k in ("planes-decentlam",
                                                                   "leaf-clip-dmsgd")}}


def zoo_grad_and_train_ranks(world, archs) -> dict:
    """On 4 ranks: each of ``archs``' joined gradients at tp 2 and 4
    (:func:`zoo_grad_ranks`, in float64) and the ZOO_TRAIN cases among
    ``archs`` on the (2, 2) grid (:func:`train_ranks`)."""
    out = {"grads": {tp: zoo_grad_ranks(world, archs, tp) for tp in (2, 4)}, "train": {}}
    for arch in archs:
        if arch in ZOO_TRAIN:
            out["train"][arch] = train_ranks(world, arch, ZOO_TRAIN[arch])
    return out
