"""The JAX side of ``tests/test_torch_tp.py``: ``repro``'s sharded serving
(``train.serve.build_prefill_step`` / ``build_decode_step`` on a ``(4, 2)``
mesh of 8 simulated CPU devices, as ``tests/scripts/distributed_serve.py``
runs them) on the seeded cases of ``torch_tp_cases``, written to an npz:
each case's global parameters (``init_params(key(0), cfg, tp=2)``, by
'/'-joined path under ``<case>/params/``), its tokens, and the prefill and
decode logits of the full batch and of the ``global_batch=1`` fallback.
With ``zoo`` it covers the rest of the registry instead (:func:`zoo`):
the sharded serving of ``ZOO_SERVE``'s smoke configs and whisper-tiny's
training loss at tp 2 under ``shard_map``.

Run as a script (the test runs it in a subprocess, because the pytest
process's jax has one device)::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/torch_tp_ref.py out.npz [zoo]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_tp_cases as C  # noqa: E402


def main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import tiny_lm
    from repro.models import transformer as T
    from repro.train import serve as serve_mod

    if len(jax.devices()) != C.NODES * C.TP:
        raise SystemExit(f"need {C.NODES * C.TP} devices, have {len(jax.devices())}")
    mesh = jax.make_mesh((C.NODES, C.TP), ("data", "model"))
    rt = T.RuntimeConfig(dtype="float32", remat=False)
    out: dict[str, np.ndarray] = {}
    for name, kw in C.SERVE_CASES.items():
        cfg = tiny_lm(**kw)
        params = T.init_params(jax.random.key(0), cfg, tp=C.TP)
        toks = C.serve_tokens(cfg.vocab_size)
        S, tl = C.S, C.S + C.EXTRA
        scfg = serve_mod.ServeConfig(runtime=rt, target_len=tl)
        pspecs = serve_mod.serve_specs(cfg, mesh, global_batch=C.B)[0]
        pp = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
                          pspecs, is_leaf=lambda x: isinstance(x, P))
        for tag, b, per_slot in (("b8", C.B, False), ("b1", 1, True)):
            pre, _ = serve_mod.build_prefill_step(cfg, mesh, scfg, global_batch=b)
            dec, _ = serve_mod.build_decode_step(cfg, mesh, scfg, global_batch=b,
                                                 target_len=tl, per_slot_t=per_slot)
            t = jnp.full((b,), S, jnp.int32) if per_slot else jnp.int32(S)
            lg, cache = pre(pp, {"tokens": jnp.asarray(toks[:b, :S])})
            lg2, _ = dec(pp, jnp.asarray(toks[:b, S:S + 1]), cache, t)
            out[f"{name}/{tag}/prefill"] = np.asarray(lg)
            out[f"{name}/{tag}/decode"] = np.asarray(lg2)
        for path, leaf in _flat(jax.device_get(params)):
            out[f"{name}/params/{path}"] = np.asarray(leaf)
    np.savez(out_path, **out)


def zoo(out_path: str) -> None:
    """Each ZOO_SERVE smoke config's global parameters (``init_params(key(0),
    cfg, tp=2)``), its inputs, and repro's prefill and decode logits on the
    (4, 2) mesh; whisper-tiny's parameters, batch and training loss at tp 2
    (``forward_loss`` inside ``shard_map``, the batch replicated) and at
    tp 1."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.models.layers import TPContext
    from repro.train import serve as serve_mod

    mesh = jax.make_mesh((C.NODES, C.TP), ("data", "model"))
    rt = T.RuntimeConfig(dtype="float32", remat=False)
    out: dict[str, np.ndarray] = {}

    def put(tree, specs):
        return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
                            specs, is_leaf=lambda x: isinstance(x, P))

    for arch in C.ZOO_SERVE:
        cfg = get_config(arch, smoke=True)
        params = T.init_params(jax.random.key(0), cfg, tp=C.TP)
        inputs = C.zoo_serve_inputs(cfg)
        S, tl = C.ZOO_S, C.ZOO_S + C.EXTRA
        scfg = serve_mod.ServeConfig(runtime=rt, target_len=tl)
        pp = put(params, serve_mod.serve_specs(cfg, mesh, global_batch=C.ZOO_B)[0])
        pre, _ = serve_mod.build_prefill_step(cfg, mesh, scfg, global_batch=C.ZOO_B)
        dec, _ = serve_mod.build_decode_step(cfg, mesh, scfg, global_batch=C.ZOO_B,
                                             target_len=tl)
        batch = {"tokens": jnp.asarray(inputs["tokens"][:, :S])}
        if "patch_embeds" in inputs:
            batch["patch_embeds"] = jnp.asarray(inputs["patch_embeds"])
        lg, cache = pre(pp, batch)
        out[f"{arch}/prefill"] = np.asarray(lg)
        # EXTRA decode steps: the prompt's next token, then repro's greedy
        # picks (kept, so that the port decodes the same tokens)
        feed = inputs["tokens"][:, S:S + 1]
        for j in range(C.EXTRA):
            out[f"{arch}/feed{j}"] = feed
            lg, cache = dec(pp, jnp.asarray(feed), cache, jnp.int32(S + j))
            out[f"{arch}/decode{j}"] = np.asarray(lg)
            feed = np.asarray(jnp.argmax(lg[:, :cfg.vocab_size], axis=-1))[:, None].astype(
                np.int32)
        for path, leaf in _flat(jax.device_get(params)):
            out[f"{arch}/params/{path}"] = np.asarray(leaf)

    cfg = get_config("whisper-tiny", smoke=True)
    params = T.init_params(jax.random.key(0), cfg, tp=C.TP)
    batch = {k: jnp.asarray(v) for k, v in C.zoo_grad_batch(cfg).items()}
    specs = T.param_specs(cfg, C.TP)
    tp_ctx = TPContext(axis="model", size=C.TP, in_shard_map=True)
    loss_fn = shard_map(
        lambda p, b: T.forward_loss(p, b, cfg, tp_ctx, rt)[0], mesh=mesh,
        in_specs=(specs, jax.tree.map(lambda _: P(), batch)), out_specs=P(),
        axis_names={"data", "model"}, check_vma=False)
    out["whisper-tiny/loss_tp2"] = np.asarray(jax.jit(loss_fn)(put(params, specs), batch))
    out["whisper-tiny/loss_tp1"] = np.asarray(
        T.forward_loss(params, batch, cfg, TPContext(), rt)[0])
    for path, leaf in _flat(jax.device_get(params)):
        out[f"whisper-tiny/params/{path}"] = np.asarray(leaf)
    np.savez(out_path, **out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


if __name__ == "__main__":
    (zoo if sys.argv[2:] == ["zoo"] else main)(sys.argv[1])
