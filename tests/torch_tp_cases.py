"""The seeded cases of ``tests/test_torch_tp.py``, shared by its JAX side
(``torch_tp_ref.py``) and the port's ranks (``torch_tp_workers.py``).
Imports neither package."""

import numpy as np

NODES, TP = 4, 2  # the (4, 2) mesh of tests/scripts/distributed_serve.py
B, S, EXTRA = 8, 32, 4  # batch, prompt, cache slots beyond it

# tiny_lm overrides: distributed_serve.py's config, and one whose q heads and
# vocabulary pad at tp = 2 with qk-norm and a sliding window shorter than
# the prompt (the sharded rolling buffer)
SERVE_CASES = {
    "serve": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=256),
    "padded-window": dict(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=64,
                          vocab_size=251, qk_norm=True, sliding_window=16),
}

# the serving case the engine runs on (padded heads and vocabulary, a window)
ENGINE_CASE = "padded-window"

# gradient cases: (tiny_lm overrides, tp)
GRAD_CASES = {
    "heads3-vocab13": (dict(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=64,
                            vocab_size=13, qk_norm=True), 2),
    "window-tp4": (dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=250, sliding_window=8), 4),
    "tied-qknorm": (dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         vocab_size=256, tie_embeddings=True, qk_norm=True), 2),
}

# serving cases' relative tolerance against repro (distributed_serve.py's)
SERVE_RTOL = 5e-4


def serve_tokens(vocab: int) -> np.ndarray:
    """(B, S + 1) prompt tokens and the decoded one."""
    return np.random.default_rng(0).integers(0, vocab, (B, S + 1)).astype(np.int32)


def grad_batch(vocab: int) -> dict:
    toks = np.random.default_rng(1).integers(0, vocab, (2, 17)).astype(np.int64)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# ---------------------------------------------------------------------------
# the rest of the zoo at tp > 1 (tests/test_torch_tp_zoo_*.py)
# ---------------------------------------------------------------------------

# the registry's smoke configs whose sharded serving is held against
# repro's on the (4, 2) mesh: granite-moe-1b's 4 experts shard by expert,
# granite-moe-3b's 5 by d_ff; the VLM serves with its patch embeddings
ZOO_SERVE = ("granite-moe-1b-a400m", "granite-moe-3b-a800m", "xlstm-350m", "hymba-1.5b",
             "internvl2-2b")
# every family's gradient, joined over the model group, at tp 2 and 4
ZOO_GRAD = ("granite-moe-1b-a400m", "granite-moe-3b-a800m", "xlstm-350m", "hymba-1.5b",
            "internvl2-2b", "whisper-tiny")
ZOO_B, ZOO_S = 8, 16  # the zoo's serving batch (2 rows a node) and prompt


def zoo_serve_inputs(cfg) -> dict:
    """(B, S + 1) tokens, and the VLM's (B, P, d) patch embeddings."""
    rng = np.random.default_rng(5)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ZOO_B, ZOO_S + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (ZOO_B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def zoo_grad_batch(cfg) -> dict:
    """A (2, 16) training batch, with the VLM's patches and the
    encoder-decoder's frames."""
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int64)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.arch_kind == "encdec":
        out["enc_frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    return out
