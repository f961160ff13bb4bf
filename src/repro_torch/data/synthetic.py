"""Deterministic synthetic data with a *heterogeneity* knob.

Decentralized-training quality depends on the data inconsistency b^2 between
nodes (paper Assumption A.4 / Prop. 2-3), so the synthetic LM stream exposes
it directly: each node samples from a noisy affine token process
``next = (a_i * cur + b_i) mod V`` whose per-node coefficients drift from a
shared pair as ``heterogeneity`` grows.  alpha = 0 reproduces the IID
(homogeneous-shards) data-center setting; alpha > 0 emulates EdgeAI-style
non-IID shards.  Everything is a pure function of (seed, node, step) —
restart-safe by construction, no state to checkpoint.

For an encoder-decoder, ``enc_frames=(T_enc, d)`` adds each row's stub
frame embeddings (the frontend's output), standard normal from the same
(seed, step).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    per_node_batch: int
    n_nodes: int
    seed: int = 0
    heterogeneity: float = 0.0
    noise: float = 0.05  # probability of a uniformly random token
    enc_frames: tuple[int, int] | None = None  # (T_enc, d): add stub encoder frames


class SyntheticLM:
    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        a0 = int(rng.integers(3, v - 1)) | 1  # odd multiplier
        b0 = int(rng.integers(1, v - 1))
        self.a = np.empty(cfg.n_nodes, np.int64)
        self.b = np.empty(cfg.n_nodes, np.int64)
        for i in range(cfg.n_nodes):
            if cfg.heterogeneity > 0:
                da = int(rng.integers(0, max(1, int(cfg.heterogeneity * v))))
                db = int(rng.integers(0, max(1, int(cfg.heterogeneity * v))))
            else:
                da = db = 0
            self.a[i] = ((a0 + 2 * da) % v) | 1
            self.b[i] = (b0 + db) % v

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Returns {tokens, targets}: (n_nodes * per_node_batch, seq_len)
        [, enc_frames (n_nodes * per_node_batch, T_enc, d) float32]."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        seqs = np.empty((c.n_nodes, c.per_node_batch, c.seq_len + 1), np.int64)
        cur = rng.integers(0, c.vocab_size, (c.n_nodes, c.per_node_batch))
        seqs[:, :, 0] = cur
        noise = rng.random((c.n_nodes, c.per_node_batch, c.seq_len)) < c.noise
        rand = rng.integers(0, c.vocab_size, (c.n_nodes, c.per_node_batch, c.seq_len))
        for t in range(c.seq_len):
            nxt = (self.a[:, None] * cur + self.b[:, None]) % c.vocab_size
            nxt = np.where(noise[:, :, t], rand[:, :, t], nxt)
            seqs[:, :, t + 1] = nxt
            cur = nxt
        flat = seqs.reshape(c.n_nodes * c.per_node_batch, c.seq_len + 1)
        out = {
            "tokens": flat[:, :-1].astype(np.int32),
            "targets": flat[:, 1:].astype(np.int32),
        }
        if c.enc_frames is not None:
            frames = np.random.default_rng((c.seed, step, 1)).standard_normal(
                (flat.shape[0], *c.enc_frames))
            out["enc_frames"] = frames.astype(np.float32)
        return out
