"""The training traffic: a pool of batches made from ``--seed`` by one
general generator from the parameters of a traffic file
(``bench/traffic/<name>.json``).

The generator is a copy of the program's synthetic language-model stream
(``data/synthetic.py``; kept here so that the yardstick cannot move): node
``i`` samples the noisy affine token process ``next = (a_i cur + b_i) mod V``
whose coefficients drift from a shared pair as ``heterogeneity`` grows, a
token being replaced by a uniformly random one with probability ``noise``.
The heterogeneity is what gives decentralized momentum SGD its bias, and the
mix of tokens is what the MoE router sees.  Every batch of the pool holds
new rows; the window cycles the pool.
"""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, rows_per_node: int, nodes: int, seed: int,
                 heterogeneity: float, noise: float):
        self.v, self.s, self.b, self.n = vocab, seq_len, rows_per_node, nodes
        self.seed, self.noise = seed, noise
        rng = np.random.default_rng(seed)
        a0 = int(rng.integers(3, vocab - 1)) | 1
        b0 = int(rng.integers(1, vocab - 1))
        self.a = np.empty(nodes, np.int64)
        self.c = np.empty(nodes, np.int64)
        for i in range(nodes):
            span = max(1, int(heterogeneity * vocab))
            da, db = ((int(rng.integers(0, span)), int(rng.integers(0, span)))
                      if heterogeneity > 0 else (0, 0))
            self.a[i] = ((a0 + 2 * da) % vocab) | 1
            self.c[i] = (b0 + db) % vocab

    def batch(self, index: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``targets``, ``(nodes * rows_per_node, seq_len)``."""
        rng = np.random.default_rng((self.seed, index))
        n, b, s, v = self.n, self.b, self.s, self.v
        seqs = np.empty((n, b, s + 1), np.int64)
        cur = rng.integers(0, v, (n, b))
        seqs[:, :, 0] = cur
        noisy = rng.random((n, b, s)) < self.noise
        rand = rng.integers(0, v, (n, b, s))
        for t in range(s):
            nxt = (self.a[:, None] * cur + self.c[:, None]) % v
            nxt = np.where(noisy[:, :, t], rand[:, :, t], nxt)
            seqs[:, :, t + 1] = nxt
            cur = nxt
        flat = seqs.reshape(n * b, s + 1)
        return {"tokens": flat[:, :-1], "targets": flat[:, 1:]}


def pool(traffic: dict, vocab: int, nodes: int, seed: int) -> list[dict[str, np.ndarray]]:
    """The traffic file's ``pool`` batches for ``seed``."""
    gen = SyntheticLM(vocab, int(traffic["seq_len"]), int(traffic["rows_per_node"]), nodes,
                      int(seed) % (1 << 63), float(traffic["heterogeneity"]),
                      float(traffic["noise"]))
    return [gen.batch(k) for k in range(int(traffic["pool"]))]
