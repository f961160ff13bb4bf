"""The symmetric exponential graph: node ``i``'s peers sit at hop distances
1, 2, 4, ... up to ``n / 2`` either way (a ring for ``n <= 2``), with
Metropolis weights ``1 / (1 + max(deg_i, deg_j))`` and the rest of each row
on the diagonal."""

from __future__ import annotations

import numpy as np


def mixing(n: int) -> np.ndarray:
    hops = {1}
    k = 1
    while (1 << k) <= n // 2:
        hops.add(1 << k)
        k += 1
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for h in hops:
            if n > 1:
                adj[i, (i + h) % n] = adj[i, (i - h) % n] = True
    np.fill_diagonal(adj, False)
    deg = adj.sum(1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                W[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W
