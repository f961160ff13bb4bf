"""Plain reference of the stacked DecentLaM trainer's first steps
(``trainer.algorithm`` ``decentlam``).

``n`` nodes, each with its own copy of the parameters, all starting from
the same ``x0``.  Per step ``k`` (Yuan et al., DecentLaM, Alg. 2 / eq. 17):

* each node's gradient ``g_i`` of its loss over its rows of the batch, the
  rows split into ``grad_accum`` microbatches whose gradients are averaged;
* the payload ``p_i = x_i - lr_k g_i``, gossiped with the mixing matrix ``W``
  of the traffic's ``topology`` (``topology/<name>.py``):
  ``mix_i = sum_j W_ij p_j``;
* ``g~_i = (x_i - mix_i) / lr_k``, ``m_i <- beta m_i + g~_i``,
  ``x_i <- x_i - lr_k m_i``.

With a ``compression`` (``compression/<name>.py``) each node ``j`` sends
``q_j`` as the compressor makes it from ``p_j`` and its residual, and the mix
takes its own payload raw: ``mix_i = W_ii p_i + sum_{j != i} W_ij q_j``.

The learning rate follows the trainer's ``schedule``: ``warmup_cosine``,
``lr_k = peak (k + 1) / warmup`` for ``k < warmup``, then a cosine from
``peak`` down to ``final_frac peak`` at ``total_steps``.

The trainer settings this reference implements are :data:`READS`; a traffic
file that sets any other (a gossip delay, weight decay, clipping, ...) is
refused by :func:`check`, because the reference would not follow it.

Everything runs in float32 with plain ``torch`` operations; TF32 is set by
the caller (off for the reference, on for its control).  The readings are
what the benchmark compares with the program's: each step's loss (the mean
over nodes), per node and leaf the norm of the momentum after the first
step (the gradient as the optimizer gets it) and of the raw gradient there,
the norm of ``x - x0`` after the last step, and of the compressor's
residual after the last step; the momentum's and ``x - x0``'s norms also by
block, each matrix of a stacked leaf apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import load

Params = dict[str, torch.Tensor]

READS = {"nodes", "algorithm", "topology", "compression", "momentum", "grad_accum",
         "schedule"}
SCHEDULE_READS = {"kind", "peak_lr", "warmup_steps", "total_steps", "final_frac"}


def check(trainer: dict) -> None:
    """Refuse trainer settings this reference does not follow."""
    extra = set(trainer) - READS
    if extra:
        raise ValueError(f"the decentlam reference does not implement {sorted(extra)}")
    sched = trainer["schedule"]
    if sched.get("kind") != "warmup_cosine" or set(sched) - SCHEDULE_READS:
        raise ValueError(f"the decentlam reference implements a warmup_cosine schedule with "
                         f"{sorted(SCHEDULE_READS)}, not {sched}")
    load("topology", trainer["topology"])
    if trainer.get("compression") is not None:
        load("compression", trainer["compression"])


def lr_at(step: int, schedule: dict) -> float:
    peak, warmup, total = (float(schedule["peak_lr"]), int(schedule["warmup_steps"]),
                           int(schedule["total_steps"]))
    final = float(schedule.get("final_frac", 0.0))
    if step < warmup:
        v = peak * (step + 1.0) / max(warmup, 1)
    else:
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        v = peak * (final + (1 - final) * 0.5 * (1 + math.cos(math.pi * t)))
    return float(np.float32(v))


def _norms(t: torch.Tensor) -> list[float]:
    return [float(torch.linalg.vector_norm(t[i])) for i in range(t.shape[0])]


def _block_norms(t: torch.Tensor) -> list[list[float]]:
    """Per node, the norm of each matrix of a stacked leaf (its leading axes
    index the blocks), or of the whole leaf where it has under three axes."""
    if t.ndim < 4:
        return [[float(torch.linalg.vector_norm(t[i]))] for i in range(t.shape[0])]
    return [torch.linalg.vector_norm(t[i].flatten(0, -3), dim=(-2, -1)).tolist()
            for i in range(t.shape[0])]


def run(family, model: dict, trainer: dict, x0: Params, batches: list[dict], steps: int,
        fault: str | None = None) -> dict:
    """``steps`` steps from ``x0`` (one node's parameters) on ``batches``
    (``tokens``/``targets``, node ``i`` owning rows ``[i b, (i + 1) b)``).
    ``fault`` plants one of the faults the benchmark must catch:
    ``"half_batch"`` (each node's loss over the first half of its rows, or
    of its one row's tokens) or
    ``"no_exchange"`` (the mix returns each node's own payload)."""
    check(trainer)
    n = int(trainer["nodes"])
    beta = float(trainer["momentum"])
    accum = int(trainer.get("grad_accum", 1))
    W = load("topology", trainer["topology"]).mixing(n)
    comp = (load("compression", trainer["compression"])
            if trainer.get("compression") is not None else None)
    x = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.ndim) for k, v in x0.items()}
    m = {k: torch.zeros_like(v) for k, v in x.items()}
    err = {k: torch.stack([comp.init(v[i]) for i in range(n)]) for k, v in x.items()} \
        if comp else None
    out = {"losses": []}
    for step in range(steps):
        lr = lr_at(step, trainer["schedule"])
        batch = batches[step]
        b = batch["tokens"].shape[0] // n
        mb = b // accum
        payload, losses, raw = {}, [], {}
        for i in range(n):
            leaves = {k: v[i].detach().clone().requires_grad_() for k, v in x.items()}
            g = {k: torch.zeros_like(v) for k, v in leaves.items()}
            node_loss = 0.0
            for j in range(accum):
                lo = i * b + j * mb
                tokens, targets = batch["tokens"][lo:lo + mb], batch["targets"][lo:lo + mb]
                if fault == "half_batch":  # half the rows, or of the tokens of one row
                    half = (slice(mb // 2),) if mb > 1 else (slice(None), slice(
                        tokens.shape[1] // 2))
                    tokens, targets = tokens[half], targets[half]
                loss = family.forward_loss(leaves, tokens, targets, model)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                for (k, acc), gk in zip(g.items(), grads):
                    acc.add_(gk / accum)
                node_loss += float(loss.detach()) / accum
                del loss, grads
            losses.append(node_loss)
            for k in x:
                payload.setdefault(k, torch.empty_like(x[k]))[i] = x[k][i] - lr * g[k]
                if step == 0:
                    raw.setdefault(k, []).append(float(torch.linalg.vector_norm(g[k])))
            del leaves, g
        out["losses"].append(sum(losses) / n)
        if step == 0:
            out["grad_raw"] = raw
        for k in x:
            p = payload.pop(k)
            if fault == "no_exchange":
                mix = p
            elif comp:
                sent = torch.empty_like(p)
                for j in range(n):
                    sent[j], err[k][j] = comp.send(p[j], err[k][j])
                mix = torch.stack([
                    float(W[i, i]) * p[i]
                    + sum(float(W[i, j]) * sent[j] for j in range(n) if j != i)
                    for i in range(n)])
            else:
                mix = torch.stack([sum(float(W[i, j]) * p[j] for j in range(n))
                                   for i in range(n)])
            g_tilde = (x[k] - mix) / lr
            m[k] = beta * m[k] + g_tilde
            x[k] = x[k] - lr * m[k]
            del p, mix, g_tilde
        if step == 0:
            out["m1"] = {k: _norms(v) for k, v in m.items()}
            out["m1_blocks"] = {k: _block_norms(v) for k, v in m.items()}
    out["dx"] = {k: _norms(x[k] - x0[k].unsqueeze(0)) for k in x}
    out["dx_blocks"] = {k: _block_norms(x[k] - x0[k].unsqueeze(0)) for k in x}
    if comp:
        out["ef"] = {k: _norms(v) for k, v in err.items()}
    return out
