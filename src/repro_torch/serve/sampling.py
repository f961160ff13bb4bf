"""Greedy sampling and the step-the-cache decode loop (the port of
``repro.serve.sampling``).

``decode_fn`` is anything with the ``build_decode_step`` calling shape
``(params, tokens, cache, t) -> (logits, cache)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any
DecodeFn = Callable[[Tree, torch.Tensor, Tree, torch.Tensor], tuple[torch.Tensor, Tree]]

__all__ = ["greedy_token", "greedy_decode_loop"]


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling: ``(B, V) -> (B,)`` int32 argmax token ids (the first
    maximum on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_decode_loop(decode_fn: DecodeFn, params: Tree, cache: Tree,
                       first_tokens: torch.Tensor, t0, n_steps: int
                       ) -> tuple[torch.Tensor, Tree]:
    """Autoregressive greedy generation for ``n_steps`` tokens.

    ``first_tokens`` is the ``(B, 1)`` token batch to feed first (typically
    the last prompt token); ``t0`` is its absolute position, scalar or
    per-slot ``(B,)``.  Returns the ``(B, n_steps)`` generated tokens and
    the final cache."""
    tok = first_tokens
    t = torch.as_tensor(t0, dtype=torch.int32)
    cols = []
    for _ in range(n_steps):
        logits, cache = decode_fn(params, tok, cache, t)
        tok = greedy_token(logits)[:, None]
        cols.append(tok)
        t = t + 1
    return torch.cat(cols, dim=1), cache
