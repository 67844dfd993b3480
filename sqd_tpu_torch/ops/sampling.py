# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Weighted sampling without replacement on tensors (Gumbel-top-k).

The port of ``sqd_tpu.ops.sampling``.  Adding i.i.d. Gumbel noise to
log-weights and taking the top k samples k items without replacement with
probabilities proportional to the weights, the successive-draw law of
``rng.choice(replace=False, p=w)``.

``torch`` cannot reproduce ``jax.random``'s streams, so the functions take
their noise (or the ``torch.Generator`` that draws it) from the caller: the
tests hand both packages the same noise.
"""

from __future__ import annotations

import torch

__all__ = ["gumbel", "gumbel_topk_indices", "rank_by_gumbel"]


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """f64 standard Gumbel noise ``-log(-log(u))`` on the generator's device,
    ``u`` uniform in ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64, device=generator.device)
    u.clamp_(min=torch.finfo(torch.float64).tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_indices(log_weights: torch.Tensor, k: int, noise: torch.Tensor) -> torch.Tensor:
    """Indices of ``k`` items drawn without replacement along the last axis.

    p is proportional to ``exp(log_weights)``; ``noise`` is standard Gumbel
    noise of the same shape.  Entries with ``log_weights == -inf`` are never
    selected while at least ``k`` finite entries exist.
    """
    return torch.topk(log_weights + noise, k, dim=-1).indices


def rank_by_gumbel(log_weights: torch.Tensor, noise: torch.Tensor):
    """Per-row descending rank of perturbed log-weights, and the scores.

    The entry holding the largest ``log_weights + noise`` gets rank 0, so
    ``ranks < k`` selects a weighted sample of k items without replacement
    per row.  Both sorts are stable, as ``jnp.argsort`` is, so ties (the
    ``-inf`` entries) rank in index order as in ``sqd_tpu``.
    """
    scores = torch.where(torch.isneginf(log_weights), -torch.inf, log_weights + noise)
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks, scores
