"""The plain reference for the SQD loop's first iteration: which CI strings
each batch solves, from the shots and the loop's seed alone.

The loop's first iteration (``qiskit-addon-sqd``'s algorithm) keeps the
distinct shots whose right half has ``n_alpha`` bits set and left half
``n_beta``, weights each by its count, draws each batch with
``rng.choice(rows, samples_per_batch, replace=False, p=weights)`` from one
NumPy generator, and makes each batch's string sets from the distinct halves
in descending count order (merged for both spins when ``symmetrize_spin``),
cut to ``max_dim`` and sorted.  NumPy only.
"""

from __future__ import annotations

import numpy as np


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(">u8").view(np.uint8)).reshape(-1, 64).sum(1)


def _first_occurrences(vals: np.ndarray) -> np.ndarray:
    _, idx = np.unique(vals, return_index=True)
    return vals[np.sort(idx)]


def distinct_shots(shots: np.ndarray, norb: int):
    """Distinct rows of a ``(shots, 2 norb)`` bool matrix ``[b.., a..]`` in
    ascending order of the row read as a binary number, as (alpha, beta)
    strings, and each row's share of the shots."""
    n_shots, n_bits = shots.shape
    weights = np.left_shift(1, np.arange(n_bits - 1, -1, -1, dtype=np.int64))
    rows, counts = np.unique(shots.astype(np.int64) @ weights, return_counts=True)
    return rows & ((1 << norb) - 1), rows >> norb, counts / n_shots


def batch_strings(shots, norb, nelec, rng, *, samples_per_batch, num_batches, max_dim,
                  symmetrize_spin, **_):
    """Each batch's ``(alpha strings, beta strings)`` of the loop's first
    iteration; ``rng`` is the loop's generator, drawn from as the loop does."""
    alpha, beta, probs = distinct_shots(shots, norb)
    keep = (_popcount(alpha) == nelec[0]) & (_popcount(beta) == nelec[1])
    alpha, beta, probs = alpha[keep], beta[keep], probs[keep]
    probs = probs / np.sum(probs)
    out = []
    for _ in range(num_batches):
        if samples_per_batch >= len(alpha):
            pick = np.arange(len(alpha))
        else:
            pick = rng.choice(len(alpha), samples_per_batch, replace=False, p=probs)
        ua, ca = np.unique(alpha[pick], return_counts=True)
        ub, cb = np.unique(beta[pick], return_counts=True)
        if symmetrize_spin:
            merged = np.concatenate((ua, ub))[np.argsort(np.concatenate((ca, cb)))[::-1]]
            sa = sb = _first_occurrences(merged)[:max_dim]
        else:
            sa = _first_occurrences(ua[np.argsort(ca)[::-1]])[:max_dim]
            sb = _first_occurrences(ub[np.argsort(cb)[::-1]])[:max_dim]
        out.append((np.sort(sa), np.sort(sb)))
    return out
