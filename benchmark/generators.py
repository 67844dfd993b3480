"""The benchmark's traffic generators: CI-string sets and synthetic shots.

Frozen copies of the repository's own generators, so that a later change to
those scripts cannot move the yardstick: :func:`excitation_strings` is
``bench_torch.excitation_strings`` and :func:`shots` is ``chip_smoke._shots``
(``benchmark/tests/test_frozen.py`` holds both to their originals).  Each
takes a seed that NumPy's ``default_rng`` accepts: an int, or a list of
non-negative ints such as ``[seed, k]``.
"""

from __future__ import annotations

import itertools

import numpy as np


def excitation_strings(count, norb, n_elec, seed):
    """HF determinant + a random walk of low-order excitations (SQD-like set)."""
    r = np.random.default_rng(seed)
    hf = (1 << n_elec) - 1
    seen = {hf}
    frontier = [hf]
    while len(seen) < count:
        base = frontier[r.integers(len(frontier))] if frontier else hf
        occ = [p for p in range(norb) if (base >> p) & 1]
        virt = [p for p in range(norb) if not (base >> p) & 1]
        o = occ[r.integers(len(occ))]
        v = virt[r.integers(len(virt))]
        new = base ^ (1 << o) ^ (1 << v)
        if new not in seen:
            seen.add(new)
            frontier.append(new)
            if len(frontier) > 64:
                frontier.pop(0)
    return np.array(sorted(seen), dtype=np.int64)


def all_strings(norb, n_elec):
    """Every ``norb``-bit string with ``n_elec`` bits set, ascending."""
    return np.array(sorted(sum(1 << p for p in occ)
                           for occ in itertools.combinations(range(norb), n_elec)),
                    dtype=np.int64)


def shots(strs_a, strs_b, norb, n_shots, seed):
    """``(n_shots, 2 * norb)`` bool rows ``[b_{norb-1}..b_0, a_{norb-1}..a_0]``:
    80 % (alpha, beta) pairs drawn uniformly from the two string sets, 20 %
    uniform random bits that configuration recovery has to repair."""
    rng = np.random.default_rng(seed)
    n_pairs = n_shots * 4 // 5
    pick_a = strs_a[rng.integers(0, len(strs_a), n_pairs)]
    pick_b = strs_b[rng.integers(0, len(strs_b), n_pairs)]
    shifts = np.arange(norb - 1, -1, -1)
    pairs = np.hstack([(pick_b[:, None] >> shifts) & 1, (pick_a[:, None] >> shifts) & 1])
    noise = rng.integers(0, 2, size=(n_shots - n_pairs, 2 * norb))
    return np.vstack([pairs, noise]).astype(bool)


def seed_words(seed: int, *more: int) -> list[int]:
    """``default_rng`` entropy for a run's ``--seed`` and sub-stream ``more``:
    any whole number, a negative one included, maps to non-negative words."""
    return [seed % (1 << 64), int(seed < 0), *more]
