#!/usr/bin/env python3
# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Lowest levels of a sparse subspace by three solvers, seed by seed (CPU).

The 20-site Heisenberg ring with a Dzyaloshinskii-Moriya term (D = 0.3,
``chip_smoke.dm_ring_terms``) over 5000 unique 20-bit strings drawn from a
seed: 0.5 % of the space, so most strings are connected to no other and an
isolated string often holds the lowest level.  For each seed prints the k
lowest levels from ``scipy``'s ``eigsh`` on the projected matrix, from the
port's ``solve_qubit_device(k=...)`` and from ``sqd_tpu``'s, with seconds::

    python tools/davidson_isolated_levels.py [k] [seeds]

``tests/test_torch_qubit.py`` holds seed 1 (its ``_sparse_dm_ring_strings``
draws the same strings); ROADMAP.md section C3 records what this showed.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from sqd_tpu import qubit as jax_qubit
    from sqd_tpu.primitives import SparsePauliOp as JaxSparsePauliOp
    from sqd_tpu_torch import qubit
    from sqd_tpu_torch.primitives import SparsePauliOp

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    n, d = 20, 5000
    terms = chip_smoke.dm_ring_terms(n, 0.3)
    op, jop = SparsePauliOp.from_list(terms), JaxSparsePauliOp.from_list(terms)
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        ints = np.unique(rng.integers(0, 1 << n, size=6000, dtype=np.int64))
        ints = np.sort(rng.permutation(ints)[:d])
        mat = ((ints[:, None] >> np.arange(n)[::-1]) & 1).astype(bool)
        v0 = np.random.default_rng(0).normal(size=d)
        out = []
        for solve in (
            lambda: qubit.solve_qubit(mat, op, device="cpu", k=k, which="SA", v0=v0)[0],
            lambda: qubit.solve_qubit_device(mat, op, k=k, device="cpu")[0],
            lambda: jax_qubit.solve_qubit_device(mat, jop, k=k)[0],
        ):
            t0 = time.perf_counter()
            levels = np.sort(np.atleast_1d(solve()))
            out.append(f"{np.round(levels, 6).tolist()} ({time.perf_counter() - t0:.1f} s)")
        print(f"seed {seed}, k = {k}: eigsh {out[0]}; sqd_tpu_torch {out[1]}; sqd_tpu {out[2]}",
              flush=True)


if __name__ == "__main__":
    main()
