# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Choosing the subspace dimension: accuracy vs cost.

The port of ``examples/09_choose_subspace_dimension.py`` (the reference guide
docs/guides/choose_subspace_dimension.ipynb): sweep ``samples_per_batch`` /
``max_dim`` and watch the eigenvalue-estimate error shrink as the subspace
grows toward the full CI space.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/09_choose_subspace_dimension.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import BitArray, diagonalize_fermionic_hamiltonian
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.ops import dense_fci
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)
    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    evals, evecs = np.linalg.eigh(h_dense)
    probs = np.abs(evecs[:, 0]) ** 2
    probs /= probs.sum()

    rng = np.random.default_rng(0)
    n = len(strs)
    draws = rng.choice(n * n, size=8000, p=probs)
    rows = []
    for d in draws:
        sa, sb = int(strs[d // n]), int(strs[d % n])
        row = np.zeros(2 * norb, dtype=bool)
        for p in range(norb):
            if (sb >> p) & 1:
                row[norb - 1 - p] = True
            if (sa >> p) & 1:
                row[2 * norb - 1 - p] = True
        rows.append(row)
    bit_array = BitArray.from_bool_array(np.array(rows))

    print(f"full CI: per-spin dim {n}, total {n * n}, E = {evals[0]:.8f}\n")
    print(f"{'max_dim':>8} {'dim_a x dim_b':>14} {'energy':>14} {'error':>12}")
    for max_dim in [4, 8, 12, 16, 20]:
        result = diagonalize_fermionic_hamiltonian(
            h1,
            eri,
            bit_array,
            samples_per_batch=80,
            norb=norb,
            nelec=nelec,
            num_batches=2,
            max_iterations=4,
            max_dim=max_dim,
            seed=1,
            device=device,
        )
        da = len(result.sci_state.ci_strs_a)
        db = len(result.sci_state.ci_strs_b)
        print(
            f"{max_dim:>8} {f'{da} x {db}':>14} {result.energy:>14.8f} "
            f"{result.energy - evals[0]:>12.2e}"
        )


if __name__ == "__main__":
    main()
