# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Quickstart: the full SQD loop on a 6-site Hubbard ring.

The port of ``examples/01_quickstart.py`` (the reference quickstart guide,
docs/guides/quickstart.ipynb): draw noisy samples, run self-consistent
configuration recovery + subsampled diagonalizations, and watch the energy
converge to the exact result.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/01_quickstart.py

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
from sqd_tpu_torch.utils.tracing import IterationLogger


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)

    # --- exact reference (small enough to diagonalize densely) -------------
    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    evals, evecs = np.linalg.eigh(h_dense)
    print(f"exact ground-state energy: {evals[0]:.8f}")

    # --- synthetic "QPU": sample from the ground state + uniform noise -----
    rng = np.random.default_rng(0)
    n = len(strs)
    probs = np.abs(evecs[:, 0]) ** 2
    probs /= probs.sum()
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
    rows += list(rng.integers(0, 2, size=(1500, 2 * norb)).astype(bool))  # noise
    bit_array = BitArray.from_bool_array(np.array(rows))

    # --- the SQD loop -------------------------------------------------------
    log = IterationLogger(log_level=None)
    result = diagonalize_fermionic_hamiltonian(
        h1,
        eri,
        bit_array,
        samples_per_batch=60,
        norb=norb,
        nelec=nelec,
        num_batches=3,
        max_iterations=6,
        seed=42,
        callback=log,
        device=device,
    )
    for entry in log.history:
        print(
            f"iteration {entry['iteration']}: best energy {entry['best_energy']:.8f} "
            f"(dims {entry['subspace_dims']}, {entry['wall_seconds']:.2f}s)"
        )
    print(f"SQD energy:   {result.energy:.8f}")
    print(f"error vs FCI: {result.energy - evals[0]:.2e}")


if __name__ == "__main__":
    main()
