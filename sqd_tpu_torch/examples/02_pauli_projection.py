# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Qubit path: project a Heisenberg-ring Hamiltonian onto a sampled subspace.

The port of ``examples/02_pauli_projection.py`` (the reference guide
docs/guides/project_pauli_operators_onto_hilbert_subspaces.ipynb): an L-site
Heisenberg ring, a set of sampled bitstrings, the projected operator, and its
lowest eigenvalue — via both the scipy-parity path and the matrix-free
Davidson on the card.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/02_pauli_projection.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import qubit
from sqd_tpu_torch.models.heisenberg import heisenberg_ring
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    num_sites = 12
    op = heisenberg_ring(num_sites, h_z=0.1)
    print(f"{num_sites}-site Heisenberg ring, {op.size} Pauli terms")

    rng = np.random.default_rng(0)
    # sample half-filling-weighted random bitstrings
    samples = rng.integers(0, 2, size=(2000, num_sites)).astype(bool)
    mat = qubit.sort_and_remove_duplicates(samples)
    print(f"subspace dimension: {len(mat)} of 2^{num_sites} = {2**num_sites}")

    proj = qubit.project_operator_to_subspace(mat, op, device=device)
    energies, _ = qubit.solve_qubit(mat, op, k=1, which="SA", device=device)
    print(f"scipy eigsh lowest eigenvalue:  {energies[0]:.8f}")

    e_dev, vec, _ = qubit.solve_qubit_device(mat, op, device=device)
    print(f"device Davidson (matrix-free):  {e_dev:.8f}")
    print(f"projected operator nnz: {proj.nnz}")


if __name__ == "__main__":
    main()
