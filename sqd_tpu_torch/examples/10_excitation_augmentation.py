# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Augment the configuration pool with fermionic transition operators.

The port of ``examples/10_excitation_augmentation.py`` (the reference guide
docs/guides/add_fermionic_excitations_to_configuration_pool.ipynb): apply
transition-operator strings (I/+/-/n per mode) to every sampled
configuration, drop illegal applications, and diagonalize in the enlarged
subspace — useful for recovering configurations the sampler missed and for
targeting excited states.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/10_excitation_augmentation.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import enlarge_batch_from_transitions, solve_fermion
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.ops import dense_fci
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)

    # a deliberately tiny sample pool
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(6):
        row = np.zeros(2 * norb, dtype=bool)
        row[rng.choice(norb, 3, replace=False)] = True
        row[norb + rng.choice(norb, 3, replace=False)] = True
        rows.append(row)
    base = np.unique(np.array(rows), axis=0)

    e_base, state_base, _, _ = solve_fermion(base, h1, eri, device=device)
    print(f"base pool: {len(base)} configs -> E = {e_base:.8f}")

    # single-excitation transition operators acting on neighboring modes
    ops = []
    for i in range(2 * norb - 1):
        chars = ["I"] * (2 * norb)
        chars[i], chars[i + 1] = "+", "-"
        ops.append(chars)
        chars = ["I"] * (2 * norb)
        chars[i], chars[i + 1] = "-", "+"
        ops.append(chars)
    ops.append(["I"] * (2 * norb))  # keep the originals
    augmented = enlarge_batch_from_transitions(base, np.array(ops), device=device)
    # keep only rows with the right particle numbers per half
    keep = (augmented[:, norb:].sum(1) == nelec[0]) & (
        augmented[:, :norb].sum(1) == nelec[1]
    )
    augmented = np.unique(augmented[keep], axis=0)

    e_aug, state_aug, _, _ = solve_fermion(augmented, h1, eri, device=device)
    print(f"augmented: {len(augmented)} configs -> E = {e_aug:.8f}")

    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    exact = np.linalg.eigvalsh(dense_fci.build_dense_hamiltonian(strs, strs, h1, eri))[0]
    print(f"exact:     E = {exact:.8f}")
    print(f"augmentation recovered {e_base - e_aug:.6f} Ha")


if __name__ == "__main__":
    main()
