# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Orbital optimization: recover energy lost to subspace truncation.

The port of ``examples/04_orbital_optimization.py`` (the reference guide
docs/guides/use_oo_to_optimize_hamiltonian_basis.ipynb): solve in a small
truncated subspace, then alternate integral rotation / SCI solve / SGD on the
rotation generator to lower the variational energy.  On the card each SGD
step is one replayed CUDA graph; on the CPU the same step runs eagerly, and
both print the same numbers.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/04_orbital_optimization.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import optimize_orbitals, rotate_integrals, solve_sci
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.ops import dense_fci
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)

    # randomly rotate the basis (as the reference guide does) so the sampled
    # subspace is no longer aligned with the natural orbitals
    rng = np.random.default_rng(1)
    k_rand = rng.normal(size=(norb * (norb - 1)) // 2) * 0.4
    h1_rot, eri_rot = rotate_integrals(h1, eri, k_rand, device=device)

    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    sel = np.sort(rng.choice(strs, 6, replace=False))  # a small truncated subspace

    res0 = solve_sci((sel, sel), h1_rot, eri_rot, norb=norb, nelec=nelec, device=device)
    print(f"truncated-subspace energy (rotated basis): {res0.energy:.8f}")

    num_params = (norb * (norb - 1)) // 2
    e_opt, k_opt, occ = optimize_orbitals(
        (sel, sel),
        h1_rot,
        eri_rot,
        np.zeros(num_params),
        num_iters=6,
        num_steps_grad=500,
        learning_rate=0.05,
        device=device,
    )
    print(f"after orbital optimization:                {e_opt:.8f}")
    exact = np.linalg.eigvalsh(
        dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    )[0]
    print(f"exact FCI (basis-independent):             {exact:.8f}")
    print(f"recovered {res0.energy - e_opt:.6f} Ha of truncation error")


if __name__ == "__main__":
    main()
