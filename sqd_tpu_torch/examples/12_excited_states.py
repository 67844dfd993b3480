# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Excited states on both stacks: block Davidson for the k lowest eigenpairs.

The port of ``examples/12_excited_states.py``.  The reference reaches
excited states only through the qubit path's scipy passthrough
(``eigsh(..., k=...)``).  Here both stacks have them on the card:

* ``sqd_tpu_torch.fermion.solve_sci_excited`` — the k lowest CI states of a
  real molecule (N2/STO-3G valence CAS), each with its own RDMs and
  occupancies;
* ``sqd_tpu_torch.qubit.solve_qubit_device(k=...)`` — the k lowest
  eigenpairs of a projected Pauli sum (Heisenberg ring), cross-checked
  against scipy.

Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/12_excited_states.py

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
from sqd_tpu_torch.chem import Molecule, active_space_integrals, rhf
from sqd_tpu_torch.fermion import solve_sci_excited
from sqd_tpu_torch.models.heisenberg import heisenberg_ring
from sqd_tpu_torch.ops.dense_fci import all_hamming_strings
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)

    # --- fermionic: lowest 3 states of the N2 valence CAS -------------------
    mol = Molecule([("N", (0, 0, 0)), ("N", (0, 0, 1.09768))], basis="sto-3g")
    mf = rhf(mol)
    h1, eri, ecore = active_space_integrals(mf, ncas=8, nelecas=10)
    strs = all_hamming_strings(8, 5)
    results = solve_sci_excited((strs, strs), h1, eri, 8, (5, 5), k=3, tol=1e-8, device=device)
    print("N2/STO-3G CAS(8o,10e), lowest 3 CI states:")
    for i, r in enumerate(results):
        s2 = r.sci_state.spin_square()
        print(f"  state {i}: E = {r.energy + ecore:.6f} Ha   <S^2> = {s2:.3f}")
    gap = results[1].energy - results[0].energy
    print(f"  first excitation energy: {gap:.6f} Ha ({gap * 27.2114:.2f} eV)")

    # --- qubit path: lowest 3 of a Heisenberg ring, vs scipy ----------------
    n = 10
    op = heisenberg_ring(n, j_xx=1.0, j_yy=1.0, j_zz=0.8, h_z=0.3)
    rng = np.random.default_rng(7)
    ints = np.unique(rng.integers(0, 1 << n, size=700, dtype=np.int64))
    mat = np.array([[bool(int(b)) for b in format(i, f"0{n}b")] for i in ints])
    w_dev, v_dev, _ = qubit.solve_qubit_device(mat, op, k=3, tol=1e-9, device=device)
    w_ref, _ = qubit.solve_qubit(mat, op, k=3, which="SA", device=device)
    print(f"\nHeisenberg L={n} (subspace d={len(ints)}), lowest 3 eigenvalues:")
    for i in range(3):
        print(f"  device {w_dev[i]: .8f}   scipy {np.sort(w_ref)[i]: .8f}")
    assert np.allclose(np.sort(w_dev), np.sort(w_ref), atol=1e-7)
    print("device block Davidson matches scipy eigsh.")


if __name__ == "__main__":
    main()
