# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Open-shell SQD from an ROHF mean field: triplet methylene (CH2).

The port of ``examples/16_open_shell_rohf.py``.  The reference obtains
open-shell orbitals from PySCF (ROHF/UHF) upstream and passes
``nelec=(na, nb)`` into the solver
(docs/guides/select_open_closed_shell.ipynb).  This package computes the
open-shell mean field itself (:func:`sqd_tpu_torch.chem.rohf` /
:func:`sqd_tpu_torch.chem.uhf`) and runs the full SQD loop in the (4,2)
sector:

    geometry -> STO-3G integrals -> high-spin ROHF (one spatial orbital set,
    docc|socc|virtual) -> frozen-core CAS(6o,(4,2)) -> shots -> recovery ->
    selected-CI -> energy vs the dense-FCI oracle.

UHF runs alongside as the diagnostic: its energy bounds ROHF from below and
its <S^2> measures spin contamination the restricted solution avoids.  Run
on the card from a checkout::

    python3 sqd_tpu_torch/examples/16_open_shell_rohf.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch.chem import Molecule, active_space_integrals, ao_integrals, rohf, uhf
from sqd_tpu_torch.fermion import diagonalize_fermionic_hamiltonian
from sqd_tpu_torch.ops.dense_fci import all_hamming_strings, build_dense_hamiltonian
from sqd_tpu_torch.primitives import BitArray
from sqd_tpu_torch.utils.device import checked_device

# triplet CH2: r(CH) = 1.0775 A, HCH angle 134 deg
_R, _HALF = 1.0775, np.deg2rad(134.0 / 2)
_X, _Z = _R * np.sin(_HALF), _R * np.cos(_HALF)


def main(n_shots: int = 2_000, samples_per_batch: int = 40, max_iterations: int = 3,
         device="cuda"):
    device = checked_device(device)
    mol = Molecule(
        [("C", (0.0, 0.0, 0.0)), ("H", (_X, 0.0, _Z)), ("H", (-_X, 0.0, _Z))],
        basis="sto-3g",
    )
    ints = ao_integrals(mol)
    mf = rohf(mol, spin=2, integrals=ints)
    mf_u = uhf(mol, spin=2, integrals=ints)
    print(f"ROHF: E = {mf.e_tot:.9f} Ha (converged={mf.converged})")
    print(f"UHF:  E = {mf_u.e_tot:.9f} Ha, <S^2> = {mf_u.spin_square:.6f} (exact 2)")
    assert mf_u.e_tot <= mf.e_tot + 1e-10

    norb, nelec = 6, (4, 2)
    h1, eri, ecore = active_space_integrals(mf, ncas=norb, nelecas=nelec)

    # dense-FCI oracle over the full (4,2) sector
    sa = all_hamming_strings(norb, nelec[0])
    sb = all_hamming_strings(norb, nelec[1])
    hmat = build_dense_hamiltonian(sa, sb, h1, eri)
    w, v = np.linalg.eigh(hmat)
    e_exact = w[0] + ecore
    print(f"dense CAS(6o,(4,2)) ground state: {e_exact:.9f} Ha")

    # shots sampled from the exact CAS ground state (the reference's
    # integration-oracle pattern)
    probs = v[:, 0] ** 2
    probs /= probs.sum()
    rng = np.random.default_rng(3)
    addr = rng.choice(probs.size, size=n_shots, p=probs)
    ia, ib = np.divmod(addr, len(sb))

    def to_bool(strings):
        shifts = np.arange(norb - 1, -1, -1)
        return ((np.asarray(strings, np.int64)[:, None] >> shifts) & 1).astype(bool)

    rows = np.hstack([to_bool(sb[ib]), to_bool(sa[ia])])
    bit_array = BitArray.from_bool_array(rows)

    energies = []

    def callback(results):
        e = min(r.energy for r in results) + ecore
        energies.append(e)
        print(f"  iteration {len(energies)}: E = {e:.9f} Ha")

    result = diagonalize_fermionic_hamiltonian(
        h1,
        eri,
        bit_array,
        samples_per_batch=samples_per_batch,
        norb=norb,
        nelec=nelec,
        max_iterations=max_iterations,
        callback=callback,
        seed=np.random.default_rng(5),
        device=device,
    )
    e_tot = result.energy + ecore
    print(f"SQD energy: {e_tot:.9f} Ha  (error {abs(e_tot - e_exact):.2e} Ha)")
    assert e_tot >= e_exact - 1e-9  # variational
    assert abs(e_tot - e_exact) < 5e-3
    return e_tot


if __name__ == "__main__":
    main()
