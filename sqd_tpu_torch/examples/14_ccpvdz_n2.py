# (C) 2026. Licensed under the Apache License, Version 2.0.
"""BASELINE config 3: the full self-consistent SQD loop on N2/cc-pVDZ.

The port of ``examples/14_ccpvdz_n2.py``.  The reference's stated capability
envelope is ~25 spatial orbitals; N2/cc-pVDZ — 28 spherical AOs, d shells on
both atoms — sits right at it.  This example runs the whole pipeline inside
the package: geometry -> cc-pVDZ integrals (with the engine's Cartesian ->
real-solid-harmonic d transform) -> RHF -> 28-orbital correlation space ->
synthesized shots -> configuration recovery -> self-consistent SCI loop over
56-bit (multiword) CI strings.

The reference publishes no cc-pVDZ energy, so the printed checks are the
in-repo oracles: variational descent below RHF and a truncated window solved
exactly.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/14_ccpvdz_n2.py

or on the CPU as ``main(device="cpu")`` (``main(n_shots=1_500,
samples_per_batch=40, max_iterations=2, device="cpu")`` at a small size).
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch.chem import Molecule, active_space_integrals, rhf
from sqd_tpu_torch.chem.integrals import ao_integrals
from sqd_tpu_torch.fermion import diagonalize_fermionic_hamiltonian, solve_sci
from sqd_tpu_torch.ops.dense_fci import all_hamming_strings
from sqd_tpu_torch.primitives import BitArray
from sqd_tpu_torch.utils.device import checked_device


def main(n_shots: int = 3_000, samples_per_batch: int = 50, max_iterations: int = 3,
         device="cuda"):
    device = checked_device(device)
    mol = Molecule([("N", (0, 0, 0)), ("N", (1.0977, 0, 0))], basis="cc-pvdz")
    print(f"N2/cc-pVDZ: {mol.nao} spherical AOs ({mol.nao_cart} Cartesian)")
    ints = ao_integrals(mol)
    mf = rhf(mol, integrals=ints)
    print(f"RHF energy: {mf.e_tot:.9f} Ha (converged={mf.converged})")

    norb, nelec = 28, (7, 7)
    h1, eri, ecore = active_space_integrals(mf, ncas=norb, nelecas=14)

    # --- synthesize shots: exact ground state of a valence window ----------
    h1w, eriw, _ = active_space_integrals(mf, ncas=8, nelecas=10)
    strs_w = all_hamming_strings(8, 5)
    res_w = solve_sci((strs_w, strs_w), h1w, eriw, 8, (5, 5), tol=1e-9, device=device)
    amps = np.asarray(res_w.sci_state.amplitudes)
    probs = (amps.reshape(-1) ** 2).ravel()
    probs /= probs.sum()
    rng = np.random.default_rng(7)
    addr = rng.choice(probs.size, size=n_shots, p=probs)
    ia, ib = np.divmod(addr, amps.shape[1])
    core = (1 << 2) - 1  # the window sits above 2 core orbitals

    def to_bool(strings):
        shifts = np.arange(norb - 1, -1, -1)
        full = (np.asarray(strings, np.int64) << 2) | core
        return ((full[:, None] >> shifts) & 1).astype(bool)

    rows = np.hstack([to_bool(strs_w[ib]), to_bool(strs_w[ia])])
    bit_array = BitArray.from_bool_array(rows)
    print(f"{bit_array.num_shots} shots of {bit_array.num_bits} bits (multiword strings)")

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
        symmetrize_spin=True,
        callback=callback,
        seed=np.random.default_rng(11),
        device=device,
    )
    e_tot = result.energy + ecore
    print(f"SQD energy:  {e_tot:.9f} Ha")
    print(f"Correlation captured vs RHF: {mf.e_tot - e_tot:.6f} Ha")
    assert e_tot < mf.e_tot, "SQD energy must descend below RHF"
    return e_tot


if __name__ == "__main__":
    main()
