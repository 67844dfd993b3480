# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Write the N2/cc-pVDZ integrals and ``sqd_tpu``'s record for ``chip_smoke.py`` phase 8.

Phase 8 runs BASELINE config 3, the SQD loop on N2/cc-pVDZ over all 28
orbitals with 14 electrons (no frozen core), at R = 1.0977 Angstrom as in
``tests/test_chem_ccpvdz.py``.  This script, with ``sqd_tpu`` (JAX on the
CPU), writes:

* ``sqd_tpu_torch/data/n2_ccpvdz_28o_7a7b.fcidump``: ``sqd_tpu.chem`` RHF and
  ``active_space_integrals(ncas=28, nelecas=14)``, written with
  ``sqd_tpu.models.fcidump.write_fcidump``;
* ``sqd_tpu_torch/data/n2_ccpvdz_28o_7a7b.json``: ``ecore`` and the RHF
  energy; iteration 0 of ``sqd_tpu.fermion.diagonalize_fermionic_hamiltonian``
  on ``chip_smoke.ccpvdz_shots()`` with ``chip_smoke.CCPVDZ_SETTINGS`` (each
  batch's string counts and the sha256 of its sorted int64 alpha and beta
  strings, taken by a recording ``sci_solver``: iteration 0's strings depend
  on no solve); ``sqd_tpu``'s f64 ``solve_sci`` energy
  (``eri_factor="auto"``) on the first ``CCPVDZ_SUB_BATCH`` strings per spin
  of batch 0; and what ``pivoted_cholesky_pairs`` gives on these integrals
  (``"auto"``'s rank cap ``npair // 3``, and no cap).

Every number is computed from the integrals as read back from the FCIDUMP,
as the port reads them.  Run from the repository root on a CPU host (about
half a minute)::

    python tools/make_ccpvdz_data.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_NN = 1.0977  # Angstrom, as tests/test_chem_ccpvdz.py


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from chip_smoke import (
        CCPVDZ_SETTINGS, CCPVDZ_STEM, CCPVDZ_SUB_BATCH, ccpvdz_shots, strings_digest,
    )
    from sqd_tpu.chem import Molecule, active_space_integrals, rhf
    from sqd_tpu.fermion import SCIResult, SCIState, diagonalize_fermionic_hamiltonian, solve_sci
    from sqd_tpu.models.fcidump import read_fcidump, write_fcidump
    from sqd_tpu.ops.hamiltonian import pivoted_cholesky_pairs
    from sqd_tpu.primitives import BitArray

    norb, nelec = 28, (7, 7)
    t0 = time.perf_counter()
    mf = rhf(Molecule([("N", (0, 0, 0)), ("N", (R_NN, 0, 0))], basis="cc-pvdz"))
    if not mf.converged:
        raise SystemExit("RHF did not converge")
    h1, eri, ecore = active_space_integrals(mf, ncas=norb, nelecas=sum(nelec))
    write_fcidump(CCPVDZ_STEM + ".fcidump", h1, eri, nelec=nelec, ecore=float(ecore))
    dump = read_fcidump(CCPVDZ_STEM + ".fcidump")
    h1, eri = dump["h1e"], dump["eri"]

    seen = []

    def recording_solver(ci_strings, one_body, two_body, n_orb, n_elec):
        seen.extend(ci_strings)
        return [
            SCIResult(0.0, SCIState(np.zeros((len(a), len(b))), a, b, n_orb, n_elec),
                      orbital_occupancies=(np.zeros(n_orb), np.zeros(n_orb)))
            for a, b in ci_strings
        ]

    settings = dict(CCPVDZ_SETTINGS, max_iterations=1)
    diagonalize_fermionic_hamiltonian(
        h1, eri, BitArray.from_bool_array(ccpvdz_shots()), norb=norb, nelec=nelec,
        sci_solver=recording_solver, **settings,
    )
    strs_a, strs_b = seen[0]
    sub = (strs_a[:CCPVDZ_SUB_BATCH], strs_b[:CCPVDZ_SUB_BATCH])
    sub_energy = float(solve_sci(sub, h1, eri, norb, nelec, eri_factor="auto").energy)
    npair = norb * norb
    auto = pivoted_cholesky_pairs(eri, norb, max_rank=npair // 3)
    uncapped = pivoted_cholesky_pairs(eri, norb)
    seconds = time.perf_counter() - t0
    record = {
        "problem": f"N2/cc-pVDZ at R = {R_NN} Angstrom, all 28 orbitals, (7,7)e, "
        "from n2_ccpvdz_28o_7a7b.fcidump",
        "shots": "chip_smoke.ccpvdz_shots(): 200,000 rows of 56 bits, seed 6",
        "settings": settings,
        "ecore": float(dump["ecore"]),
        "rhf_energy": float(mf.e_tot),
        "batches": [
            {
                "n_alpha": len(a),
                "n_beta": len(b),
                "sha256_alpha": strings_digest(a),
                "sha256_beta": strings_digest(b),
            }
            for a, b in seen
        ],
        "sub_batch": {
            "strings": f"the first {CCPVDZ_SUB_BATCH} alpha and beta strings of batch 0",
            "energy": sub_energy,
        },
        "cholesky_rank_auto": None if auto is None else int(auto.shape[0]),
        "cholesky_rank_uncapped": None if uncapped is None else int(uncapped.shape[0]),
        "reference": "sqd_tpu (JAX on the CPU): chem.rhf, active_space_integrals, "
        "fermion.diagonalize_fermionic_hamiltonian with a recording sci_solver, "
        "fermion.solve_sci (f64)",
        "reference_seconds_cpu": seconds,
        "command": "python tools/make_ccpvdz_data.py",
    }
    with open(CCPVDZ_STEM + ".json", "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
