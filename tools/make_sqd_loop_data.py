# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Record iteration 0 of ``sqd_tpu``'s SQD loop on ``chip_smoke.py``'s phase-6 problem.

Runs ``sqd_tpu.fermion.diagonalize_fermionic_hamiltonian`` (JAX, on the CPU)
on the headline integrals (``sqd_tpu_torch/data/n2_631g_cas16o_5a5b.fcidump``)
with ``chip_smoke.loop_shots()`` as samples and ``chip_smoke.LOOP_SETTINGS``
cut to ``max_iterations=1``, and writes
``sqd_tpu_torch/data/sqd_loop_n2_631g.json``: each batch's string counts, a
sha256 of its sorted int64 alpha and beta strings, and its energy.
Iteration 0 (postselection, then ``subsample`` on the loop's NumPy generator)
is NumPy-deterministic in both packages, so the port must reproduce the
strings exactly and the energies within 1e-7 Ha.

The solves run with ``solver_dtype=float64``: on the CPU the default f32
Davidson does not converge at 10^6 determinants.  Run from the repository
root on a CPU host (a few minutes, some 8 GB of memory)::

    python tools/make_sqd_loop_data.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from chip_smoke import DATA_STEM, LOOP_DATA, LOOP_SETTINGS, loop_shots, strings_digest
    from sqd_tpu.fermion import diagonalize_fermionic_hamiltonian
    from sqd_tpu.models.fcidump import read_fcidump
    from sqd_tpu.primitives import BitArray

    dump = read_fcidump(DATA_STEM + ".fcidump")
    settings = dict(LOOP_SETTINGS, max_iterations=1)
    results = []
    t0 = time.perf_counter()
    diagonalize_fermionic_hamiltonian(
        dump["h1e"], dump["eri"], BitArray.from_bool_array(loop_shots()),
        norb=16, nelec=(5, 5), callback=results.extend,
        solver_options={"solver_dtype": jnp.float64}, **settings,
    )
    seconds = time.perf_counter() - t0
    record = {
        "problem": "N2/6-31G CAS(16o,(5,5)e) from n2_631g_cas16o_5a5b.fcidump",
        "shots": "chip_smoke.loop_shots(): 200,000 rows of 32 bits, seed 5",
        "settings": settings,
        "batches": [
            {
                "n_alpha": len(r.sci_state.ci_strs_a),
                "n_beta": len(r.sci_state.ci_strs_b),
                "sha256_alpha": strings_digest(r.sci_state.ci_strs_a),
                "sha256_beta": strings_digest(r.sci_state.ci_strs_b),
                "energy": float(r.energy),
            }
            for r in results
        ],
        "ecore": float(dump["ecore"]),
        "reference": "sqd_tpu.fermion.diagonalize_fermionic_hamiltonian, "
        "solver_options={'solver_dtype': float64}, JAX on the CPU",
        "reference_seconds_cpu": seconds,
        "command": "python tools/make_sqd_loop_data.py",
    }
    with open(LOOP_DATA, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
