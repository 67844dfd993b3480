# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Record ``sqd_tpu``'s orbital optimization on ``chip_smoke.py``'s phase-11 (a) problem.

The headline integrals (``sqd_tpu_torch/data/n2_631g_cas16o_5a5b.fcidump``)
are rotated by ``chip_smoke.oo_inputs()``'s random generator with
``sqd_tpu.fermion.rotate_integrals``; ``sqd_tpu.fermion.optimize_orbitals``
then runs from ``k = 0`` over the 181 x 181 excitation strings with
``chip_smoke.OO``'s settings and ``solve_sci``'s defaults (f64 at 32,761
determinants).  Writes ``sqd_tpu_torch/data/oo_n2_631g.json``: each outer
iteration's solve energy, the final ``k_flat``, the occupancies, the energy
of the same subspace in the unrotated basis, and the seconds it took.  JAX on
the CPU; run from the repository root (about a minute)::

    python tools/make_oo_data.py
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
    import numpy as np

    from chip_smoke import DATA_STEM, OO, OO_DATA, oo_inputs
    from sqd_tpu import fermion
    from sqd_tpu.models.fcidump import read_fcidump

    dump = read_fcidump(DATA_STEM + ".fcidump")
    k_rand, strings = oo_inputs()
    h_rand, eri_rand = fermion.rotate_integrals(dump["h1e"], dump["eri"], k_rand)
    unrotated = fermion.solve_sci(strings, dump["h1e"], dump["eri"], 16, (5, 5), spin_sq=0.0)

    energies = []
    solve = fermion.solve_sci

    def recorded_solve(*args, **kwargs):
        result = solve(*args, **kwargs)
        energies.append(float(result.energy))
        return result

    fermion.solve_sci = recorded_solve
    t0 = time.perf_counter()
    try:
        energy, k_final, occupancies = fermion.optimize_orbitals(
            strings, h_rand, eri_rand, np.zeros(120),
            num_iters=OO["num_iters"], num_steps_grad=OO["num_steps_grad"],
            learning_rate=OO["learning_rate"], momentum=OO["momentum"],
        )
    finally:
        fermion.solve_sci = solve
    seconds = time.perf_counter() - t0
    record = {
        "problem": "N2/6-31G CAS(16o,(5,5)e) from n2_631g_cas16o_5a5b.fcidump, rotated by "
        "chip_smoke.oo_inputs()'s k_rand; 181 x 181 excitation strings (seeds 1, 2)",
        "settings": OO,
        "iteration_energies": energies,
        "energy": float(energy),
        "k_flat": [float(x) for x in k_final],
        "occupancies": [[float(x) for x in occ] for occ in occupancies],
        "unrotated_energy": float(unrotated.energy),
        "ecore": float(dump["ecore"]),
        "reference": "sqd_tpu.fermion.optimize_orbitals from k = 0 with solve_sci's defaults "
        "(spin_sq 0.0, f64 Davidson, tol 1e-6), JAX on the CPU",
        "reference_seconds_cpu": seconds,
        "command": "python tools/make_oo_data.py",
    }
    with open(OO_DATA, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
