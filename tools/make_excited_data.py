# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Record ``sqd_tpu``'s three lowest states on ``chip_smoke.py``'s phase-11 (b) problem.

Runs ``sqd_tpu.fermion.solve_sci_excited(k=3)`` with its defaults (f64 block
Davidson, tol 1e-7) on the headline problem: the integrals of
``sqd_tpu_torch/data/n2_631g_cas16o_5a5b.fcidump`` over ``chip_smoke``'s
1000 x 1000 excitation strings (seeds 1 and 2), 10^6 determinants.  Writes
``sqd_tpu_torch/data/excited_n2_631g.json``: the k energies, their
occupancy sums, a sha256 of each spin's strings and the seconds it took.  JAX on the CPU; run from the repository root (some minutes)::

    python tools/make_excited_data.py
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

    from chip_smoke import DATA_STEM, EXCITED_DATA, EXCITED_K, excitation_strings, strings_digest
    from sqd_tpu.fermion import solve_sci_excited
    from sqd_tpu.models.fcidump import read_fcidump

    dump = read_fcidump(DATA_STEM + ".fcidump")
    strings = (excitation_strings(1000, 16, 5, 1), excitation_strings(1000, 16, 5, 2))
    t0 = time.perf_counter()
    results = solve_sci_excited(strings, dump["h1e"], dump["eri"], 16, (5, 5), k=EXCITED_K)
    seconds = time.perf_counter() - t0
    record = {
        "problem": "N2/6-31G CAS(16o,(5,5)e) from n2_631g_cas16o_5a5b.fcidump, "
        "1000 x 1000 excitation strings (seeds 1, 2)",
        "k": EXCITED_K,
        "sha256_alpha": strings_digest(strings[0]),
        "sha256_beta": strings_digest(strings[1]),
        "energies": [float(r.energy) for r in results],
        "occupancy_sums": [[float(o.sum()) for o in r.orbital_occupancies] for r in results],
        "ecore": float(dump["ecore"]),
        "reference": "sqd_tpu.fermion.solve_sci_excited(k=3) with its defaults "
        "(f64 block Davidson, tol 1e-7), JAX on the CPU",
        "reference_seconds_cpu": seconds,
        "command": "python tools/make_excited_data.py",
    }
    with open(EXCITED_DATA, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
