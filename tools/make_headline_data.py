# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Write the headline problem's data files for ``sqd_tpu_torch``.

Produces, under ``sqd_tpu_torch/data/``:

* ``n2_631g_cas16o_5a5b.fcidump`` -- the N2/6-31G CAS(16o, (5,5)e) active-space
  integrals of ``bench.py`` (BASELINE config 1), computed with ``sqd_tpu.chem``
  and written with ``sqd_tpu.models.fcidump.write_fcidump`` (``%23.16E``).
* ``n2_631g_cas16o_5a5b.json`` -- ``ecore`` and the energy that
  ``sqd_tpu.fermion.solve_sci`` (the JAX reference) reaches on the bench
  headline strings, 1000 x 1000 ``bench.excitation_strings`` with seeds 1 and
  2.  The solve uses the integrals read back from the FCIDUMP, so the port and
  the reference see identical inputs.  It runs with ``solver_dtype=float64``:
  on the CPU the default f32 Davidson does not converge at this size (the
  Ritz value runs off below the spectrum), while the f64 solve is sound.

Run from the repository root on a CPU host (it takes a few minutes)::

    python tools/make_headline_data.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "sqd_tpu_torch", "data")
STEM = "n2_631g_cas16o_5a5b"


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import excitation_strings
    from sqd_tpu.chem import Molecule, active_space_integrals, rhf
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.models.fcidump import read_fcidump, write_fcidump

    mol = Molecule([("N", (0.0, 0.0, 0.0)), ("N", (1.0, 0.0, 0.0))], basis="6-31g")
    mf = rhf(mol)
    h1, eri, ecore = active_space_integrals(mf, ncas=16, nelecas=10)
    os.makedirs(DATA, exist_ok=True)
    fcidump = os.path.join(DATA, STEM + ".fcidump")
    write_fcidump(fcidump, h1, eri, nelec=(5, 5), ecore=ecore)
    dump = read_fcidump(fcidump)

    strs_a = excitation_strings(1000, 16, 5, 1)
    strs_b = excitation_strings(1000, 16, 5, 2)
    t0 = time.perf_counter()
    res = solve_sci(
        (strs_a, strs_b), dump["h1e"], dump["eri"], 16, (5, 5), solver_dtype=jax.numpy.float64
    )
    seconds = time.perf_counter() - t0
    record = {
        "problem": "N2/6-31G CAS(16o,(5,5)e), 1000 x 1000 excitation strings",
        "strings": "bench.excitation_strings(1000, 16, 5, seed) with seeds 1 (alpha), 2 (beta)",
        "ecore": float(dump["ecore"]),
        "energy": float(res.energy),
        "energy_total": float(res.energy + dump["ecore"]),
        "reference": "sqd_tpu.fermion.solve_sci, solver_dtype=float64, JAX on the CPU",
        "reference_seconds_cpu": seconds,
        "command": "python tools/make_headline_data.py",
    }
    with open(os.path.join(DATA, STEM + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
