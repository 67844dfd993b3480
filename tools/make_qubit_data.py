# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Write ``sqd_tpu``'s record of the Heisenberg solve that ``chip_smoke.py`` phase 9 runs.

The solve is ``probes/qubit_solve_1e7.py``'s: a 26-site Heisenberg ring
(J = 1, h_z = 0.1; 104 terms) over ``chip_smoke.solve_strings()`` (d = 10^7
unique strings from seed 7), through ``sqd_tpu.qubit.solve_qubit_device``
with ``tol=1e-6`` and ``dtype=jnp.float64``.  This script, with ``sqd_tpu``
(JAX on the CPU), writes ``sqd_tpu_torch/data/qubit_heisenberg26_1e7.json``:
the energy, ``d``, the sha256 of the strings as int64 bytes
(``chip_smoke.strings_digest``), the operator's group count and storage
flags, and the seconds the solve took.  Run from the repository root on a
CPU host (about 7.5 minutes and 17 GB)::

    python tools/make_qubit_data.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    from chip_smoke import QUBIT_DATA, QUBIT_SOLVE, solve_strings, strings_digest

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from sqd_tpu import qubit
    from sqd_tpu.models.heisenberg import heisenberg_ring

    sites, seed, tol = QUBIT_SOLVE["sites"], QUBIT_SOLVE["seed"], QUBIT_SOLVE["tol"]
    ints = solve_strings(sites, QUBIT_SOLVE["d"], seed)
    packed = ints.astype(np.uint32)[:, None]
    op = heisenberg_ring(sites, h_z=QUBIT_SOLVE["h_z"])
    t0 = time.perf_counter()
    energy, _, proj = qubit.solve_qubit_device(packed, op, tol=tol, dtype=jnp.float64)
    seconds = time.perf_counter() - t0
    record = {
        "sites": sites, "h_z": QUBIT_SOLVE["h_z"], "seed": seed, "tol": tol, "d": len(ints),
        "terms": len(op.coeffs), "sha256_strings": strings_digest(ints),
        "num_groups": proj.num_groups, "packed_weights": proj.packed_weights,
        "scan_matvec": proj.scan_matvec, "energy": float(energy), "seconds": round(seconds, 1),
        "solver": "sqd_tpu.qubit.solve_qubit_device(packed, op, tol=1e-6, dtype=jnp.float64), "
                  "JAX on the CPU",
    }
    with open(QUBIT_DATA, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
