# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Write ``sqd_tpu.chem``'s record for ``chip_smoke.py`` phase 12 ("from geometry").

Phase 12 runs the port's own chemistry (``sqd_tpu_torch.chem``) on the card's
host and holds it against this record, computed here with ``sqd_tpu.chem``
(NumPy, its native integrals; JAX is imported but not used) on the
molecules that ``chip_smoke.py`` defines:

* N2/6-31G at ``tools/make_headline_data.py``'s geometry: the RHF ``e_tot``
  and the CAS(16o,10e) ``ecore`` (which must equal the committed FCIDUMP's);
* triplet CH2/STO-3G (``examples/16_open_shell_rohf.py``'s geometry): the
  ROHF and UHF ``e_tot`` and the UHF ``<S^2>``;
* [2Fe-2S]/STO-3G (``tests/test_chem_fe2s2.py``'s rhombus): orbital-free
  digests of ``S``, ``T``, ``V`` and ``eri`` (``chip_smoke.integral_digests``)
  and the ROHF ``e_tot`` after ``chip_smoke.FE2S2_ROHF``'s 80 cycles.

Rerun it when a geometry, a basis entry or ``FE2S2_ROHF`` changes.  From the
repository root on a CPU host (about 20 s)::

    python tools/make_chem_data.py
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
    import chip_smoke as c
    from sqd_tpu.chem import Molecule, active_space_integrals, ao_integrals, rhf, rohf, uhf

    t0 = time.perf_counter()
    n2 = rhf(Molecule(c.N2_ATOMS, basis="6-31g"))
    _, _, ecore = active_space_integrals(n2, ncas=16, nelecas=10)
    ch2 = Molecule(c.CH2_ATOMS, basis="sto-3g")
    ch2_ints = ao_integrals(ch2)
    ch2_rohf = rohf(ch2, spin=2, integrals=ch2_ints)
    ch2_uhf = uhf(ch2, spin=2, integrals=ch2_ints)
    fe2s2 = Molecule(c.FE2S2_ATOMS, basis="sto-3g")
    fe_ints = ao_integrals(fe2s2)
    fe_rohf = rohf(fe2s2, integrals=fe_ints, **c.FE2S2_ROHF)
    record = {
        "n2_631g": {"rhf_e_tot": n2.e_tot, "rhf_converged": n2.converged,
                    "cas16o10e_ecore": ecore},
        "ch2_sto3g_triplet": {"rohf_e_tot": ch2_rohf.e_tot, "uhf_e_tot": ch2_uhf.e_tot,
                              "uhf_spin_square": ch2_uhf.spin_square,
                              "converged": [ch2_rohf.converged, ch2_uhf.converged]},
        "fe2s2_sto3g": {"nao": fe2s2.nao, "digests": c.integral_digests(fe_ints),
                        "rohf_e_tot": fe_rohf.e_tot, "rohf_converged": fe_rohf.converged,
                        "rohf": c.FE2S2_ROHF},
        "reference": "sqd_tpu.chem on the CPU",
        "reference_seconds_cpu": time.perf_counter() - t0,
        "command": "python tools/make_chem_data.py",
    }
    with open(c.CHEM_DATA, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
