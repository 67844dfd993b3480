# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Real-molecule input layer: Gaussian integrals, RHF/ROHF/UHF, CASCI active spaces.

A copy of ``sqd_tpu.chem`` (NumPy and SciPy on the host, the AO integrals in
the port's native library), so that the port goes from a molecule's geometry
to an energy by itself: ``Molecule`` -> :func:`ao_integrals` -> :func:`rhf`
(or :func:`rohf`, :func:`uhf`) -> :func:`active_space_integrals` ->
:func:`sqd_tpu_torch.fermion.solve_sci`.  ``sqd_tpu.chem`` is the numerical
reference: the algorithms, DIIS, level shifts and convergence tests are its
own, so the two agree to rounding (``tests/test_torch_chem.py``).
"""

from .active_space import active_space_integrals, mo_eri
from .integrals import Molecule, ao_integrals, nuclear_repulsion
from .scf import RHFResult, rhf
from .scf_open import ROHFResult, UHFResult, rohf, uhf

__all__ = [
    "Molecule",
    "RHFResult",
    "ROHFResult",
    "UHFResult",
    "active_space_integrals",
    "ao_integrals",
    "mo_eri",
    "nuclear_repulsion",
    "rhf",
    "rohf",
    "uhf",
]
