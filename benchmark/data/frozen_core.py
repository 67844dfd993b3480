"""The frozen-core active space of a configuration's integrals.

With the ``ncore`` lowest orbitals doubly occupied and frozen, the remaining
orbitals see the core through a shifted one-body term and a constant:

    ecore' = ecore + sum_i 2 h_ii + sum_ij [2 (ii|jj) - (ij|ji)]
    h'_pq  = h_pq + sum_i [2 (pq|ii) - (pi|iq)]
    (pq|rs)' = (pq|rs) over the active orbitals

(``i, j`` over the core).  On the molecular orbitals of an FCIDUMP this is
the frozen-core CASCI Hamiltonian that a quantum-chemistry package builds
from the same orbitals.
"""

from __future__ import annotations

import numpy as np


def freeze_core(h1, eri, ecore: float, ncore: int) -> tuple[np.ndarray, np.ndarray, float]:
    """``(h1', eri', ecore')`` of the active orbitals ``ncore..norb-1``."""
    h1, eri = np.asarray(h1, np.float64), np.asarray(eri, np.float64)
    c, a = slice(0, ncore), slice(ncore, h1.shape[0])
    j = np.einsum("pqii->pq", eri[:, :, c, c])
    k = np.einsum("piiq->pq", eri[:, c, c, :])
    e = (float(ecore) + 2.0 * np.trace(h1[c, c])
         + float(np.einsum("iijj->", eri[c, c, c, c]) * 2.0 - np.einsum("ijji->", eri[c, c, c, c])))
    return h1[a, a] + 2.0 * j[a, a] - k[a, a], np.ascontiguousarray(eri[a, a, a, a]), e
