# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fermi-Hubbard model integrals (analytic fixture / model family).

A copy of ``sqd_tpu.models.hubbard`` (NumPy only).  Provides pyscf-free
molecular-integral-shaped Hamiltonians for tests, benchmarks and demos:
``H = -t sum_<ij>s (c+_is c_js + h.c.) + U sum_i n_iu n_id``.  In chemist-convention integrals: ``h1[i,j] = -t`` on bonds and
``eri[i,i,i,i] = U``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hubbard_integrals", "hubbard_2d_integrals"]


def hubbard_integrals(
    nsites: int, u: float, t: float = 1.0, periodic: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """1-D Hubbard chain/ring integrals (h1e, eri) in chemist convention."""
    h1 = np.zeros((nsites, nsites))
    for i in range(nsites - 1):
        h1[i, i + 1] = h1[i + 1, i] = -t
    if periodic and nsites > 2:
        h1[0, nsites - 1] = h1[nsites - 1, 0] = -t
    eri = np.zeros((nsites,) * 4)
    for i in range(nsites):
        eri[i, i, i, i] = u
    return h1, eri


def hubbard_2d_integrals(
    nx: int, ny: int, u: float, t: float = 1.0, periodic: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """2-D rectangular-lattice Hubbard integrals (row-major site order)."""
    n = nx * ny
    h1 = np.zeros((n, n))

    def sid(x, y):
        return y * nx + x

    for y in range(ny):
        for x in range(nx):
            if x + 1 < nx or periodic and nx > 2:
                j = sid((x + 1) % nx, y)
                h1[sid(x, y), j] = h1[j, sid(x, y)] = -t
            if y + 1 < ny or periodic and ny > 2:
                j = sid(x, (y + 1) % ny)
                h1[sid(x, y), j] = h1[j, sid(x, y)] = -t
    eri = np.zeros((n,) * 4)
    for i in range(n):
        eri[i, i, i, i] = u
    return h1, eri
