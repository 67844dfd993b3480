# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Heisenberg spin models as sparse Pauli operators (qubit-path model family).

A copy of ``sqd_tpu.models.heisenberg``: the system of the reference's
qubit-path guide (``docs/guides/project_pauli_operators_onto_hilbert_subspaces.ipynb``:
an L-site Heisenberg ring with XX+YY+ZZ couplings and local fields).
"""

from __future__ import annotations

from ..primitives import SparsePauliOp

__all__ = ["heisenberg_ring", "transverse_field_ising"]


def _two_site_label(n: int, i: int, j: int, pauli: str) -> str:
    chars = ["I"] * n
    chars[n - 1 - i] = pauli
    chars[n - 1 - j] = pauli
    return "".join(chars)


def heisenberg_ring(
    num_sites: int,
    j_xx: float = 1.0,
    j_yy: float = 1.0,
    j_zz: float = 1.0,
    h_z: float = 0.0,
    periodic: bool = True,
) -> SparsePauliOp:
    """``H = sum_<ij> (Jx XX + Jy YY + Jz ZZ) + hz sum_i Z_i`` on a ring."""
    terms = []
    bonds = [(i, i + 1) for i in range(num_sites - 1)]
    if periodic and num_sites > 2:
        bonds.append((num_sites - 1, 0))
    for i, j in bonds:
        if j_xx:
            terms.append((_two_site_label(num_sites, i, j, "X"), j_xx))
        if j_yy:
            terms.append((_two_site_label(num_sites, i, j, "Y"), j_yy))
        if j_zz:
            terms.append((_two_site_label(num_sites, i, j, "Z"), j_zz))
    if h_z:
        for i in range(num_sites):
            chars = ["I"] * num_sites
            chars[num_sites - 1 - i] = "Z"
            terms.append(("".join(chars), h_z))
    return SparsePauliOp.from_list(terms)


def transverse_field_ising(
    num_sites: int, j_zz: float = 1.0, h_x: float = 1.0, periodic: bool = False
) -> SparsePauliOp:
    """``H = -J sum ZZ - hx sum X`` (a second qubit model family)."""
    terms = []
    bonds = [(i, i + 1) for i in range(num_sites - 1)]
    if periodic and num_sites > 2:
        bonds.append((num_sites - 1, 0))
    for i, j in bonds:
        terms.append((_two_site_label(num_sites, i, j, "Z"), -j_zz))
    for i in range(num_sites):
        chars = ["I"] * num_sites
        chars[num_sites - 1 - i] = "X"
        terms.append(("".join(chars), -h_x))
    return SparsePauliOp.from_list(terms)
