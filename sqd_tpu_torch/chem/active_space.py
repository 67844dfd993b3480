# (C) 2026. Licensed under the Apache License, Version 2.0.
"""CASCI-style active-space Hamiltonians from an RHF reference.

The ``pyscf.mcscf.CASCI(...).get_h1eff()/get_h2eff()`` stand-in (reference
call sites: the reference's ``docs/guides/quickstart.ipynb`` cell 2,
``integrate_dice_solver.ipynb`` cell 1): freezes the ``ncore`` lowest RHF
orbitals, folds their mean field into the one-body integrals, and returns the
active-space ``(h1_eff, eri_act, ecore)`` that
:func:`sqd_tpu_torch.fermion.diagonalize_fermionic_hamiltonian` consumes.

Pinned by the reference's published CASCI energies in ``tests/test_chem.py``
(N2/STO-3G CAS(8o,10e) -107.652521 Ha; N2/6-31G CAS(16o,10e)
-109.046671778080 Ha).
"""

from __future__ import annotations

import numpy as np

from .scf import RHFResult

__all__ = ["active_space_integrals", "mo_eri"]


def mo_eri(eri_ao: np.ndarray, mo: np.ndarray) -> np.ndarray:
    """Full 4-index transform, chemist ``(pq|rs)`` in, chemist out."""
    tmp = np.einsum("pqrs,pi->iqrs", eri_ao, mo, optimize=True)
    tmp = np.einsum("iqrs,qj->ijrs", tmp, mo, optimize=True)
    tmp = np.einsum("ijrs,rk->ijks", tmp, mo, optimize=True)
    return np.einsum("ijks,sl->ijkl", tmp, mo, optimize=True)


def active_space_integrals(
    mf: RHFResult, ncas: int, nelecas
) -> tuple[np.ndarray, np.ndarray, float]:
    """``(h1_eff, eri_act, ecore)`` for a CAS of ``ncas`` orbitals.

    The active window is the ``ncas`` RHF orbitals directly above the frozen
    core (core size inferred from the electron counts, exactly like
    ``pyscf.mcscf.CASCI``); ``ecore`` includes the nuclear repulsion and the
    frozen-core mean-field energy, so
    ``E_total = E_CI(h1_eff, eri_act) + ecore``.

    Args:
        mf: converged :class:`sqd_tpu_torch.chem.scf.RHFResult`.
        ncas: number of active spatial orbitals.
        nelecas: active electrons — an int or ``(n_alpha, n_beta)``.
    """
    if isinstance(nelecas, (tuple, list)):
        n_active_elec = int(sum(nelecas))
    else:
        n_active_elec = int(nelecas)
    nelec_total = mf.mol.nelectron
    ncore, rem = divmod(nelec_total - n_active_elec, 2)
    if rem:
        raise ValueError(
            f"Core electron count must be even: total {nelec_total}, active {n_active_elec}"
        )
    nmo = mf.mo_coeff.shape[1]
    if ncore + ncas > nmo:
        raise ValueError(f"CAS({ncas}) + {ncore} core orbitals exceeds {nmo} MOs")

    mo_core = mf.mo_coeff[:, :ncore]
    mo_act = mf.mo_coeff[:, ncore : ncore + ncas]

    h_ao = mf.hcore
    if ncore:
        dm_core = 2.0 * mo_core @ mo_core.T
        j = np.einsum("pqrs,rs->pq", mf.eri, dm_core, optimize=True)
        k = np.einsum("prqs,rs->pq", mf.eri, dm_core, optimize=True)
        veff = j - 0.5 * k
        ecore = mf.e_nuc + np.sum(dm_core * (h_ao + 0.5 * veff))
        h_eff_ao = h_ao + veff
    else:
        ecore = mf.e_nuc
        h_eff_ao = h_ao

    h1_eff = mo_act.T @ h_eff_ao @ mo_act
    eri_act = mo_eri(mf.eri, mo_act)
    return h1_eff, eri_act, float(ecore)
