# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Restricted Hartree-Fock with DIIS and saddle-escape (NumPy, host-side).

The ``pyscf.scf.RHF(mol).run()`` stand-in for this framework (reference call
sites: the reference's ``docs/guides/quickstart.ipynb`` cell 2,
``integrate_dice_solver.ipynb`` cell 1).  Pinned by the reference's published
N2/6-31G SCF energy -108.835236570774 Ha (``integrate_dice_solver.ipynb``
cell-1 output) in ``tests/test_chem.py``.

RHF can converge to aufbau-consistent *saddle points* ([F, D] = 0 with the
lowest orbitals occupied but unstable to occupied-virtual rotations) — for
N2/STO-3G the core-guess iteration finds one 0.73 Ha above the ground SCF
solution.  After DIIS convergence, :func:`rhf` therefore attempts escapes by
45-degree rotations of frontier occupied/virtual orbital pairs and
re-converging, keeping the lowest solution found (a poor-man's internal
stability analysis; cheap at these matrix sizes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .integrals import Molecule, ao_integrals, nuclear_repulsion

__all__ = ["RHFResult", "rhf"]


@dataclass(frozen=True)
class RHFResult:
    e_tot: float  # total RHF energy (electronic + nuclear repulsion)
    e_nuc: float
    mo_coeff: np.ndarray  # (nao, nmo), columns ordered by mo_energy
    mo_energy: np.ndarray  # (nmo,)
    converged: bool
    hcore: np.ndarray  # (nao, nao) AO-basis T + V
    overlap: np.ndarray  # (nao, nao)
    eri: np.ndarray  # (nao,)*4 chemist (pq|rs)
    mol: Molecule


def _fock(hcore, eri, dm):
    j = np.einsum("pqrs,rs->pq", eri, dm, optimize=True)
    k = np.einsum("prqs,rs->pq", eri, dm, optimize=True)
    return hcore + j - 0.5 * k


def rhf(
    mol: Molecule,
    *,
    conv_tol: float = 1e-11,
    max_cycle: int = 200,
    diis_size: int = 8,
    integrals=None,
) -> RHFResult:
    """Solve closed-shell RHF; raises if the electron count is odd.

    Args:
        integrals: optional precomputed ``(S, T, V, eri)`` from
            :func:`ao_integrals` — the AO build dominates wall-clock for
            d-shell bases (cc-pVDZ N2 ~40 s), so callers that also need the
            raw integrals should compute them once and pass them in.
    """
    nelec = mol.nelectron
    if nelec % 2:
        raise ValueError(f"RHF needs an even electron count, got {nelec}")
    nocc = nelec // 2
    S, T, V, eri = ao_integrals(mol) if integrals is None else integrals
    hcore = T + V
    e_nuc = nuclear_repulsion(mol)
    nao = S.shape[0]

    # symmetric orthogonalization
    s_val, s_vec = np.linalg.eigh(S)
    x = s_vec @ np.diag(s_val**-0.5) @ s_vec.T

    def solve_fock(f):
        fp = x.T @ f @ x
        e, cp = np.linalg.eigh(fp)
        return e, x @ cp

    def energy_elec(dm):
        return 0.5 * np.sum(dm * (hcore + _fock(hcore, eri, dm)))

    def converge(dm):
        """Damped warm-up + DIIS from a starting density.

        Returns ``(e_elec, mo_energy, c, converged)``.
        """
        for _ in range(4 if max_cycle else 0):
            f = _fock(hcore, eri, dm)
            _, c = solve_fock(f)
            dm = 0.6 * (2.0 * c[:, :nocc] @ c[:, :nocc].T) + 0.4 * dm
        errs: list[np.ndarray] = []
        focks: list[np.ndarray] = []
        e_old, ok = 0.0, False
        # max_cycle=0 contract: one Roothaan step of the starting density —
        # callers get well-defined guess orbitals (converged=False) for
        # systems whose RHF will not converge (docs/design/chemistry.md)
        mo_energy, c = solve_fock(_fock(hcore, eri, dm))
        for _ in range(max_cycle):
            f = _fock(hcore, eri, dm)
            # DIIS on the orthogonalized gradient FDS - SDF
            err = x.T @ (f @ dm @ S - S @ dm @ f) @ x
            errs.append(err)
            focks.append(f)
            if len(errs) > diis_size:
                errs.pop(0)
                focks.pop(0)
            if len(errs) > 1:
                n = len(errs)
                b = -np.ones((n + 1, n + 1))
                b[n, n] = 0.0
                for i in range(n):
                    for j in range(n):
                        b[i, j] = np.vdot(errs[i], errs[j])
                rhs = np.zeros(n + 1)
                rhs[n] = -1.0
                try:
                    w = np.linalg.solve(b, rhs)[:n]
                    f = sum(wi * fi for wi, fi in zip(w, focks))
                except np.linalg.LinAlgError:  # pragma: no cover - degenerate DIIS
                    pass
            mo_energy, c = solve_fock(f)
            dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
            e_elec = energy_elec(dm)
            if abs(e_elec - e_old) < conv_tol and np.max(np.abs(errs[-1])) < 1e-7:
                ok = True
                break
            e_old = e_elec
        return energy_elec(dm), mo_energy, c, ok

    _, c0 = solve_fock(hcore)  # core guess
    dm0 = 2.0 * c0[:, :nocc] @ c0[:, :nocc].T
    best = converge(dm0)

    # saddle escape: rotate frontier occupied/virtual pairs and re-converge
    nvirt = nao - nocc
    frontier = [
        (i, a)
        for i in range(max(0, nocc - 3), nocc)
        for a in range(nocc, min(nao, nocc + 3))
    ]
    for _ in range(4):  # allow consecutive descents
        improved = False
        for i, a in frontier:
            if nvirt == 0:
                break
            c = best[2]
            c_mix = c.copy()
            s = np.sqrt(0.5)
            c_mix[:, i] = s * (c[:, i] + c[:, a])
            c_mix[:, a] = s * (c[:, i] - c[:, a])
            dm = 2.0 * c_mix[:, :nocc] @ c_mix[:, :nocc].T
            cand = converge(dm)
            if cand[3] and cand[0] < best[0] - 1e-9:
                best = cand
                improved = True
                break
        if not improved:
            break

    e_elec, mo_energy, c, converged = best
    return RHFResult(
        e_tot=float(e_elec + e_nuc),
        e_nuc=float(e_nuc),
        mo_coeff=c,
        mo_energy=mo_energy,
        converged=converged,
        hcore=hcore,
        overlap=S,
        eri=eri,
        mol=mol,
    )
