# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Open-shell SCF: ROHF (Roothaan effective Fock) and UHF, with DIIS.

The ``pyscf.scf.ROHF/UHF`` stand-ins.  The reference delegates open-shell
systems to PySCF upstream (its tests/guides construct CASCI integrals from a
converged mean field before calling ``solve_fermion`` with ``nelec=(na, nb)``,
reference ``fermion.py:505-516``); this framework computes them itself.
ROHF produces the single set of spatial orbitals that
:func:`sqd_tpu_torch.chem.active_space.active_space_integrals` (and CASCI
convention generally) requires for open-shell references — closing the
"closed-shell orbitals only" limitation documented in
``docs/design/chemistry.md``.

Numerical contracts (pinned in ``tests/test_chem_open_shell_scf.py``):

- ``spin=0``: ROHF and UHF both reproduce :func:`sqd_tpu_torch.chem.scf.rhf`
  exactly (same fixed point, energies to ~1e-9 Ha).
- The ROHF total energy equals the single-determinant expectation value of
  the full MO-basis Hamiltonian (verified through ``solve_sci`` on a 1x1
  determinant subspace — an end-to-end pin of the Fock/energy bookkeeping
  against the independent Slater-Condon machinery).
- ``E_UHF <= E_ROHF`` (variational: UHF relaxes the equal-spatial-orbital
  constraint); UHF ``<S^2>`` reports spin contamination.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .integrals import Molecule, ao_integrals, nuclear_repulsion

__all__ = ["ROHFResult", "UHFResult", "rohf", "uhf"]


@dataclass(frozen=True)
class ROHFResult:
    """Field-compatible with :class:`~sqd_tpu_torch.chem.scf.RHFResult` (duck-typed
    by :func:`~sqd_tpu_torch.chem.active_space.active_space_integrals`), plus the
    spin bookkeeping open-shell callers need."""

    e_tot: float
    e_nuc: float
    mo_coeff: np.ndarray  # (nao, nmo) — ONE spatial set (docc | socc | virt)
    mo_energy: np.ndarray  # (nmo,) effective-Fock eigenvalues
    mo_occ: np.ndarray  # (nmo,) occupation numbers in {2, 1, 0}
    nelec: tuple  # (n_alpha, n_beta)
    converged: bool
    hcore: np.ndarray
    overlap: np.ndarray
    eri: np.ndarray
    mol: Molecule


@dataclass(frozen=True)
class UHFResult:
    e_tot: float
    e_nuc: float
    mo_coeff: np.ndarray  # (2, nao, nmo) — [alpha, beta] orbital sets
    mo_energy: np.ndarray  # (2, nmo)
    nelec: tuple  # (n_alpha, n_beta)
    spin_square: float  # <S^2> of the UHF determinant (contamination included)
    converged: bool
    hcore: np.ndarray
    overlap: np.ndarray
    eri: np.ndarray
    mol: Molecule


def _nalpha_nbeta(mol: Molecule, spin) -> tuple[int, int]:
    nelec = mol.nelectron
    if spin is None:
        spin = nelec % 2
    if (nelec + spin) % 2 or spin < 0 or spin > nelec:
        raise ValueError(f"Impossible spin={spin} for {nelec} electrons")
    return (nelec + spin) // 2, (nelec - spin) // 2


def _jk(eri, dm):
    j = np.einsum("pqrs,rs->pq", eri, dm, optimize=True)
    k = np.einsum("prqs,rs->pq", eri, dm, optimize=True)
    return j, k


class _Diis:
    """Pulay DIIS over an arbitrary stack of Fock-like matrices."""

    def __init__(self, size: int):
        self.size, self.errs, self.mats = size, [], []

    def extrapolate(self, mats, err):
        self.errs.append(err)
        self.mats.append(mats)
        if len(self.errs) > self.size:
            self.errs.pop(0)
            self.mats.pop(0)
        n = len(self.errs)
        if n < 2:
            return mats
        b = -np.ones((n + 1, n + 1))
        b[n, n] = 0.0
        for i in range(n):
            for j in range(n):
                b[i, j] = np.vdot(self.errs[i], self.errs[j])
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        try:
            w = np.linalg.solve(b, rhs)[:n]
        except np.linalg.LinAlgError:  # pragma: no cover - degenerate DIIS
            return mats
        return tuple(
            sum(w[i] * self.mats[i][m] for i in range(n)) for m in range(len(mats))
        )


def rohf(
    mol: Molecule,
    *,
    spin: int | None = None,
    conv_tol: float = 1e-11,
    max_cycle: int = 200,
    diis_size: int = 8,
    integrals=None,
) -> ROHFResult:
    """Restricted open-shell HF via the Roothaan single effective Fock.

    Guest-Saunders coupling: in the current MO basis the effective Fock is
    ``(Fa+Fb)/2`` on the diagonal (closed/open/virtual) blocks, ``Fb`` on the
    closed-open coupling block and ``Fa`` on the open-virtual block — the
    choice whose stationary point is the variational ROHF energy for any
    (na, nb).  DIIS extrapolates (Fa, Fb) jointly against the exact
    orthonormalized SCF gradient ``sum_s X^T (F_s D_s S - S D_s F_s) X``.

    Args:
        spin: ``n_alpha - n_beta`` (2S). Defaults to ``nelectron % 2``.
        integrals: optional precomputed ``(S, T, V, eri)`` from
            :func:`~sqd_tpu_torch.chem.integrals.ao_integrals`.
    """
    na, nb = _nalpha_nbeta(mol, spin)
    S, T, V, eri = ao_integrals(mol) if integrals is None else integrals
    hcore = T + V
    e_nuc = nuclear_repulsion(mol)
    nao = S.shape[0]
    ndocc, nsocc = nb, na - nb

    s_val, s_vec = np.linalg.eigh(S)
    x = s_vec @ np.diag(s_val**-0.5) @ s_vec.T

    def solve_in_mo(c, fa, fb):
        """Diagonalize the Guest-Saunders effective Fock in the basis of the
        current orbitals ``c``; returns rotated orbitals + eigenvalues."""
        fa_mo = c.T @ fa @ c
        fb_mo = c.T @ fb @ c
        feff = 0.5 * (fa_mo + fb_mo)
        d, o = slice(0, ndocc), slice(ndocc, na)
        v = slice(na, nao)
        feff[d, o] = fb_mo[d, o]
        feff[o, d] = fb_mo[o, d]
        feff[o, v] = fa_mo[o, v]
        feff[v, o] = fa_mo[v, o]
        eps, u = np.linalg.eigh(feff)
        return eps, c @ u

    def fock_pair(da, db):
        ja, ka = _jk(eri, da)
        jb, kb = _jk(eri, db)
        fa = hcore + ja + jb - ka
        fb = hcore + ja + jb - kb
        return fa, fb

    def energy(da, db, fa, fb):
        return 0.5 * float(
            np.sum((da + db) * hcore) + np.sum(da * fa) + np.sum(db * fb)
        )

    # core guess
    e0, c0 = np.linalg.eigh(x.T @ hcore @ x)
    c = x @ c0
    mo_energy = e0
    diis = _Diis(diis_size)
    e_old, converged = 0.0, False
    da = c[:, :na] @ c[:, :na].T
    db = c[:, :nb] @ c[:, :nb].T
    for cycle in range(max_cycle):
        fa, fb = fock_pair(da, db)
        e_elec = energy(da, db, fa, fb)
        grad = x.T @ ((fa @ da @ S - S @ da @ fa) + (fb @ db @ S - S @ db @ fb)) @ x
        gmax = float(np.max(np.abs(grad)))
        if abs(e_elec - e_old) < conv_tol and gmax < 1e-7 and cycle > 1:
            converged = True
            break
        e_old = e_elec
        if cycle >= 2:  # short damped warm-up before DIIS engages
            fa, fb = diis.extrapolate((fa, fb), grad)
        mo_energy, c_new = solve_in_mo(c, fa, fb)
        order = np.argsort(mo_energy, kind="stable")
        mo_energy, c = mo_energy[order], c_new[:, order]
        da_new = c[:, :na] @ c[:, :na].T
        db_new = c[:, :nb] @ c[:, :nb].T
        if cycle < 2:
            da = 0.6 * da_new + 0.4 * da
            db = 0.6 * db_new + 0.4 * db
        else:
            da, db = da_new, db_new
    fa, fb = fock_pair(da, db)
    e_elec = energy(da, db, fa, fb)
    occ = np.zeros(nao)
    occ[:ndocc] = 2.0
    occ[ndocc:na] = 1.0
    return ROHFResult(
        e_tot=float(e_elec + e_nuc),
        e_nuc=float(e_nuc),
        mo_coeff=c,
        mo_energy=mo_energy,
        mo_occ=occ,
        nelec=(na, nb),
        converged=converged,
        hcore=hcore,
        overlap=S,
        eri=eri,
        mol=mol,
    )


def uhf(
    mol: Molecule,
    *,
    spin: int | None = None,
    conv_tol: float = 1e-11,
    max_cycle: int = 200,
    diis_size: int = 8,
    integrals=None,
    break_symmetry: bool = False,
) -> UHFResult:
    """Unrestricted HF: independent alpha/beta orbital sets, joint DIIS.

    Args:
        spin: ``n_alpha - n_beta`` (2S). Defaults to ``nelectron % 2``.
        break_symmetry: mix the alpha HOMO/LUMO of the core guess — lets
            spin=0 systems reach broken-symmetry UHF solutions (e.g.
            stretched bonds) instead of the RHF fixed point.
        integrals: optional precomputed ``(S, T, V, eri)``.
    """
    na, nb = _nalpha_nbeta(mol, spin)
    S, T, V, eri = ao_integrals(mol) if integrals is None else integrals
    hcore = T + V
    e_nuc = nuclear_repulsion(mol)

    s_val, s_vec = np.linalg.eigh(S)
    x = s_vec @ np.diag(s_val**-0.5) @ s_vec.T

    def solve(f):
        e, cp = np.linalg.eigh(x.T @ f @ x)
        return e, x @ cp

    e0, c = solve(hcore)
    ca, cb = c.copy(), c.copy()
    if break_symmetry and na < c.shape[1]:
        s2 = np.sqrt(0.5)
        h, l = na - 1, na
        ca[:, h], ca[:, l] = s2 * (c[:, h] + c[:, l]), s2 * (c[:, h] - c[:, l])
    ea = eb = e0
    diis = _Diis(diis_size)
    e_old, converged = 0.0, False
    da = ca[:, :na] @ ca[:, :na].T
    db = cb[:, :nb] @ cb[:, :nb].T
    for cycle in range(max_cycle):
        ja, ka = _jk(eri, da)
        jb, kb = _jk(eri, db)
        fa = hcore + ja + jb - ka
        fb = hcore + ja + jb - kb
        e_elec = 0.5 * float(
            np.sum((da + db) * hcore) + np.sum(da * fa) + np.sum(db * fb)
        )
        grad = x.T @ ((fa @ da @ S - S @ da @ fa) + (fb @ db @ S - S @ db @ fb)) @ x
        gmax = float(np.max(np.abs(grad)))
        if abs(e_elec - e_old) < conv_tol and gmax < 1e-7 and cycle > 1:
            converged = True
            break
        e_old = e_elec
        if cycle >= 2:
            fa, fb = diis.extrapolate((fa, fb), grad)
        ea, ca = solve(fa)
        eb, cb = solve(fb)
        da_new = ca[:, :na] @ ca[:, :na].T
        db_new = cb[:, :nb] @ cb[:, :nb].T
        if cycle < 2:
            da = 0.6 * da_new + 0.4 * da
            db = 0.6 * db_new + 0.4 * db
        else:
            da, db = da_new, db_new

    ja, ka = _jk(eri, da)
    jb, kb = _jk(eri, db)
    fa = hcore + ja + jb - ka
    fb = hcore + ja + jb - kb
    e_elec = 0.5 * float(np.sum((da + db) * hcore) + np.sum(da * fa) + np.sum(db * fb))
    # <S^2> = Sz(Sz+1) + nb - ||Ca_occ^T S Cb_occ||_F^2
    sz = 0.5 * (na - nb)
    ov = ca[:, :na].T @ S @ cb[:, :nb]
    s_sq = sz * (sz + 1.0) + nb - float(np.sum(ov * ov))
    return UHFResult(
        e_tot=float(e_elec + e_nuc),
        e_nuc=float(e_nuc),
        mo_coeff=np.stack([ca, cb]),
        mo_energy=np.stack([ea, eb]),
        nelec=(na, nb),
        spin_square=s_sq,
        converged=converged,
        hcore=hcore,
        overlap=S,
        eri=eri,
        mol=mol,
    )
