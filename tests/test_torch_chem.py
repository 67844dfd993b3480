# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's chemistry (``sqd_tpu_torch.chem`` and the native
``ao_integrals_cart``) against ``sqd_tpu.chem`` on the same molecules.

Tolerances: AO integrals within 1e-12 (the same McMurchie-Davidson code in
C++ and NumPy); energies within 1e-10 Ha and the RHF density within 1e-8
(the same SCF: DIIS, level shifts, convergence tests); the active-space
integrals from the same MO coefficients within 1e-10; the STO-nG fits within
1e-10; the chain geometry -> integrals -> RHF -> CAS -> ``solve_sci`` within
1e-8 Ha of ``sqd_tpu``'s chain.
"""

import numpy as np
import pytest
import torch

from sqd_tpu import chem as jax_chem
from sqd_tpu.chem import sto_ng as jax_sto_ng
from sqd_tpu.fermion import solve_sci as jax_solve_sci

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import chem, native
from sqd_tpu_torch.chem import sto_ng
from sqd_tpu_torch.chem.integrals import Shell
from sqd_tpu_torch.fermion import solve_sci

torch.set_num_threads(2)

H2O = [("O", (0.0, 0.0, 0.1173)), ("H", (0.0, 0.7572, -0.4692)), ("H", (0.0, -0.7572, -0.4692))]
N2 = [("N", (0.0, 0.0, 0.0)), ("N", (1.0, 0.0, 0.0))]
# triplet CH2 (examples/16_open_shell_rohf.py): r(CH) = 1.0775 A, HCH 134 deg
_X, _Z = 1.0775 * np.sin(np.deg2rad(67.0)), 1.0775 * np.cos(np.deg2rad(67.0))
CH2 = [("C", (0.0, 0.0, 0.0)), ("H", (_X, 0.0, _Z)), ("H", (-_X, 0.0, _Z))]
TOL_INT = 1e-12
TOL_E = 1e-10


def _both(atoms, basis):
    return chem.Molecule(atoms, basis=basis), jax_chem.Molecule(atoms, basis=basis)


@pytest.mark.parametrize("basis,backend", [("sto-3g", "native"), ("sto-3g", "numpy"),
                                           ("cc-pvdz", "native")])
def test_ao_integrals_match(basis, backend):
    ours, ref = _both(H2O, basis)
    assert ours.nao == ref.nao == (7 if basis == "sto-3g" else 24)
    got = chem.ao_integrals(ours, backend=backend)
    want = jax_chem.ao_integrals(ref, backend=backend)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_INT)


def test_native_integrals_equal_numpy_path():
    """The port's C++ kernel against the port's own NumPy quartets."""
    mol = chem.Molecule(CH2, basis="sto-3g")
    for a, b in zip(chem.ao_integrals(mol, backend="native"),
                    chem.ao_integrals(mol, backend="numpy")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_INT)


def test_nuclear_repulsion_matches():
    for atoms in (H2O, N2, CH2):
        ours, ref = _both(atoms, "sto-3g")
        assert abs(chem.nuclear_repulsion(ours) - jax_chem.nuclear_repulsion(ref)) < 1e-12


def test_rhf_n2_631g_matches():
    ours, ref = _both(N2, "6-31g")
    mf, mf_ref = chem.rhf(ours), jax_chem.rhf(ref)
    assert mf.converged and mf_ref.converged
    assert abs(mf.e_tot - mf_ref.e_tot) < TOL_E
    assert abs(mf.e_tot - (-108.835236570774)) < 1e-9  # the reference's published RHF energy
    nocc = ours.nelectron // 2
    dm = 2.0 * mf.mo_coeff[:, :nocc] @ mf.mo_coeff[:, :nocc].T
    dm_ref = 2.0 * mf_ref.mo_coeff[:, :nocc] @ mf_ref.mo_coeff[:, :nocc].T
    np.testing.assert_allclose(dm, dm_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mf.mo_energy, mf_ref.mo_energy, rtol=0, atol=1e-9)


def test_rohf_uhf_ch2_match():
    ours, ref = _both(CH2, "sto-3g")
    ints, ints_ref = chem.ao_integrals(ours), jax_chem.ao_integrals(ref)
    ro, ro_ref = chem.rohf(ours, spin=2, integrals=ints), jax_chem.rohf(ref, spin=2,
                                                                         integrals=ints_ref)
    u, u_ref = chem.uhf(ours, spin=2, integrals=ints), jax_chem.uhf(ref, spin=2,
                                                                     integrals=ints_ref)
    assert ro.converged and u.converged
    assert ro.nelec == ro_ref.nelec == (5, 3)
    assert abs(ro.e_tot - ro_ref.e_tot) < TOL_E
    assert abs(u.e_tot - u_ref.e_tot) < TOL_E
    assert abs(u.spin_square - u_ref.spin_square) < 1e-9
    assert u.e_tot <= ro.e_tot + 1e-10 and u.spin_square > 2.0
    np.testing.assert_array_equal(ro.mo_occ, ro_ref.mo_occ)
    # the broken-symmetry start of a closed shell reaches UHF's own fixed point
    bs, bs_ref = (m.uhf(mol, spin=0, break_symmetry=True, max_cycle=60)
                  for m, mol in ((chem, chem.Molecule(N2, basis="sto-3g")),
                                 (jax_chem, jax_chem.Molecule(N2, basis="sto-3g"))))
    assert abs(bs.e_tot - bs_ref.e_tot) < TOL_E


def test_active_space_integrals_from_the_same_orbitals():
    """Both packages' ``active_space_integrals`` fed ``sqd_tpu``'s RHF result."""
    ref = jax_chem.rhf(jax_chem.Molecule(N2, basis="6-31g"))
    ours = chem.RHFResult(
        e_tot=ref.e_tot, e_nuc=ref.e_nuc, mo_coeff=ref.mo_coeff, mo_energy=ref.mo_energy,
        converged=ref.converged, hcore=ref.hcore, overlap=ref.overlap, eri=ref.eri,
        mol=chem.Molecule(N2, basis="6-31g"))
    for ncas, nelecas in ((16, 10), (8, (3, 3)), (18, 14)):
        got = chem.active_space_integrals(ours, ncas, nelecas)
        want = jax_chem.active_space_integrals(ref, ncas, nelecas)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_E)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL_E)
        assert abs(got[2] - want[2]) < TOL_E
    np.testing.assert_allclose(chem.mo_eri(ref.eri, ref.mo_coeff[:, :4]),
                               jax_chem.mo_eri(ref.eri, ref.mo_coeff[:, :4]), rtol=0, atol=TOL_E)


def test_sto_ng_fits_and_slater_zeta_match():
    for ours, ref in ((sto_ng.fit_sto_ng(1, 0), jax_sto_ng.fit_sto_ng(1, 0)),
                      (sto_ng.fit_sto_ng(3, 2), jax_sto_ng.fit_sto_ng(3, 2)),
                      (sto_ng.fit_sto_ng_shared(2), jax_sto_ng.fit_sto_ng_shared(2))):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    shells = [(1, "sp", 2), (2, "sp", 8), (3, "sp", 8), (3, "d", 6), (4, "sp", 2)]
    assert sto_ng.slater_zeta(26, shells) == jax_sto_ng.slater_zeta(26, shells)
    # the published STO-3G hydrogen 1s expansion at zeta = 1.24
    alpha, c = sto_ng.fit_sto_ng(1, 0)
    np.testing.assert_allclose(alpha * 1.24**2, [3.42525091, 0.62391373, 0.16885540], rtol=1e-4)
    np.testing.assert_allclose(c, [0.15432897, 0.53532814, 0.44463454], atol=1e-4)


def test_error_paths():
    """The messages of ``sqd_tpu.chem``'s checks, written for the basis data
    as it is (the STO-3G set has Fe; 6-31G has no second-row element)."""
    with pytest.raises(ValueError, match="Unknown basis"):
        chem.Molecule([("H", (0, 0, 0))], basis="nope")
    with pytest.raises(ValueError, match="No '6-31g' data for element 'S'"):
        chem.Molecule([("S", (0, 0, 0))], basis="6-31g")
    assert chem.Molecule([("Fe", (0, 0, 0))], basis="sto-3g").nao == 18
    with pytest.raises(ValueError, match="even electron count"):
        chem.rhf(chem.Molecule([("H", (0, 0, 0))], basis="sto-3g"))
    with pytest.raises(ValueError, match="Impossible spin"):
        chem.rohf(chem.Molecule([("H", (0, 0, 0)), ("H", (0, 0, 0.74))]), spin=1)
    h2 = chem.Molecule([("H", (0, 0, 0)), ("H", (0, 0, 0.74))], basis="sto-3g")
    mf = chem.rhf(h2)
    with pytest.raises(ValueError, match="exceeds"):
        chem.active_space_integrals(mf, ncas=9, nelecas=2)
    with pytest.raises(ValueError, match="must be even"):
        chem.active_space_integrals(mf, ncas=1, nelecas=1)
    with pytest.raises(ValueError, match="unknown backend"):
        chem.ao_integrals(h2, backend="gpu")
    # an f shell: the native kernel declines (the route to the NumPy quartets)
    f_shell = Shell(3, np.zeros(3), np.array([1.0]), np.array([1.0]))
    assert native.ao_integrals_cart([f_shell], np.ones(1), np.zeros((1, 3))) is None


def test_geometry_to_solve_sci_chain_matches():
    """N2/STO-3G from its geometry through each package's chemistry to
    ``solve_sci`` on a 30 x 30 subspace of CAS(8o,(5,5)e)."""
    ours, ref = _both(N2, "sto-3g")
    h1, eri, ecore = chem.active_space_integrals(chem.rhf(ours), 8, (5, 5))
    h1_r, eri_r, ecore_r = jax_chem.active_space_integrals(jax_chem.rhf(ref), 8, (5, 5))
    strs = np.array(sorted(sum(1 << b for b in bits) for bits in __import__(
        "itertools").combinations(range(8), 5)))
    sub = np.sort(np.random.default_rng(4).choice(strs, 30, replace=False))
    got = solve_sci((sub, sub), h1, eri, 8, (5, 5), device="cpu")
    want = jax_solve_sci((sub, sub), h1_r, eri_r, 8, (5, 5))
    assert abs((got.energy + ecore) - (float(want.energy) + ecore_r)) < 1e-8
    assert got.energy + ecore > -107.652521 - 1e-6  # above the published full-CAS energy
