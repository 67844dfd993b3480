# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's ``solve_sci`` against ``sqd_tpu.fermion.solve_sci`` on the CPU.

Energy ``<= 1e-8`` Ha, occupancies and ``rdm1`` ``<= 1e-6``.  Also: the
committed headline FCIDUMP read with the port's reader against
``sqd_tpu.chem``'s integrals (``<= 1e-12``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.chem import Molecule, active_space_integrals, rhf
from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import dense_fci

from sqd_tpu_torch import fermion
from sqd_tpu_torch.models.fcidump import read_fcidump
from sqd_tpu_torch.primitives import BitArray

torch.set_num_threads(2)

DATA_STEM = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sqd_tpu_torch", "data", "n2_631g_cas16o_5a5b",
)


def _assert_results_close(out, ref):
    assert abs(out.energy - ref.energy) <= 1e-8
    for o, r in zip(out.orbital_occupancies, ref.orbital_occupancies):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.rdm1, ref.rdm1, rtol=0, atol=1e-6)
    assert out.sci_state.amplitudes.shape == ref.sci_state.amplitudes.shape


@pytest.fixture(scope="module")
def n2_sto3g_full():
    """The ``tests/test_chem.py`` N2/STO-3G CAS(8o,10e) full-space solve."""
    mf = rhf(Molecule([("N", (0, 0, 0)), ("N", (0, 0, 1.09768))], basis="sto-3g"))
    h1, eri, ecore = active_space_integrals(mf, ncas=8, nelecas=10)
    strs = dense_fci.all_hamming_strings(8, 5)
    ref = jax_fermion.solve_sci((strs, strs), h1, eri, 8, (5, 5), tol=1e-10)
    out = fermion.solve_sci((strs, strs), h1, eri, 8, (5, 5), tol=1e-10, device="cpu")
    return out, ref, ecore


def test_n2_sto3g_full_space(n2_sto3g_full):
    out, ref, ecore = n2_sto3g_full
    _assert_results_close(out, ref)
    assert abs(out.energy + ecore - (-107.652521)) < 5e-7  # quickstart.ipynb cell 6
    np.testing.assert_allclose(out.rdm2, ref.rdm2, rtol=0, atol=1e-6)


def test_sci_state_queries(n2_sto3g_full):
    out, ref, _ = n2_sto3g_full
    state, ref_state = out.sci_state, ref.sci_state
    assert state.device == torch.device("cpu")
    assert abs(state.spin_square() - ref_state.spin_square()) < 1e-8
    for o, r in zip(state.orbital_occupancies(), ref_state.orbital_occupancies()):
        np.testing.assert_allclose(o, r, atol=1e-6)
    for o, r in zip(state.rdm(rank=2), ref_state.rdm(rank=2)):
        np.testing.assert_allclose(o, r, atol=1e-6)
    np.testing.assert_allclose(state.rdm(rank=1, spin_summed=True), out.rdm1, atol=1e-12)


def test_hubbard_subspace_f32_with_spin_penalty():
    """The f32 solver path (plain cross-spin version on the CPU) + f64 refine."""
    norb, nelec = 8, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)
    rng = np.random.default_rng(8)
    allstr = dense_fci.all_hamming_strings(norb, 3)
    sa = np.sort(rng.choice(allstr, 40, replace=False))
    sb = np.sort(rng.choice(allstr, 36, replace=False))
    # the bare energy of the penalized state is first order in the residual:
    # refine both solutions in f64 until they meet
    kwargs = dict(spin_sq=0.0, tol=1e-9, refine_iterations=40)
    ref = jax_fermion.solve_sci((sa, sb), h1, eri, norb, nelec, solver_dtype=jnp.float32, **kwargs)
    out = fermion.solve_sci(
        (sa, sb), h1, eri, norb, nelec, solver_dtype=torch.float32, device="cpu", **kwargs
    )
    _assert_results_close(out, ref)


def test_headline_fcidump_matches_chem():
    mf = rhf(Molecule([("N", (0.0, 0.0, 0.0)), ("N", (1.0, 0.0, 0.0))], basis="6-31g"))
    h1, eri, ecore = active_space_integrals(mf, ncas=16, nelecas=10)
    dump = read_fcidump(DATA_STEM + ".fcidump")
    assert dump["norb"] == 16 and dump["nelec"] == (5, 5)
    np.testing.assert_allclose(dump["h1e"], h1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dump["eri"], eri, rtol=0, atol=1e-12)
    assert abs(dump["ecore"] - ecore) <= 1e-12
    with open(DATA_STEM + ".json") as f:
        recorded = json.load(f)
    assert recorded["ecore"] == dump["ecore"]
    assert abs(recorded["energy_total"] - (recorded["energy"] + recorded["ecore"])) < 1e-12
    # below the RHF determinant's energy, which lies in the subspace
    assert recorded["energy_total"] < mf.e_tot


def test_unported_paths_raise():
    strs = np.array([0b111, 0b1011])
    h1, eri = hubbard_integrals(4, u=1.0)
    # ported: at 16 pairs "auto" attaches no factor, and the strategy says so
    with pytest.raises(ValueError, match="dense_df.*requires a PSD ERI factor"):
        fermion.solve_sci((strs, strs), h1, eri, 4, (3, 3), device="cpu",
                          matvec_strategy="dense_df")
    rows = np.ones((4, 8), dtype=bool)
    with pytest.raises(NotImplementedError, match="checkpoint_path"):
        fermion.diagonalize_fermionic_hamiltonian(
            h1, eri, BitArray.from_bool_array(rows), 2, 4, (3, 3), checkpoint_path="loop.npz",
            device="cpu")
    for unported in (fermion.solve_sci_excited, fermion.optimize_orbitals,
                     fermion.rotate_integrals, fermion.apply_excitations,
                     fermion.enlarge_batch_from_transitions, fermion.SCIState.load):
        with pytest.raises(NotImplementedError, match="not ported"):
            unported("anything")
    state = fermion.SCIState(np.zeros((2, 2)), strs, strs, 4, (3, 3), device="cpu")
    with pytest.raises(NotImplementedError, match="SCIState.save"):
        state.save("state.npz")
    with pytest.raises(ValueError, match="hamming weight"):
        fermion.solve_sci((np.array([0b111, 0b1]), strs), h1, eri, 4, (3, 3), device="cpu")
