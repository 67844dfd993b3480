# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's ``solve_sci_excited`` against ``sqd_tpu``'s and the dense
spectrum on the CPU.

Both packages run the f64 block Davidson to a residual of 1e-7 from the same
start block, so energies agree within 1e-9 Ha (second order in the residual)
and occupancies, ``rdm1`` and each state's overlap within 1e-6 (first order
over a gap of order 0.1 Ha); the dense spectrum within 1e-8 Ha.
"""

import numpy as np
import pytest
import torch

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.ops import dense_fci

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion

torch.set_num_threads(2)

NORB, NELEC = 6, (3, 3)


def _random_integrals(norb, seed):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    eri = rng.normal(size=(norb,) * 4) * 0.3
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return h1, eri / 8


@pytest.fixture(scope="module")
def problem():
    h1, eri = _random_integrals(NORB, 11)
    all_strs = dense_fci.all_hamming_strings(NORB, 3)
    rng = np.random.default_rng(12)
    truncated = (np.sort(rng.choice(all_strs, 14, replace=False)),
                 np.sort(rng.choice(all_strs, 17, replace=False)))
    return h1, eri, all_strs, truncated


def _assert_states_match(out, ref):
    assert [r.energy for r in out] == sorted(r.energy for r in out)
    for o, r in zip(out, ref):
        assert abs(o.energy - r.energy) <= 1e-9
        for x, y in zip(o.orbital_occupancies, r.orbital_occupancies):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(o.rdm1, r.rdm1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(o.rdm2, r.rdm2, rtol=0, atol=1e-6)
        overlap = np.vdot(o.sci_state.amplitudes, r.sci_state.amplitudes)
        assert abs(abs(overlap) - 1.0) <= 1e-6
    vecs = np.stack([o.sci_state.amplitudes.ravel() for o in out])
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(len(out)), rtol=0, atol=1e-8)


@pytest.mark.parametrize("k,spin_sq", [(1, None), (3, None), (1, 0.0), (3, 0.0)])
def test_truncated_subspace_matches_sqd_tpu(problem, k, spin_sq):
    h1, eri, _, strs = problem
    ref = jax_fermion.solve_sci_excited(strs, h1, eri, NORB, NELEC, k=k, spin_sq=spin_sq)
    out = fermion.solve_sci_excited(strs, h1, eri, NORB, NELEC, k=k, spin_sq=spin_sq,
                                    device="cpu")
    assert len(out) == k
    _assert_states_match(out, ref)
    for o in out:
        assert o.sci_state.amplitudes.shape == (14, 17)
        assert o.sci_state.device == torch.device("cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_full_space_matches_dense_spectrum(k):
    h1, eri = _random_integrals(NORB, 13)
    all_strs = dense_fci.all_hamming_strings(NORB, 3)
    dense = np.linalg.eigvalsh(dense_fci.build_dense_hamiltonian(all_strs, all_strs, h1, eri))
    out = fermion.solve_sci_excited((all_strs, all_strs), h1, eri, NORB, NELEC, k=k,
                                    device="cpu")
    np.testing.assert_allclose([o.energy for o in out], dense[:k], rtol=0, atol=1e-8)
    ground = fermion.solve_sci((all_strs, all_strs), h1, eri, NORB, NELEC, tol=1e-9,
                               device="cpu")
    assert abs(out[0].energy - ground.energy) <= 1e-9


def test_both_packages_miss_the_same_odd_level(problem):
    """With equal alpha and beta strings, H commutes with the spin flip; at
    this seed the third level is odd under the flip, and the start block's
    Krylov space never reaches it in either package, which both return the
    fourth level in its place (ROADMAP §C3: the port keeps sqd_tpu's start
    block, so it computes what sqd_tpu computes)."""
    h1, eri, all_strs, _ = problem
    dense = np.linalg.eigvalsh(dense_fci.build_dense_hamiltonian(all_strs, all_strs, h1, eri))
    ref = jax_fermion.solve_sci_excited((all_strs, all_strs), h1, eri, NORB, NELEC, k=3)
    out = fermion.solve_sci_excited((all_strs, all_strs), h1, eri, NORB, NELEC, k=3,
                                    device="cpu")
    _assert_states_match(out, ref)
    np.testing.assert_allclose([o.energy for o in out], dense[[0, 1, 3]], rtol=0, atol=1e-8)


def test_f32_solver_dtype(problem):
    """``solver_dtype=float32`` (tolerance floored at the f32 scale) still
    returns f64 energies of the same states within the f32 residual's square."""
    h1, eri, _, strs = problem
    ref = fermion.solve_sci_excited(strs, h1, eri, NORB, NELEC, k=2, device="cpu")
    out = fermion.solve_sci_excited(strs, h1, eri, NORB, NELEC, k=2, device="cpu",
                                    solver_dtype=torch.float32)
    for o, r in zip(out, ref):
        assert o.rdm1.dtype == np.float64
        assert abs(o.energy - r.energy) <= 1e-6
