# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's orbital rotation and orbital optimization against ``sqd_tpu``'s
on the CPU.

``rotate_integrals`` within 1e-12 of ``sqd_tpu``'s (both in f64: a matrix
exponential and four index rotations); SGD steps on fixed RDMs within 1e-10
(the port's Taylor ``expm`` and ``sqd_tpu``'s Pade one agree to ~1e-15, and
300 steps of rate 0.01 and momentum 0.9 carry that to ~1e-13);
``optimize_orbitals`` within 1e-8 Ha of ``sqd_tpu``'s with f64 solves.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import dense_fci

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion

torch.set_num_threads(2)


def _random_integrals(norb, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    eri = rng.normal(size=(norb,) * 4) * scale
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return h1, eri / 8


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("norb,scale", [(4, 0.0), (5, 0.2), (7, 0.5)])
def test_rotate_integrals_matches_sqd_tpu(norb, scale):
    h1, eri = _random_integrals(norb, seed=norb)
    k_flat = np.random.default_rng(norb).normal(size=(norb * (norb - 1)) // 2) * scale
    ref = jax_fermion.rotate_integrals(h1, eri, k_flat)
    out = fermion.rotate_integrals(h1, eri, k_flat, device="cpu")
    for o, r in zip(out, ref):
        assert o.dtype == np.float64
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)
    if scale == 0.0:  # the identity rotation
        np.testing.assert_allclose(out[0], h1, rtol=0, atol=1e-12)
        np.testing.assert_allclose(out[1], eri, rtol=0, atol=1e-12)


def test_rotate_integrals_orthogonality_and_spectrum():
    """U = expm(K) is orthogonal: the one-body spectrum and the FCI spectrum stay."""
    norb = 4
    h1, eri = _random_integrals(norb, seed=3)
    k_flat = np.random.default_rng(1).normal(size=6) * 0.3
    h_rot, eri_rot = fermion.rotate_integrals(h1, eri, k_flat, device="cpu")
    np.testing.assert_allclose(np.linalg.eigvalsh(h_rot), np.linalg.eigvalsh(h1), atol=1e-10)
    strs = dense_fci.all_hamming_strings(norb, 2)
    before = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    after = dense_fci.build_dense_hamiltonian(strs, strs, h_rot, eri_rot)
    np.testing.assert_allclose(np.linalg.eigvalsh(before), np.linalg.eigvalsh(after), atol=1e-9)
    u = torch.linalg.matrix_exp(fermion._antisymmetric_matrix_from_upper_tri(_t(k_flat), norb))
    np.testing.assert_allclose((u.T @ u).numpy(), np.eye(norb), rtol=0, atol=1e-14)


def test_wrong_k_flat_length_raises():
    h1, eri = _random_integrals(4)
    with pytest.raises(ValueError, match="upper triangle"):
        fermion.rotate_integrals(h1, eri, np.zeros(5), device="cpu")
    with pytest.raises(ValueError, match="k_flat"):
        fermion.optimize_orbitals((np.array([3]), np.array([3])), h1, eri, np.zeros(2),
                                  device="cpu")


def test_antisymmetric_matrix_matches_sqd_tpu():
    k_flat = np.arange(1.0, 11.0)
    ref = np.asarray(jax_fermion._antisymmetric_matrix_from_upper_tri(jnp.asarray(k_flat), 5))
    out = fermion._antisymmetric_matrix_from_upper_tri(_t(k_flat), 5)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("scale", [0.05, 0.3, 40.0])
def test_taylor_expm_matches_matrix_exp(scale):
    """The capturable exponential against ``torch.linalg.matrix_exp``, with
    generators whose 1-norms need 0 squarings, a few, and more than the
    ``EXPM_SQUARINGS`` a step holds (the clamp is reported)."""
    a = fermion._antisymmetric_matrix_from_upper_tri(
        _t(np.random.default_rng(7).normal(size=28) * scale), 8)
    ref = torch.linalg.matrix_exp(a)
    s_need = int(np.ceil(np.log2(float(torch.linalg.matrix_norm(a, ord=1)))))
    out, s = fermion._expm(a, max(s_need, fermion.EXPM_SQUARINGS))
    assert int(s) == max(s_need, 0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-13 * max(1, 2**s_need))
    if s_need > fermion.EXPM_SQUARINGS:
        _, s_clamped = fermion._expm(a, fermion.EXPM_SQUARINGS)
        assert int(s_clamped) == s_need  # the unclamped count comes back


def _fixed_rdms(norb, seed):
    rng = np.random.default_rng(seed)
    dm1 = rng.normal(size=(norb, norb))
    dm2 = rng.normal(size=(norb,) * 4) * 0.1
    return dm1 + dm1.T, dm2 + dm2.transpose(2, 3, 0, 1)


def test_rotated_energy_matches_sqd_tpu():
    norb = 6
    h1, eri = _random_integrals(norb, seed=2)
    dm1, dm2 = _fixed_rdms(norb, 3)
    k_flat = np.random.default_rng(4).normal(size=15) * 0.3
    args = (dm1, dm2, h1, eri, k_flat)
    ref = float(jax_fermion._rotated_energy(*(jnp.asarray(x) for x in args)))
    out = float(fermion._rotated_energy(*(_t(x) for x in args))[0])
    assert abs(out - ref) <= 1e-12 * max(1.0, abs(ref))


@pytest.mark.parametrize("scale,rate", [(0.3, 0.01), (30.0, 0.001)])
def test_sgd_steps_match_sqd_tpu(scale, rate):
    """300 SGD steps on fixed RDMs; at scale 30 the generator needs more
    squarings than a step holds, so the steps run again with more."""
    norb = 6
    h1, eri = _random_integrals(norb, seed=5)
    dm1, dm2 = _fixed_rdms(norb, 6)
    k_flat = np.random.default_rng(8).normal(size=15) * scale
    args = (dm1, dm2, h1, eri, k_flat)
    ref = np.asarray(jax_fermion._sgd_momentum_orbital_step(
        *(jnp.asarray(x) for x in args), rate, 0.9, 300))
    out = fermion._sgd_momentum_orbital_step(*(_t(x) for x in args), rate, 0.9, 300)
    assert np.abs(ref - k_flat).max() > 1e-3  # the steps moved k
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-10)


def _hubbard_oo_problem():
    """``tests/test_orbital_optimization.py``'s truncated-subspace setting on
    a 6-site Hubbard ring in a randomly rotated basis: 6 of the 15
    two-electron strings per spin."""
    norb = 6
    h1, eri = hubbard_integrals(norb, u=4.0)
    k_rand = np.random.default_rng(3).normal(size=15) * 0.2
    h1, eri = jax_fermion.rotate_integrals(h1, eri, k_rand)
    all_strs = dense_fci.all_hamming_strings(norb, 2)
    sel = np.sort(np.random.default_rng(5).choice(all_strs, 6, replace=False))
    return h1, eri, (sel, sel)


def test_optimize_orbitals_matches_sqd_tpu():
    h1, eri, strs = _hubbard_oo_problem()
    settings = dict(num_iters=4, num_steps_grad=300, learning_rate=0.05)
    e_ref, k_ref, occ_ref = jax_fermion.optimize_orbitals(
        strs, h1, eri, np.zeros(15), solver_dtype=jnp.float64, **settings)
    e_out, k_out, occ_out = fermion.optimize_orbitals(
        strs, h1, eri, np.zeros(15), solver_dtype=torch.float64, device="cpu", **settings)
    e0 = fermion.solve_sci(strs, h1, eri, 6, (2, 2), spin_sq=0.0, device="cpu").energy
    assert e_out < e0 - 1e-4  # the rotation lowered the truncated-subspace energy
    assert abs(e_out - e_ref) <= 1e-8
    assert k_out.shape == (15,) and k_out.dtype == np.float64
    np.testing.assert_allclose(k_out, np.asarray(k_ref), rtol=0, atol=1e-6)
    for o, r in zip(occ_out, occ_ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
