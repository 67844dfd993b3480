"""The plain reference against an exact dense diagonalisation, and the
first iteration's strings against the program's loop."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import generators
from benchmark.reference import iteration_zero, sci


def random_integrals(norb, rng):
    h1 = rng.normal(size=(norb, norb))
    h1 = h1 + h1.T
    eri = rng.normal(size=(norb,) * 4)
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return h1, eri


CASES = [(4, (2, 2), None, None, 0), (5, (2, 3), None, None, 1), (6, (3, 2), 14, 11, 2),
         (6, (3, 3), 12, 15, 3), (7, (3, 2), 20, 9, 4)]


@pytest.mark.parametrize("norb, nelec, ma, mb, seed", CASES)
def test_against_dense_fci(norb, nelec, ma, mb, seed):
    from sqd_tpu_torch.ops import dense_fci

    rng = np.random.default_rng(seed)
    h1, eri = random_integrals(norb, rng)
    fa = dense_fci.all_hamming_strings(norb, nelec[0])
    fb = dense_fci.all_hamming_strings(norb, nelec[1])
    sa = np.sort(rng.choice(fa, ma, replace=False)) if ma else fa
    sb = np.sort(rng.choice(fb, mb, replace=False)) if mb else fb
    h = dense_fci.build_dense_hamiltonian(sa, sb, h1, eri)
    c = rng.normal(size=(len(sa), len(sb)))
    c /= np.linalg.norm(c)
    sub = sci.Subspace(sa, sb, h1, eri, norb, device="cpu", block_bytes=4096)
    np.testing.assert_allclose(sub.apply(torch.tensor(c)).numpy().reshape(-1),
                               h @ c.reshape(-1), atol=1e-12)
    out = sub.evaluate(c)
    dm1, dm2 = dense_fci.dense_rdm12(c.reshape(-1), sa, sb, norb)
    dma, dmb = dense_fci.dense_rdm1s(c.reshape(-1), sa, sb, norb)
    np.testing.assert_allclose(out["rdm1"], dm1, atol=1e-13)
    np.testing.assert_allclose(out["rdm2"], dm2, atol=1e-13)
    np.testing.assert_allclose(out["occ_a"], np.diag(dma), atol=1e-13)
    np.testing.assert_allclose(out["occ_b"], np.diag(dmb), atol=1e-13)
    energy = c.reshape(-1) @ h @ c.reshape(-1)
    assert out["energy"] == pytest.approx(energy, abs=1e-12)
    assert out["energy"] == pytest.approx(
        np.einsum("pq,pq", h1, out["rdm1"]) + 0.5 * np.einsum("pqrs,pqrs", eri, out["rdm2"]),
        abs=1e-12)
    # the ground state of the subspace has no residual
    w, v = np.linalg.eigh(h)
    ground = sub.evaluate(v[:, 0].reshape(len(sa), len(sb)))
    assert ground["energy"] == pytest.approx(w[0], abs=1e-12)
    assert ground["residual"] < 1e-12
    # the reference finds the ground state on its own, from a random start
    assert sub.lowest_eigenvalue(seed + 1000) == pytest.approx(w[0], abs=1e-10)
    # f32 reads the same thing, coarser
    low = sci.Subspace(sa, sb, h1, eri, norb, device="cpu", dtype=torch.float32).evaluate(c)
    assert low["energy"] == pytest.approx(energy, abs=1e-4)


def test_frozen_core_is_the_core_doubly_occupied():
    """Freezing orbital 0 gives the Hamiltonian of the determinants that hold
    it doubly occupied, over the other orbitals."""
    from benchmark.data.frozen_core import freeze_core
    from sqd_tpu_torch.ops import dense_fci

    norb, rng = 6, np.random.default_rng(11)
    h1, eri = random_integrals(norb, rng)
    full = dense_fci.build_dense_hamiltonian(
        *(np.array([s for s in dense_fci.all_hamming_strings(norb, 3) if s & 1]),) * 2, h1, eri)
    h1f, erif, ecore = freeze_core(h1, eri, 0.5, 1)
    small = [s >> 1 for s in dense_fci.all_hamming_strings(norb, 3) if s & 1]
    frozen = dense_fci.build_dense_hamiltonian(np.array(small), np.array(small), h1f, erif)
    np.testing.assert_allclose(frozen + ecore * np.eye(len(frozen)), full + 0.5 * np.eye(
        len(full)), atol=1e-11)


def test_unsorted_strings_refused():
    with pytest.raises(ValueError):
        sci.Subspace(np.array([3, 5, 6])[::-1], np.array([3, 5]), np.zeros((3, 3)),
                     np.zeros((3,) * 4), 3, device="cpu")


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("seed", [7, 2**31 + 1])
def test_iteration_zero_as_the_programs_loop(symmetrize, seed):
    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.primitives import BitArray

    norb, nelec = 10, (3, 3)
    rng = np.random.default_rng(seed)
    h1, eri = random_integrals(norb, rng)
    sa = generators.excitation_strings(40, norb, 3, generators.seed_words(seed, 0))
    sb = generators.excitation_strings(40, norb, 3, generators.seed_words(seed, 1))
    shots = generators.shots(sa, sb, norb, 4000, generators.seed_words(seed, 2))
    settings = {"samples_per_batch": 300, "num_batches": 3, "max_iterations": 1,
                "max_dim": 25, "symmetrize_spin": symmetrize}
    seen = []
    fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, BitArray.from_bool_array(shots), norb=norb, nelec=nelec,
        callback=lambda results: seen.append(results),
        seed=np.random.default_rng(generators.seed_words(seed, 5)), device="cpu", **settings)
    ref = iteration_zero.batch_strings(
        shots, norb, nelec, np.random.default_rng(generators.seed_words(seed, 5)), **settings)
    got = [(r.sci_state.ci_strs_a, r.sci_state.ci_strs_b) for r in seen[0]]
    assert len(got) == len(ref) == 3
    for (ra, rb), (ga, gb) in zip(ref, got):
        np.testing.assert_array_equal(ra, ga)
        np.testing.assert_array_equal(rb, gb)
