# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's configuration recovery against ``sqd_tpu.configuration_recovery``.

With the Gumbel noise of ``jax.random`` injected on the same key (the port's
one noise source, ``_gumbel_noise``, replaced), the port repairs every row
exactly as ``sqd_tpu`` does.  With its own ``torch`` noise it is held to the
law: Hamming weights restored, flip frequencies proportional to the flip
probabilities, seed-reproducible output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sqd_tpu import configuration_recovery as jax_cr
from sqd_tpu.ops import sampling as jax_sampling

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import configuration_recovery as cr
from sqd_tpu_torch.ops import sampling


def jax_gumbel_noise(seed, shape, device):
    """``sqd_tpu``'s noise: the key of ``seed`` split into the left and right halves'."""
    key_l, key_r = jax.random.split(jax.random.key(seed))
    return tuple(
        torch.as_tensor(np.array(jax.random.gumbel(k, shape, dtype=jnp.float64)), device=device)
        for k in (key_l, key_r)
    )


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(cr, "_gumbel_noise", jax_gumbel_noise)


def _problem(seed, norb, rows=300):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 2, size=(rows, 2 * norb)).astype(bool)
    probs = rng.random(rows)
    occ = (rng.random(norb), rng.random(norb))
    return mat, probs / probs.sum(), occ


CASES = [(0, 8, 3, 2), (1, 10, 4, 4), (2, 16, 5, 5), (3, 40, 10, 12)]  # (seed, norb, n_a, n_b)


@pytest.mark.parametrize("seed,norb,n_a,n_b", CASES)
def test_injected_noise_matches_bit_for_bit(jax_noise, seed, norb, n_a, n_b):
    mat, probs, occ = _problem(seed, norb)
    rng_seed = 100 + seed
    ref = jax_cr.recover_configurations(mat, probs, occ, n_a, n_b, rand_seed=rng_seed)
    ours = cr.recover_configurations(mat, probs, occ, n_a, n_b, rand_seed=rng_seed, device="cpu")
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("seed,norb,n_a,n_b", CASES)
def test_kernel_matches_bit_for_bit(seed, norb, n_a, n_b):
    """The repaired matrix before dedup, against ``sqd_tpu._recover_kernel``."""
    mat, _, occ = _problem(seed, norb)
    occs = np.concatenate((occ[1][::-1], occ[0][::-1]))
    ref = jax_cr._recover_kernel(jnp.asarray(mat), jnp.asarray(occs), jax.random.key(seed),
                                 hamming_left=n_b, hamming_right=n_a)
    noise_l, noise_r = jax_gumbel_noise(seed, (mat.shape[0], norb), "cpu")
    ours = cr._recover_kernel(torch.as_tensor(mat), torch.as_tensor(occs), noise_l, noise_r,
                              hamming_left=n_b, hamming_right=n_a)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not np.array_equal(ours.numpy(), mat)  # rows were repaired


def test_sampling_ops_match():
    """``rank_by_gumbel`` and ``gumbel_topk_indices`` on ``sqd_tpu``'s noise,
    with ``-inf`` weights and ties."""
    rng = np.random.default_rng(3)
    logw = np.log(rng.random((50, 16)))
    logw[:, ::5] = -np.inf
    logw[:, 1] = logw[:, 2]
    key = jax.random.key(8)
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, logw.shape, dtype=jnp.float64)))
    ranks, scores = sampling.rank_by_gumbel(torch.as_tensor(logw), noise)
    ref_ranks, ref_scores = jax_sampling.rank_by_gumbel(key, jnp.asarray(logw))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(ref_ranks))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    idx = sampling.gumbel_topk_indices(torch.as_tensor(logw), 5, noise)
    ref_idx = jax_sampling.gumbel_topk_indices(key, jnp.asarray(logw), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("seed,norb,n_a,n_b", CASES)
def test_own_noise_restores_hamming_weights(seed, norb, n_a, n_b):
    mat, probs, occ = _problem(seed, norb)
    out, new_probs = cr.recover_configurations(mat, probs, occ, n_a, n_b, rand_seed=seed,
                                               device="cpu")
    assert np.isclose(new_probs.sum(), 1.0) and len(out) == len(new_probs)
    np.testing.assert_array_equal(out[:, norb:].sum(axis=1), n_a)
    np.testing.assert_array_equal(out[:, :norb].sum(axis=1), n_b)
    assert len(np.unique(out, axis=0)) == len(out)


def test_own_noise_seed_reproducible():
    mat, probs, occ = _problem(4, 10)
    o1, p1 = cr.recover_configurations(mat, probs, occ, 4, 4, rand_seed=123, device="cpu")
    o2, p2 = cr.recover_configurations(mat, probs, occ, 4, 4, rand_seed=123, device="cpu")
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(p1, p2)
    o3, _ = cr.recover_configurations(mat, probs, occ, 4, 4, rand_seed=124, device="cpu")
    assert o1.shape != o3.shape or not np.array_equal(o1, o3)


def test_own_noise_flip_law():
    """One over-weight bit removed: flip frequency proportional to p_1_to_0
    (as ``tests/test_configuration_recovery.py``; 20,000 replicas, atol 0.03)."""
    norb, n_trials = 3, 20000
    mat = np.tile(np.array([[1, 1, 1, 0, 1, 0]], dtype=bool), (n_trials, 1))
    probs = np.ones(n_trials) / n_trials
    occ_b = np.array([0.9, 0.5, 0.1])  # column i holds orbital norb-1-i
    occ_a = np.array([0.5, 0.9, 0.5])
    out, freqs = cr.recover_configurations(mat, probs, (occ_a, occ_b), 1, 2, rand_seed=0,
                                           device="cpu")
    np.testing.assert_array_equal(out[:, :norb].sum(axis=1), 2)
    counts = np.zeros(norb)
    for row, f in zip(out, freqs):
        counts[int(np.flatnonzero(~row[:norb])[0])] += f * n_trials

    def p10(ratio, occ, eps=0.01):
        r, o = 1 - ratio, 1 - occ
        if o < r:
            return o * eps / r
        if r == 1.0:
            return eps
        slope = (1 - eps) / (1 - r)
        return o * slope + (1 - slope)

    expected = np.array([p10(2 / 3, occ_b[norb - 1 - i]) for i in range(norb)])
    np.testing.assert_allclose(counts / n_trials, expected / expected.sum(), atol=0.03)


@pytest.mark.parametrize(
    "occ,target,expect",
    [
        (1.0, 4, np.ones((1, 8), dtype=bool)),  # every zero flips to one
        (0.0, 2, np.zeros((1, 8), dtype=bool)),  # all flip probabilities zero: unchanged
    ],
)
def test_edge_cases(occ, target, expect):
    mat = np.zeros((3, 8), dtype=bool)
    occs = (np.full(4, occ), np.full(4, occ))
    out, p = cr.recover_configurations(mat, np.ones(3) / 3, occs, target, target, rand_seed=0,
                                       device="cpu")
    np.testing.assert_array_equal(out, expect)
    np.testing.assert_allclose(p, [1.0])


def test_errors_and_deprecated_occupancies(jax_noise):
    mat = np.zeros((1, 4), dtype=bool)
    with pytest.raises(ValueError) as ref:
        jax_cr.recover_configurations(mat, [1.0], (np.zeros(2), np.zeros(2)), -1, 1)
    with pytest.raises(ValueError) as ours:
        cr.recover_configurations(mat, [1.0], (np.zeros(2), np.zeros(2)), -1, 1, device="cpu")
    assert str(ours.value) == str(ref.value)
    mat, probs, occ = _problem(5, 6)
    flat = np.concatenate((occ[1][::-1], occ[0][::-1]))  # the 1D column-order layout
    with pytest.warns(DeprecationWarning, match="1D array is deprecated"):
        ours = cr.recover_configurations(mat, probs, flat, 3, 3, rand_seed=2, device="cpu")
    with pytest.warns(DeprecationWarning):
        ref = jax_cr.recover_configurations(mat, probs, flat, 3, 3, rand_seed=2)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
