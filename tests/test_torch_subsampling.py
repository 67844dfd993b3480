# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's postselection and subsampling against ``sqd_tpu.subsampling``.

``postselect_by_hamming_right_and_left`` and ``subsample`` are NumPy copies
and must agree bit for bit on the same generator.  ``subsample_device`` draws
from a ``torch.Generator``: it is held to its contract (distinct rows, sizes,
``sqd_tpu``'s errors) and to ``subsample``'s marginal frequencies.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from sqd_tpu import subsampling as jax_sub

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import subsampling as sub


def _matrix(seed, n=300, bits=12):
    """``n`` distinct random rows and a random distribution over them."""
    rng = np.random.default_rng(seed)
    ints = rng.choice(1 << bits, n, replace=False)
    mat = ((ints[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(bool)
    probs = rng.random(n)
    return mat, probs / probs.sum()


def _generator(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("weights", [(2, 3), (0, 1), (6, 6)])
def test_postselect_matches(weights):
    mat, probs = _matrix(1)
    kw = dict(hamming_right=weights[0], hamming_left=weights[1])
    with np.errstate(invalid="ignore"):  # nothing kept: 0/0, as in sqd_tpu
        ours = sub.postselect_by_hamming_right_and_left(mat, probs, **kw)
        ref = jax_sub.postselect_by_hamming_right_and_left(mat, probs, **kw)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("samples_per_batch,num_batches", [(40, 3), (1, 1), (300, 2), (500, 2)])
def test_subsample_matches(samples_per_batch, num_batches):
    mat, probs = _matrix(2)
    ours = sub.subsample(mat, probs, samples_per_batch, num_batches,
                         rand_seed=np.random.default_rng(5))
    ref = jax_sub.subsample(mat, probs, samples_per_batch, num_batches,
                            rand_seed=np.random.default_rng(5))
    assert len(ours) == len(ref) == num_batches
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def test_deprecated_wrappers_match():
    mat, probs = _matrix(3)
    kw = dict(hamming_right=3, hamming_left=3, samples_per_batch=10, num_batches=2, rand_seed=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = sub.postselect_and_subsample(mat, probs, **kw)
        mask = sub.post_select_by_hamming_weight(mat, hamming_right=3, hamming_left=3)
    assert [w.category for w in caught] == [DeprecationWarning] * 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_sub.postselect_and_subsample(mat, probs, **kw)
        ref_mask = jax_sub.post_select_by_hamming_weight(mat, hamming_right=3, hamming_left=3)
    np.testing.assert_array_equal(mask, ref_mask)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def test_subsample_device_rows_and_sizes():
    mat, probs = _matrix(4)
    probs[::3] = 0.0  # never drawn
    probs /= probs.sum()
    batches = sub.subsample_device(mat, probs, 50, 4, _generator(9), device="cpu")
    again = sub.subsample_device(mat, probs, 50, 4, _generator(9), device="cpu")
    assert len(batches) == 4
    index = {row.tobytes(): i for i, row in enumerate(mat)}
    for b, a in zip(batches, again):
        assert b.shape == (50, mat.shape[1]) and b.dtype == bool
        picked = [index[row.tobytes()] for row in b]
        assert len(set(picked)) == 50  # without replacement within a batch
        assert all(probs[i] > 0 for i in picked)
        np.testing.assert_array_equal(a, b)  # seed-reproducible
    assert any(not np.array_equal(a, b) for a, b in zip(batches, batches[1:]))
    for b in sub.subsample_device(mat, probs, 300, 2, _generator(0), device="cpu"):
        np.testing.assert_array_equal(b, mat)
    assert len(sub.subsample_device(mat[:0], probs[:0], 5, 3, _generator(0), device="cpu")) == 3


@pytest.mark.parametrize(
    "args",
    [
        ("probs", 5, 2),  # mismatched probabilities
        ("ok", 0, 2),
        ("ok", 5, 0),
        ("sparse", 5, 2),  # fewer positive weights than samples_per_batch
    ],
)
def test_subsample_device_errors_match(args):
    which, spb, nb = args
    mat, probs = _matrix(5, n=20)
    if which == "probs":
        probs = probs[:-1]
    if which == "sparse":
        probs = np.zeros(20)
        probs[:3] = 1 / 3
    with pytest.raises(ValueError) as ref:
        jax_sub.subsample_device(mat, probs, spb, nb, jax.random.key(0))
    with pytest.raises(ValueError) as ours:
        sub.subsample_device(mat, probs, spb, nb, _generator(0), device="cpu")
    assert str(ours.value) == str(ref.value)


def test_subsample_device_marginals_match_subsample():
    """Inclusion frequency of every row over 2000 batches of 4 from 12 rows.

    Each frequency is a mean of 2000 Bernoulli draws (sd <= 0.0112); the two
    samplers' frequencies differ by at most 0.05, about 3.2 sd of the
    difference, for every row.
    """
    rng = np.random.default_rng(6)
    mat = np.eye(12, dtype=bool)
    probs = rng.random(12) ** 2
    probs /= probs.sum()
    n_batches = 2000
    host = sub.subsample(mat, probs, 4, n_batches, rand_seed=rng)
    dev = sub.subsample_device(mat, probs, 4, n_batches, _generator(7), device="cpu")
    f_host = np.mean([b.sum(axis=0) for b in host], axis=0)
    f_dev = np.mean([b.sum(axis=0) for b in dev], axis=0)
    np.testing.assert_allclose(f_host.sum(), 4.0)
    np.testing.assert_allclose(f_dev.sum(), 4.0)
    assert np.max(np.abs(f_host - f_dev)) < 0.05
