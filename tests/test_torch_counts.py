# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's sample ingestion (``counts``, ``primitives.BitArray`` and the
bool-matrix half of ``ops.bitpack``) against ``sqd_tpu``'s, bit for bit."""

import numpy as np
import pytest

from sqd_tpu import counts as jax_counts
from sqd_tpu.ops import bitpack as jax_bitpack
from sqd_tpu.primitives import BitArray as JaxBitArray

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import counts
from sqd_tpu_torch.ops import bitpack
from sqd_tpu_torch.primitives import BitArray


def _equal(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("num_bits", [8, 33, 72])
def test_bit_array_to_arrays(num_bits):
    rows = np.random.default_rng(num_bits).integers(0, 2, size=(400, num_bits)).astype(bool)
    rows = np.vstack([rows, rows[:50]])  # repeated shots
    ours, ref = BitArray.from_bool_array(rows), JaxBitArray.from_bool_array(rows)
    np.testing.assert_array_equal(ours.array, ref.array)
    assert (ours.num_bits, ours.num_shots) == (ref.num_bits, ref.num_shots)
    np.testing.assert_array_equal(ours.to_bool_array(), rows)
    _equal(counts.bit_array_to_arrays(ours), jax_counts.bit_array_to_arrays(ref))
    # a bit array of the other package is accepted as it is
    _equal(counts.bit_array_to_arrays(ref), jax_counts.bit_array_to_arrays(ref))


def test_counts_to_arrays_and_from_counts():
    cnt = jax_counts.generate_counts_uniform(300, 10, rand_seed=3)
    _equal(counts.counts_to_arrays(cnt), jax_counts.counts_to_arrays(cnt))
    assert counts.normalize_counts_dict(cnt) == jax_counts.normalize_counts_dict(cnt)
    np.testing.assert_array_equal(
        BitArray.from_counts(cnt).array, JaxBitArray.from_counts(cnt).array
    )
    _equal(counts.counts_to_arrays({}), jax_counts.counts_to_arrays({}))


@pytest.mark.parametrize("seed", [0, 17])
def test_generators_same_streams(seed):
    assert counts.generate_counts_uniform(500, 12, rand_seed=seed) == (
        jax_counts.generate_counts_uniform(500, 12, rand_seed=seed)
    )
    np.testing.assert_array_equal(
        counts.generate_bit_array_uniform(500, 20, rand_seed=seed).array,
        jax_counts.generate_bit_array_uniform(500, 20, rand_seed=seed).array,
    )
    kw = dict(hamming_right=3, hamming_left=2, rand_seed=np.random.default_rng(seed))
    ours = counts.generate_counts_bipartite_hamming(400, 12, **kw)
    kw["rand_seed"] = np.random.default_rng(seed)
    assert ours == jax_counts.generate_counts_bipartite_hamming(400, 12, **kw)


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.generate_counts_uniform(0, 4),
        lambda m: m.generate_counts_uniform(4, 0),
        lambda m: m.generate_bit_array_uniform(0, 4),
        lambda m: m.generate_counts_bipartite_hamming(4, 5, hamming_right=1, hamming_left=1),
        lambda m: m.generate_counts_bipartite_hamming(4, 6, hamming_right=-1, hamming_left=1),
        lambda m: m.generate_counts_bipartite_hamming(4, 6, hamming_right=4, hamming_left=1),
    ],
)
def test_generator_errors(call):
    with pytest.raises(ValueError) as ref:
        call(jax_counts)
    with pytest.raises(ValueError) as ours:
        call(counts)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("num_bits", [8, 64, 72])
def test_bitstring_matrix_to_integers(num_bits):
    rows = np.random.default_rng(num_bits).integers(0, 2, size=(60, num_bits)).astype(bool)
    ours = counts.bitstring_matrix_to_integers(rows)
    ref = jax_counts.bitstring_matrix_to_integers(rows)
    assert ours.dtype == ref.dtype
    assert [int(x) for x in ours] == [int(x) for x in ref]


@pytest.mark.parametrize("num_bits", [5, 32, 70])
def test_bitpack_bool_matrix_half(num_bits):
    rows = np.random.default_rng(num_bits).integers(0, 2, size=(200, num_bits)).astype(bool)
    rows = np.vstack([rows, rows[::7]])
    packed = bitpack.pack_bool_matrix(rows)
    np.testing.assert_array_equal(packed, jax_bitpack.pack_bool_matrix(rows))
    np.testing.assert_array_equal(bitpack.unpack_to_bool_matrix(packed, num_bits), rows)
    _equal(bitpack.unique_packed(packed, return_counts=True),
           jax_bitpack.unique_packed(packed, return_counts=True))
    np.testing.assert_array_equal(bitpack.unique_packed(packed), jax_bitpack.unique_packed(packed))
    empty = np.zeros((0, packed.shape[1]), np.uint32)
    _equal(bitpack.unique_packed(empty, return_counts=True),
           jax_bitpack.unique_packed(empty, return_counts=True))
