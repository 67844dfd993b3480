# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's excitation augmentation against ``sqd_tpu``'s on the CPU, bit
for bit: ``apply_excitations`` (rows and legality) and
``enlarge_batch_from_transitions`` (rows and their order) on
hypothesis-drawn bit matrices and operator strings, with the operators in
one chunk and in chunks forced down to one operator."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion

from test_torch_sqd_loop import _chip_smoke

CHARS = np.array(["I", "+", "-", "n"])


@st.composite
def batches(draw):
    """(bits (samples, n_bits) bool, operators (ops, n_bits) of I + - n)."""
    n_bits = draw(st.integers(1, 12))
    n_samples = draw(st.integers(1, 9))
    n_ops = draw(st.integers(1, 7))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_samples, n_bits)).astype(bool)
    # mostly identities, as real operators are: a few non-identity modes each
    weights = draw(st.sampled_from([(0.7, 0.1, 0.1, 0.1), (0.25, 0.25, 0.25, 0.25)]))
    ops = CHARS[rng.choice(4, size=(n_ops, n_bits), p=weights)]
    return bits, ops


@settings(max_examples=60, deadline=None)
@given(batch=batches())
def test_apply_excitations_matches_sqd_tpu(batch):
    bits, ops = batch
    masks = jax_fermion._transition_str_to_bool(ops)
    ours = fermion._transition_str_to_bool(ops)
    for a, b in zip(ours, masks):
        np.testing.assert_array_equal(a, b)
    ref_rows, ref_legal = jax_fermion.apply_excitations(
        jnp.asarray(bits), *(jnp.asarray(m) for m in masks))
    rows, legal = fermion.apply_excitations(torch.as_tensor(bits),
                                            *(torch.as_tensor(m) for m in ours))
    assert rows.dtype == torch.bool and legal.dtype == torch.bool
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(legal.numpy(), np.asarray(ref_legal))


@pytest.mark.parametrize("chunk_bytes", [None, 1])
@settings(max_examples=40, deadline=None)
@given(batch=batches())
def test_enlarge_batch_matches_sqd_tpu(chunk_bytes, batch):
    bits, ops = batch
    ref = jax_fermion.enlarge_batch_from_transitions(bits, ops)
    with pytest.MonkeyPatch.context() as mp:
        if chunk_bytes is not None:  # one operator per chunk
            mp.setattr(fermion, "EXCITATION_CHUNK_BYTES", chunk_bytes)
        out = fermion.enlarge_batch_from_transitions(bits, ops, device="cpu")
    assert out.dtype == np.bool_ and out.shape[1] == bits.shape[1]
    np.testing.assert_array_equal(out, ref)


def test_single_operator_and_reference_example():
    """``tests/test_fermion_workflow.py``'s example, and one operator given
    as a 1-D string array."""
    mat = np.array([[True, False, True, False]])
    ops = np.array([["I", "I", "I", "I"], ["+", "-", "I", "I"], ["-", "I", "I", "I"]])
    out = fermion.enlarge_batch_from_transitions(mat, ops, device="cpu")
    np.testing.assert_array_equal(out, [[True, False, True, False], [False, False, True, False]])
    one = fermion.enlarge_batch_from_transitions(mat, ops[2], device="cpu")
    np.testing.assert_array_equal(one, jax_fermion.enlarge_batch_from_transitions(mat, ops[2]))


def test_all_single_excitations_count_from_occupancies():
    """Every same-spin single excitation, as ``chip_smoke.py`` phase 11 (c)
    builds them (``single_excitation_operators``): the legal rows number
    n_occ * (half - n_occ) per half and shot, operator-major, equal to
    ``sqd_tpu``'s and to the phase's NumPy loop (``excitation_rows_loop``),
    here on ``n``-mode operators too."""
    chip_smoke = _chip_smoke()
    half = 5
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (40, 2 * half)).astype(bool)
    ops = chip_smoke.single_excitation_operators(half)
    assert ops.shape == (2 * half * (half - 1), 2 * half)
    out = fermion.enlarge_batch_from_transitions(bits, ops, device="cpu")
    n_left, n_right = bits[:, :half].sum(1), bits[:, half:].sum(1)
    expected = int((n_left * (half - n_left) + n_right * (half - n_right)).sum())
    assert len(out) == expected
    np.testing.assert_array_equal(out, jax_fermion.enlarge_batch_from_transitions(bits, ops))
    np.testing.assert_array_equal(out, chip_smoke.excitation_rows_loop(bits, ops))
    mixed = np.concatenate([ops, CHARS[rng.choice(4, size=(6, 2 * half))]])
    np.testing.assert_array_equal(chip_smoke.excitation_rows_loop(bits, mixed),
                                  jax_fermion.enlarge_batch_from_transitions(bits, mixed))
