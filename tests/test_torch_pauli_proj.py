# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.ops.pauli_proj``, the device half of ``ops.bitpack`` and the
Hermitian Davidson solvers against ``sqd_tpu``'s on the CPU.

Tolerances: device bitpack functions and membership tables bit for bit;
operator matvecs ``1e-12 * max(|ref|, 1)`` (``1e-6`` for ``dense32``), a
complex ``sqd_tpu`` operator read as ``out[:d] + 1j * out[d:]`` of its real
embedding; Davidson eigenvalues ``1e-8``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.models.heisenberg import heisenberg_ring as jax_heisenberg_ring
from sqd_tpu.ops import bitpack as jax_bitpack
from sqd_tpu.ops import davidson as jax_davidson
from sqd_tpu.ops import pauli_proj as jax_pp
from sqd_tpu.primitives import Pauli as JaxPauli
from sqd_tpu.primitives import SparsePauliOp as JaxSparsePauliOp

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch.convert import PAULI_FIELDS, pauli_operator_from_numpy
from sqd_tpu_torch.models.heisenberg import heisenberg_ring
from sqd_tpu_torch.ops import bitpack, davidson
from sqd_tpu_torch.ops import pauli_proj as pp
from sqd_tpu_torch.primitives import Pauli, SparsePauliOp

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dm_ring_terms(n, dm=0.3):
    return _chip_smoke().dm_ring_terms(n, dm)


def _subspace(nq, seed, count=300):
    """Sorted unique packed rows, half of them closed under the flips of bits
    0 and 0-1, so connected strings are both present and absent."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(count, nq)).astype(bool)
    half = bits[: count // 2]
    for cols in ([nq - 1], [nq - 2, nq - 1]):
        flipped = half.copy()
        flipped[:, cols] ^= True
        bits = np.vstack([bits, flipped])
    return jax_bitpack.unique_packed(jax_bitpack.pack_bool_matrix(bits))


# ---- the device half of ops.bitpack ------------------------------------------


@pytest.mark.parametrize("nq", [10, 40, 70])
def test_device_bitpack_matches(nq):
    rng = np.random.default_rng(nq)
    raw = jax_bitpack.pack_bool_matrix(rng.integers(0, 2, (400, nq)).astype(bool))
    sp = jax_bitpack.unique_packed(raw)
    t_raw, t_sp = bitpack.to_device_words(raw, "cpu"), bitpack.to_device_words(sp, "cpu")
    assert np.array_equal(bitpack.to_host_words(t_sp), sp)
    np.testing.assert_array_equal(bitpack.torch_popcount(t_raw).numpy(),
                                  np.asarray(jax_bitpack.jnp_popcount(jnp.asarray(raw))))
    np.testing.assert_array_equal(bitpack.torch_popcount_rows(t_raw).numpy(),
                                  np.asarray(jax_bitpack.jnp_popcount_rows(jnp.asarray(raw))))
    np.testing.assert_array_equal(bitpack.popcount(raw), jax_bitpack.popcount(raw))
    np.testing.assert_array_equal(bitpack.sort_packed(raw), jax_bitpack.sort_packed(raw))
    a, b = raw[:200], raw[200:]
    np.testing.assert_array_equal(
        bitpack.torch_lex_less(t_raw[:200], t_raw[200:]).numpy(),
        np.asarray(jax_bitpack.jnp_lex_less(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        bitpack.torch_lex_eq(t_raw[:200], t_sp[:200]).numpy(),
        np.asarray(jax_bitpack.jnp_lex_eq(jnp.asarray(a), jnp.asarray(sp[:200]))))
    payload = np.arange(len(raw), dtype=np.int32)
    got_rows, got_payload = bitpack.torch_sort_packed(t_raw, torch.as_tensor(payload))
    ref_rows, ref_payload = jax_bitpack.jnp_sort_packed(jnp.asarray(raw), jnp.asarray(payload))
    np.testing.assert_array_equal(bitpack.to_host_words(got_rows), np.asarray(ref_rows))
    np.testing.assert_array_equal(got_payload.numpy(), np.asarray(ref_payload))
    # present rows, absent rows, and queries below and above every row
    top = np.full((2, sp.shape[1]), 0xFFFFFFFF, np.uint32)
    queries = np.vstack([sp[::3], raw[:60] ^ np.uint32(1), np.zeros_like(top), top])
    t_q = bitpack.to_device_words(queries, "cpu")
    found = bitpack.torch_find_packed(t_sp, t_q).numpy()
    np.testing.assert_array_equal(
        found, np.asarray(jax_bitpack.jnp_find_packed(jnp.asarray(sp), jnp.asarray(queries))))
    assert (found == -1).any() and (found >= 0).any()
    pos = bitpack.torch_searchsorted_packed(t_sp, t_q).numpy()
    np.testing.assert_array_equal(pos, jax_bitpack.searchsorted_packed(sp, queries))
    # sqd_tpu's search reports n + 1 past the last row (see the port's docstring)
    ref_pos = np.asarray(jax_bitpack.jnp_searchsorted_packed(jnp.asarray(sp), jnp.asarray(queries)))
    np.testing.assert_array_equal(pos, np.minimum(ref_pos, len(sp)))


def test_lex_order_single_key_and_passes_agree():
    """62 qubits plus a 0/1 key fit one int64 key; 63 take the stable passes;
    both give the host lexicographic order, in 1D and batched."""
    rng = np.random.default_rng(2)
    for nq in (62, 63):
        packed = jax_bitpack.pack_bool_matrix(rng.integers(0, 2, (300, nq)).astype(bool))
        packed[1::2] = packed[::2]  # duplicate rows: the flag breaks the ties
        flag = np.tile([0, 1], 150)
        want = np.lexsort((flag, *(packed[:, j] for j in range(packed.shape[1]))))
        t_packed = bitpack.to_device_words(packed, "cpu")
        got = bitpack.torch_lex_order(t_packed, torch.as_tensor(flag))
        np.testing.assert_array_equal(got.numpy(), want)
        batched = bitpack.torch_lex_order(torch.stack([t_packed, t_packed.flip(0)]),
                                          torch.as_tensor(np.stack([flag, flag[::-1]])))
        np.testing.assert_array_equal(batched[0].numpy(), want)
        np.testing.assert_array_equal(batched[1].numpy(), 299 - want)


# ---- the per-term tables -----------------------------------------------------


@pytest.mark.parametrize("nq", [10, 40, 70])
@pytest.mark.parametrize("table", ["connected_table", "connected_table_rank",
                                   "connected_table_pair"])
def test_tables_match(nq, table):
    sp = _subspace(nq, seed=nq)
    t_sp = bitpack.to_device_words(sp, "cpu")
    w = sp.shape[1]
    for head in ("X", "Y", "ZX", "XX"):
        label = ("Z" * nq + head)[-nq:]
        pauli = JaxPauli.from_label(label)
        zw, xw = jax_pp.pauli_masks_to_packed(pauli.z, pauli.x)
        ref = getattr(jax_pp, table)(jnp.asarray(sp), jnp.asarray(zw[:w]), jnp.asarray(xw[:w]))
        got = getattr(pp, table)(t_sp, zw[:w], xw[:w])
        assert (got[0].dtype, got[1].dtype) == (torch.int32, torch.int8)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert (got[0].numpy() < len(sp)).any() and (got[0].numpy() == len(sp)).any()


@pytest.mark.parametrize("pair_min_d", [None, 1])
def test_pauli_term_table_matches(monkeypatch, pair_min_d):
    """Diagonal and non-diagonal terms, by binary search and (forced) pairing."""
    if pair_min_d:
        monkeypatch.setattr(pp, "_PAIR_MIN_D", pair_min_d)
    sp = _subspace(45, seed=12)
    t_sp = bitpack.to_device_words(sp, "cpu")
    for label in ("Z" * 45, "XX" + "Z" * 43, "I" * 44 + "Y", "I" * 20 + "Z" * 25):
        ref = jax_pp.pauli_term_table(jnp.asarray(sp), JaxPauli.from_label(label))
        got = pp.pauli_term_table(sp, Pauli.from_label(label), device="cpu")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert got[2] == ref[2]
        zw = jax_pp.pauli_masks_to_packed(Pauli.from_label(label).z, Pauli.from_label(label).x)[0]
        np.testing.assert_array_equal(
            pp.diagonal_sign_table(t_sp, zw[:2]).numpy(),
            np.asarray(jax_pp.diagonal_sign_table(jnp.asarray(sp), jnp.asarray(zw[:2]))))


# ---- the grouped operator ----------------------------------------------------


def _operators(kind):
    n = 10
    if kind == "real":
        return n, jax_heisenberg_ring(n, 0.9, 1.1, 0.7, 0.2), heisenberg_ring(n, 0.9, 1.1, 0.7, 0.2)
    terms = dm_ring_terms(n) + [("I" * (n - 1) + "Z", 0.1 + 0.2j)]  # a complex diagonal too
    return n, JaxSparsePauliOp.from_list(terms), SparsePauliOp.from_list(terms)


def _jax_apply(op, v):
    if not op.is_complex:
        return np.asarray(op.matvec(jnp.asarray(v.real)))
    d = op.dim
    out = np.asarray(op.matvec(jnp.asarray(np.concatenate([v.real, v.imag]))))
    return out[:d] + 1j * out[d:]


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("weights", ["dense64", "dense32", "packed"])
@pytest.mark.parametrize("path", ["default", "scan", "pairing"])
def test_build_projected_operator_matches(monkeypatch, kind, weights, path):
    if path == "scan":
        monkeypatch.setattr(pp, "_SCAN_MATVEC_BYTES", 1)
    if path == "pairing":
        monkeypatch.setattr(pp, "_PAIR_MIN_D", 1)
        monkeypatch.setattr(pp, "_PAIR_BATCH_BYTES", 1)  # one x-mask per batch
    n, jax_op, port_op = _operators(kind)
    rng = np.random.default_rng(8)
    ints = np.unique(rng.integers(0, 1 << n, size=400, dtype=np.int64))
    packed = ints.astype(np.uint32)[:, None]
    ref = jax_pp.build_projected_operator(packed, jax_op.paulis, jax_op.coeffs, weights=weights)
    got = pp.build_projected_operator(packed, port_op.paulis, port_op.coeffs, weights=weights,
                                      device="cpu")
    assert got.is_complex == (kind == "complex") == ref.is_complex
    assert (got.has_diag, got.packed_weights, got.num_groups) == (
        ref.has_diag, ref.packed_weights, ref.num_groups)
    assert got.scan_matvec == (ref.scan_matvec or path == "scan")
    assert got.embedded_dim == got.dim == len(ints)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_allclose(got.hdiag.numpy(), np.asarray(ref.hdiag), atol=1e-12)
    np.testing.assert_allclose(got.hdiag_im.numpy(), np.asarray(ref.hdiag_im), atol=1e-12)
    if weights == "packed":
        np.testing.assert_array_equal(got.sign_words.numpy().view(np.uint32),
                                      np.asarray(ref.sign_words))
    if weights != "packed":
        wide = weights == "dense64"
        assert got.weight.dtype == {
            True: torch.complex128 if wide else torch.complex64,
            False: torch.float64 if wide else torch.float32}[got.is_complex]
    v = rng.normal(size=got.dim) + (1j * rng.normal(size=got.dim) if got.is_complex else 0)
    want = _jax_apply(ref, v)
    out = pp.pauli_apply_flat(got, torch.as_tensor(v))
    tol = 1e-6 if weights == "dense32" else 1e-12
    np.testing.assert_allclose(out.numpy(), want, atol=tol * max(np.abs(want).max(), 1.0))
    assert got.memory_bytes == pp.estimate_operator_bytes(
        got.dim, num_nondiag_groups=got.perm.shape[0],
        max_terms_per_group=max(got.coeff.shape[1], 1) if weights == "packed" else 1,
        weights=weights, is_complex=got.is_complex, diag_is_complex=bool(got.hdiag_im.numel()))


def test_pairing_build_on_70_qubits(monkeypatch):
    """Three-word rows take the stable multi-pass sort in the batched pairing."""
    monkeypatch.setattr(pp, "_PAIR_MIN_D", 1)
    sp = _subspace(70, seed=3)
    labels = ["X" + "Z" * 69, "Y" + "I" * 69, "XX" + "I" * 68, "I" * 35 + "X" * 35, "Z" * 70]
    coeffs = np.array([0.5, -0.25, 1.0, 0.75, 0.3])
    ref = jax_pp.build_projected_operator(sp, [JaxPauli.from_label(s) for s in labels], coeffs)
    got = pp.build_projected_operator(sp, [Pauli.from_label(s) for s in labels], coeffs,
                                      device="cpu")
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    v = np.random.default_rng(4).normal(size=got.dim)
    want = _jax_apply(ref, v + 0j)
    np.testing.assert_allclose(got.matvec(torch.as_tensor(v)).numpy(), want,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))


def test_all_diagonal_operator_and_wide_term():
    labels = ["Z" * 6, "ZI" * 3, "I" * 6]
    coeffs = np.array([0.5, -0.3, 1.25])
    ints = np.unique(np.random.default_rng(5).integers(0, 64, size=40))
    packed = ints.astype(np.uint32)[:, None]
    ref = jax_pp.build_projected_operator(packed, [JaxPauli.from_label(s) for s in labels], coeffs)
    got = pp.build_projected_operator(packed, [Pauli.from_label(s) for s in labels], coeffs,
                                      device="cpu")
    assert got.perm.shape == (0, len(ints)) and got.num_groups == 1
    np.testing.assert_allclose(got.hdiag.numpy(), np.asarray(ref.hdiag), atol=1e-12)
    with pytest.raises(ValueError, match="more qubits"):
        pp.build_projected_operator(packed, [Pauli.from_label("X" + "I" * 39)], [1.0],
                                    device="cpu")


def test_estimate_operator_bytes_agrees_with_sqd_tpu():
    """Where ``sqd_tpu``'s model is exact (a real operator with a diagonal
    group), both estimates agree; at d = 5e7 the 88-term ring fits a card."""
    for weights in ("packed", "dense64", "dense32"):
        kwargs = dict(num_nondiag_groups=22, max_terms_per_group=2, weights=weights)
        assert pp.estimate_operator_bytes(10_000, **kwargs) == jax_pp.estimate_operator_bytes(
            10_000, **kwargs, has_diag=True)
    assert pp.estimate_operator_bytes(50_000_000, num_nondiag_groups=22,
                                      max_terms_per_group=2, is_complex=True) < 6e9


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("weights", ["dense64", "dense32", "packed"])
def test_pauli_operator_from_numpy_round_trip(kind, weights):
    n, jax_op, _ = _operators(kind)
    ints = np.unique(np.random.default_rng(9).integers(0, 1 << n, size=300, dtype=np.int64))
    ref = jax_pp.build_projected_operator(ints.astype(np.uint32)[:, None], jax_op.paulis,
                                          jax_op.coeffs, weights=weights)
    got = pauli_operator_from_numpy(
        {k: np.asarray(getattr(ref, k)) for k in PAULI_FIELDS}, is_complex=ref.is_complex,
        has_diag=ref.has_diag, packed_weights=ref.packed_weights,
        scan_matvec=ref.scan_matvec, device="cpu")
    assert got.perm.dtype == torch.int32
    v = np.random.default_rng(1).normal(size=got.dim) * (1 + 0.5j if ref.is_complex else 1)
    want = _jax_apply(ref, v)
    tol = 1e-6 if weights == "dense32" else 1e-12
    np.testing.assert_allclose(got.matvec(torch.as_tensor(v)).numpy(), want,
                               atol=tol * max(np.abs(want).max(), 1.0))
    with pytest.raises(KeyError):
        pauli_operator_from_numpy({"perm": np.zeros((0, 1))}, is_complex=False, has_diag=False,
                                  packed_weights=False, scan_matvec=False, device="cpu")


# ---- the Hermitian Davidson solvers ------------------------------------------


def _hermitian(dim, seed, is_complex):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) + (1j * rng.normal(size=(dim, dim)) if is_complex else 0)
    return (a + a.conj().T) / 2 + np.diag(np.arange(dim, dtype=float))


def _dense_matvec(mat, x):
    return mat @ x


@pytest.mark.parametrize("is_complex", [False, True])
def test_davidson_ground_state_hermitian(is_complex):
    dim = 120
    a = _hermitian(dim, 1, is_complex)
    exact = np.linalg.eigvalsh(a)
    hd = np.real(np.diag(a)).copy()
    dt = torch.complex128 if is_complex else torch.float64
    v0 = davidson.davidson_initial_guess(torch.as_tensor(hd), dt)
    res = davidson.davidson_ground_state(_dense_matvec, torch.as_tensor(a), torch.as_tensor(hd),
                                         v0, tol=1e-9, max_subspace=16, max_iterations=300)
    assert res.converged and isinstance(res.theta, float)
    assert abs(res.theta - exact[0]) < 1e-8
    vec = res.vector.numpy()
    assert np.linalg.norm(a @ vec - res.theta * vec) < 1e-8
    jv0 = jax_davidson.davidson_initial_guess(jnp.asarray(hd), jnp.complex128 if is_complex
                                              else jnp.float64)
    jres = jax_davidson.davidson_ground_state(_dense_matvec, jnp.asarray(a), jnp.asarray(hd), jv0,
                                              tol=1e-9, max_subspace=16, max_iterations=300)
    assert abs(res.theta - float(jres.theta)) < 1e-8


@pytest.mark.parametrize("is_complex", [False, True])
def test_davidson_lowest_k_hermitian(is_complex):
    dim, k = 150, 3
    a = _hermitian(dim, 2, is_complex)
    exact = np.linalg.eigvalsh(a)[:k]
    hd = np.real(np.diag(a)).copy()
    hd[[3, 7]] = hd[5]  # ties: the start block takes the lower indices, as lax.top_k
    block = davidson.davidson_initial_guess_k(torch.as_tensor(hd), k)
    np.testing.assert_array_equal(
        block.numpy(), np.asarray(jax_davidson.davidson_initial_guess_k(jnp.asarray(hd), k)))
    dt = torch.complex128 if is_complex else torch.float64
    res = davidson.davidson_lowest_k(_dense_matvec, torch.as_tensor(a), torch.as_tensor(hd),
                                     block.to(dt), k=k, tol=1e-9, max_subspace=20)
    assert res.converged
    np.testing.assert_allclose(res.thetas.numpy(), exact, atol=1e-8)
    vecs = res.vectors.numpy()
    np.testing.assert_allclose(vecs.conj() @ vecs.T, np.eye(k), atol=1e-8)
    jres = jax_davidson.davidson_lowest_k(
        _dense_matvec, jnp.asarray(a), jnp.asarray(hd),
        jnp.asarray(block.numpy()).astype(jnp.complex128 if is_complex else jnp.float64),
        k=k, tol=1e-9, max_subspace=20)
    np.testing.assert_allclose(res.thetas.numpy(), np.asarray(jres.thetas), atol=1e-8)
    with pytest.raises(ValueError, match="max_subspace"):
        davidson.davidson_lowest_k(_dense_matvec, torch.as_tensor(a), torch.as_tensor(hd),
                                   block.to(dt), k=k, max_subspace=5)
