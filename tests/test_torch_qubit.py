# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.qubit`` and the qubit path's native kernels against
``sqd_tpu``'s on the CPU.

Tolerances: matrix elements and native outputs bit for bit (amplitudes
exact); projected matrices ``1e-12``; energies ``1e-8``; eigenvector
columns orthonormal to ``1e-8``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sqd_tpu import native as jax_native
from sqd_tpu import qubit as jax_qubit
from sqd_tpu.models.heisenberg import heisenberg_ring as jax_heisenberg_ring
from sqd_tpu.models.heisenberg import transverse_field_ising as jax_tfim
from sqd_tpu.primitives import Pauli as JaxPauli
from sqd_tpu.primitives import SparsePauliOp as JaxSparsePauliOp

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import native, qubit
from sqd_tpu_torch.models.heisenberg import heisenberg_ring, transverse_field_ising
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


def _bits(ints, n):
    return ((np.asarray(ints)[:, None] >> np.arange(n)[::-1]) & 1).astype(bool)


def _random_rows(n, count, seed):
    rng = np.random.default_rng(seed)
    return qubit.sort_and_remove_duplicates(rng.integers(0, 2, (count, n)).astype(bool))


def test_primitives_and_models_match():
    for label in ("XZIY", "IIII", "YYZX"):
        p, q = Pauli.from_label(label), JaxPauli.from_label(label)
        assert p.to_label() == q.to_label() == label
        np.testing.assert_array_equal(p.z, q.z)
        np.testing.assert_array_equal(p.x, q.x)
    terms = [("XY", 0.5), ("ZZ", -1.0 + 0.25j)]
    np.testing.assert_array_equal(SparsePauliOp.from_list(terms).to_matrix(),
                                  JaxSparsePauliOp.from_list(terms).to_matrix())
    for ours, theirs in ((heisenberg_ring(5, 0.9, 1.1, 0.7, 0.3), jax_heisenberg_ring(5, 0.9, 1.1, 0.7, 0.3)),
                         (transverse_field_ising(5, 1.0, 0.7, True), jax_tfim(5, 1.0, 0.7, True))):
        assert [p.to_label() for p in ours.paulis] == [p.to_label() for p in theirs.paulis]
        np.testing.assert_array_equal(ours.coeffs, theirs.coeffs)
        assert (ours.size, ours.num_qubits) == (theirs.size, theirs.num_qubits)


def test_sort_and_remove_duplicates():
    mat = np.array([[1, 1], [0, 1], [1, 1], [1, 0]], dtype=bool)
    np.testing.assert_array_equal(qubit.sort_and_remove_duplicates(mat), [[0, 1], [1, 0], [1, 1]])
    rows = np.random.default_rng(0).integers(0, 2, (300, 70)).astype(bool)
    np.testing.assert_array_equal(qubit.sort_and_remove_duplicates(rows),
                                  jax_qubit.sort_and_remove_duplicates(rows))


def test_xziy_hand_oracle():
    """Rows 0001 and 1000 are the only connected pair of XZIY; the amplitude
    on row 0001's bits is -1j, stored at (row 1, col 5)."""
    bs_mat = np.array([[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 0, 1, 1],
                       [0, 1, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0]], dtype=bool)
    amps, rows, cols = qubit.matrix_elements_from_pauli(bs_mat, Pauli.from_label("XZIY"),
                                                        device="cpu")
    order = np.lexsort((cols, rows))
    np.testing.assert_array_equal(rows[order], [1, 5])
    np.testing.assert_array_equal(cols[order], [5, 1])
    np.testing.assert_allclose(amps[order], [-1j, 1j], atol=0)


@pytest.mark.parametrize("nq", [4, 40, 70])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("branch", ["host", "search", "pairing"])
def test_matrix_elements_match(monkeypatch, nq, packed, branch):
    """Bool and packed input, diagonal and non-diagonal terms, each membership
    branch (the host radix merge holds to 2 words; the device takes the rest)."""
    if branch != "host":
        monkeypatch.setattr(qubit, "HOST_MEMBERSHIP_MAX_D", 0)
    if branch == "pairing":
        monkeypatch.setattr(qubit, "_PAIR_MIN_D", 1)
    mat = _random_rows(nq, 120 if nq == 4 else 300, seed=nq)
    if nq == 4:
        mat = np.vstack([mat, ~mat])  # a closed set: every XYZ flip stays inside
        mat = qubit.sort_and_remove_duplicates(mat)
    inp = bitpack.pack_bool_matrix(mat) if packed else mat
    for head in ("X", "Y", "ZX", "Z", "XZIY"):
        label = (("I" * nq) + head)[-nq:] if nq > 4 else head.rjust(4, "Z")[-4:]
        got = qubit.matrix_elements_from_pauli(inp, Pauli.from_label(label), device="cpu")
        ref = jax_qubit.matrix_elements_from_pauli(inp, JaxPauli.from_label(label))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_project_operator_and_solve_qubit_match():
    n = 6
    mat = _random_rows(n, 40, seed=1)
    op, jop = heisenberg_ring(n, h_z=0.3), jax_heisenberg_ring(n, h_z=0.3)
    got = qubit.project_operator_to_subspace(mat, op, device="cpu").toarray()
    ref = jax_qubit.project_operator_to_subspace(mat, jop).toarray()
    np.testing.assert_allclose(got, ref, atol=1e-12)
    kwargs = dict(k=3, which="SA", v0=np.ones(len(mat)), maxiter=5000)
    e_got, _ = qubit.solve_qubit(mat, op, device="cpu", **kwargs)
    e_ref, _ = jax_qubit.solve_qubit(mat, jop, **kwargs)
    np.testing.assert_allclose(np.sort(e_got), np.sort(e_ref), atol=1e-8)
    full = _bits(np.arange(16), 4)
    e_full, _ = qubit.solve_qubit(full, heisenberg_ring(4), device="cpu",
                                  k=3, which="SA", v0=np.ones(16), maxiter=5000)
    np.testing.assert_allclose(np.sort(e_full),
                               np.linalg.eigvalsh(heisenberg_ring(4).to_matrix())[:3], atol=1e-8)


def _models(kind, n):
    if kind == "real":
        return heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3), jax_heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3)
    terms = dm_ring_terms(n)
    return SparsePauliOp.from_list(terms), JaxSparsePauliOp.from_list(terms)


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("k", [1, 3])
def test_solve_qubit_device_matches(kind, k):
    n = 10
    op, jop = _models(kind, n)
    ints = np.unique(np.random.default_rng(17).integers(0, 1 << n, size=600, dtype=np.int64))
    mat = _bits(ints, n)
    e_ref, _ = qubit.solve_qubit(mat, op, device="cpu", k=k, which="SA")
    if k == 1:
        energy, vec, proj = qubit.solve_qubit_device(mat, op, device="cpu")
        e_jax, _, _ = jax_qubit.solve_qubit_device(mat, jop)
        assert proj.is_complex == (kind == "complex") == np.iscomplexobj(vec)
        assert abs(energy - e_jax) < 1e-8 and abs(energy - e_ref[0]) < 1e-8
        assert abs(np.linalg.norm(vec) - 1.0) < 1e-10
        return
    w, v, _ = qubit.solve_qubit_device(mat, op, k=k, tol=1e-9, device="cpu")
    w_jax, _, _ = jax_qubit.solve_qubit_device(mat, jop, k=k, tol=1e-9)
    np.testing.assert_allclose(w, np.sort(e_ref), atol=1e-8)
    np.testing.assert_allclose(w, np.sort(w_jax), atol=1e-8)
    assert v.shape == (len(ints), k)
    np.testing.assert_allclose(v.conj().T @ v, np.eye(k), atol=1e-8)


def _sparse_dm_ring_strings(seed, n=20, d=5000):
    """``d`` unique ``n``-bit strings drawn from ``seed``, ascending: 0.5 % of
    the space, so most strings are connected to no other."""
    rng = np.random.default_rng(seed)
    ints = np.unique(rng.integers(0, 1 << n, size=6000, dtype=np.int64))
    return np.sort(rng.permutation(ints)[:d])


def test_block_davidson_complex_reaches_isolated_lowest_level():
    """The 20-site DM ring (D = 0.3) over 5000 strings from seed 1, the first
    seed on which ``eigsh`` and ``sqd_tpu`` agree on all three levels: the
    lowest level, -16, is one string that nothing connects to the rest.  A
    k-wide start block of one-hots that carry the spread stalled near -15.97
    after 300 iterations; the 2k-pair solve from bare one-hots reaches
    ``eigsh``'s and ``sqd_tpu``'s levels (1e-8)."""
    n, k = 20, 3
    op, jop = _models("complex", n)
    mat = _bits(_sparse_dm_ring_strings(seed=1), n)
    # a generic start: a constant one has no weight on the degenerate level
    v0 = np.random.default_rng(0).normal(size=len(mat))
    e_ref, _ = qubit.solve_qubit(mat, op, device="cpu", k=k, which="SA", v0=v0, maxiter=5000)
    w, v, _ = qubit.solve_qubit_device(mat, op, k=k, device="cpu")
    w_jax, _, _ = jax_qubit.solve_qubit_device(mat, jop, k=k)
    assert abs(np.sort(e_ref)[0] + 16.0) < 1e-8
    np.testing.assert_allclose(w, np.sort(e_ref), atol=1e-8)
    np.testing.assert_allclose(w, np.sort(w_jax), atol=1e-8)
    assert v.shape == (len(mat), k) and np.iscomplexobj(v)
    np.testing.assert_allclose(v.conj().T @ v, np.eye(k), atol=1e-8)


def test_initial_block_spans_bare_one_hots():
    hd = torch.as_tensor(np.random.default_rng(3).normal(size=50))
    block = davidson.davidson_initial_block(hd, 6, torch.complex128)
    assert block.shape == (6, 50) and block.dtype == torch.complex128
    rows = davidson.davidson_initial_guess_k(hd, 5, torch.complex128)
    assert torch.equal(block[:5], rows)
    lowest = torch.sort(hd).indices[:5]
    bare = block[:5] - 0.2 * block[5]
    expect = torch.zeros_like(bare)
    expect[torch.arange(5), lowest] = 1.0
    torch.testing.assert_close(bare, expect, atol=1e-15, rtol=0)


def test_real_block_solve_is_unchanged():
    """A real operator's k > 1 solve is the k-pair block Davidson from the
    k-row start block, bit for bit."""
    n, k = 10, 3
    op, _ = _models("real", n)
    ints = np.unique(np.random.default_rng(17).integers(0, 1 << n, size=600, dtype=np.int64))
    w, v, proj = qubit.solve_qubit_device(_bits(ints, n), op, k=k, tol=1e-9, device="cpu")
    res = davidson.davidson_lowest_k(
        pp.pauli_apply_flat, proj, proj.hdiag,
        davidson.davidson_initial_guess_k(proj.hdiag, k, torch.float64),
        k=k, tol=1e-9, max_subspace=32, max_iterations=300,
    )
    np.testing.assert_array_equal(w, res.thetas.numpy())
    np.testing.assert_array_equal(v, res.vectors.T.numpy())


@pytest.mark.parametrize("option", ["packed_weights", "single_stage_f64", "single_stage_f32",
                                    "packed_input_70q"])
def test_solve_qubit_device_options(monkeypatch, option):
    """The packed-weight group loop (the d >= 2e6 default, forced small), a
    single stage in a given ``dtype``, and 70-qubit packed input."""
    n = 8
    op, jop = heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3), jax_heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3)
    mat = _bits(np.unique(np.random.default_rng(12).integers(0, 1 << n, size=180)), n)
    e_ref = qubit.solve_qubit(mat, op, device="cpu", k=1, which="SA")[0][0]
    kwargs = {}
    if option == "packed_weights":
        monkeypatch.setattr(pp, "_PACKED_WEIGHTS_MIN_D", 1)
    elif option == "single_stage_f64":
        kwargs = {"dtype": torch.float64}
    elif option == "single_stage_f32":
        kwargs = {"dtype": torch.float32, "tol": 1e-4}
    else:  # 70 qubits: the ring acts on the low 8, the rest stay fixed per row
        high = np.random.default_rng(1).integers(0, 2, 62).astype(bool)
        mat = np.hstack([np.tile(high, (len(mat), 1)), mat])
        op = SparsePauliOp([Pauli(np.r_[p.z, np.zeros(62, bool)], np.r_[p.x, np.zeros(62, bool)])
                            for p in op.paulis], op.coeffs)
        mat = bitpack.pack_bool_matrix(mat)
    energy, vec, proj = qubit.solve_qubit_device(mat, op, device="cpu", **kwargs)
    if option == "packed_weights":
        assert proj.packed_weights and proj.scan_matvec
    tol = 1e-4 if option == "single_stage_f32" else 1e-8
    assert abs(energy - e_ref) < tol
    assert vec.dtype == (np.float32 if option == "single_stage_f32" else np.float64)


@pytest.mark.parametrize("nq", [10, 40])
def test_native_connected_membership_matches(nq):
    mat = _random_rows(nq, 200, seed=nq)
    mat = qubit.sort_and_remove_duplicates(np.vstack([mat, mat[:100] ^ _bits([5], nq)]))
    packed = bitpack.pack_bool_matrix(mat)
    x = np.zeros(packed.shape[1], np.uint32)
    x[0] = 5
    got = native.connected_membership(packed, x)
    np.testing.assert_array_equal(got, jax_native.connected_membership(packed, x))
    assert (got >= 0).any() and (got == -1).any()
    with pytest.raises(ValueError, match="2 words"):
        native.connected_membership(np.zeros((3, 3), np.uint32), np.zeros(3, np.uint32))


@pytest.mark.parametrize("nq", [13, 40, 45, 70])
def test_native_pauli_diag_elements_matches(nq):
    rng = np.random.default_rng(nq)
    mat = _random_rows(nq, 257, seed=nq)
    zcols = rng.integers(0, 2, nq).astype(np.uint8)
    packed = bitpack.pack_bool_matrix(mat)
    zw = bitpack.pack_bool_matrix(zcols[None, :].astype(bool))[0]
    for inp, zmask in ((mat, zcols), (packed, zw)):
        got = native.pauli_diag_elements(inp, zmask, -1j)
        ref = jax_native.pauli_diag_elements(inp, zmask, -1j)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0].imag, -((-1.0) ** mat[:, zcols.astype(bool)].sum(1)))
    with pytest.raises(TypeError):
        native.pauli_diag_elements(mat.astype(np.int8), zcols, 1.0)
    with pytest.raises(ValueError, match="columns"):
        native.pauli_diag_elements(mat, zcols[1:], 1.0)


def test_qubit_record_matches_phase_nine_inputs():
    """``tools/make_qubit_data.py``'s record is of the subspace and the
    Hamiltonian that ``chip_smoke.py`` phase 9 builds: the strings' digest and
    the operator's group count (the ring's unique x-masks plus the diagonal)."""
    smoke = _chip_smoke()
    with open(smoke.QUBIT_DATA) as f:
        record = json.load(f)
    solve = smoke.QUBIT_SOLVE
    assert {k: record[k] for k in ("sites", "h_z", "seed", "tol")} == {
        k: solve[k] for k in ("sites", "h_z", "seed", "tol")}
    ints = smoke.solve_strings(solve["sites"], record["d"], solve["seed"])
    assert smoke.strings_digest(ints) == record["sha256_strings"]
    op = heisenberg_ring(solve["sites"], h_z=solve["h_z"])
    x_masks = {pp.pauli_masks_to_packed(p.z, p.x)[1].tobytes() for p in op.paulis}
    assert len(x_masks) == record["num_groups"] == solve["sites"] + 1
    assert record["terms"] == op.size == 4 * solve["sites"]
    assert record["packed_weights"] and record["scan_matvec"]  # d past 2e6
