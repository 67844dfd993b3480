# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.ops.dense_df`` against ``sqd_tpu.ops.dense_df`` on the CPU.

The same seeded problems as ``tests/test_dense_df.py``.  Tolerances: the f64
dense matvec against the f64 gather matvec ``1e-10`` relative to the largest
entry (only the factorization error separates them), f32 ``1e-4`` (f32 sums
in another order); the W stack, ``haa`` and ``hdiag`` against ``sqd_tpu``'s
``1e-12`` in f64 and ``1e-6`` in f32 (the diagonal of ``W`` sums ``norb``
terms in another order); energies ``1e-8`` Ha.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops import dense_df as jax_dense_df
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian as jax_build
from sqd_tpu.ops.hamiltonian import pivoted_cholesky_pairs

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion
from sqd_tpu_torch.convert import DENSE_DF_FIELDS, dense_df_operator_from_numpy
from sqd_tpu_torch.ops import dense_df
from sqd_tpu_torch.ops.davidson import davidson_ground_state, davidson_initial_guess
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian, sci_matvec_flat

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _problem(norb, nelec, m, n, seed=1):
    """``tests/test_dense_df.py``'s problem: PSD integrals from a seeded factor."""
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    rank = 3 * norb
    ch = rng.normal(size=(rank, norb, norb)) * (0.4 / np.sqrt(rank))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    sa = np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec[0]), m, replace=False))
    sb = np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec[1]), n, replace=False))
    return h1, eri, bitpack.pack_ints(sa, norb), bitpack.pack_ints(sb, norb)


def _both(norb, nelec, m, n, seed, *, same_sets=False, pad_to=None):
    """The factored Hamiltonian in both packages on one problem."""
    h1, eri, pa, pb = _problem(norb, nelec, m, n, seed=seed)
    if same_sets:
        pb = pa
    ell = pivoted_cholesky_pairs(eri, norb)
    ham_j = jax_build(pa, pb, h1, eri, norb, nelec, eri_factor=ell, pad_to=pad_to)
    ham_t = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=ell, pad_to=pad_to,
                                  device="cpu")
    return ham_j, ham_t


def _vector(shape, live, seed, dtype=np.float64):
    c = np.zeros(shape, dtype)
    c[: live[0], : live[1]] = np.random.default_rng(seed).normal(size=live)
    return c


def _assert_operator_matches(op, op_j, tol):
    for name in ("wa", "wb", "haa", "hbb"):
        np.testing.assert_allclose(getattr(op, name).numpy(), np.asarray(getattr(op_j, name)),
                                   rtol=0, atol=tol)
    # padded diagonal slots hold 1e30 in both
    np.testing.assert_allclose(op.hdiag.numpy(), np.asarray(op_j.hdiag), rtol=tol, atol=0)
    assert op.shape == tuple(op_j.shape)


@pytest.mark.parametrize("m,n", [(30, 30), (25, 40)])
def test_matvec_matches_gather_and_sqd_tpu_f64(m, n):
    ham_j, ham_t = _both(9, (4, 5), m, n, seed=3)
    op = dense_df.densify(ham_t, dtype=torch.float64)
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64)
    _assert_operator_matches(op, op_j, 1e-12)
    assert op.wa.data_ptr() != op.wb.data_ptr()
    c = _vector(ham_t.shape, (m, n), seed=0)
    s_dense = op.matvec(torch.as_tensor(c)).numpy()
    s_gather = ham_t.matvec(torch.as_tensor(c)).numpy()
    scale = np.abs(s_gather).max()
    np.testing.assert_allclose(s_dense, s_gather, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(s_dense, np.asarray(op_j.matvec(jnp.asarray(c))),
                               rtol=0, atol=1e-10 * scale)
    flat = dense_df.dense_df_matvec_flat(op, torch.as_tensor(c).reshape(-1))
    assert torch.equal(flat, torch.as_tensor(s_dense).reshape(-1))


def test_matvec_f32():
    ham_j, ham_t = _both(10, (5, 5), 40, 40, seed=5)
    op = dense_df.densify(ham_t)  # f32 is the default, as in sqd_tpu
    assert op.wa.dtype == op.haa.dtype == op.hdiag.dtype == torch.float32
    _assert_operator_matches(op, jax_dense_df.densify(ham_j), 1e-6)
    c = _vector(ham_t.shape, (40, 40), seed=1, dtype=np.float32)
    s_dense = op.matvec(torch.as_tensor(c)).numpy().astype(np.float64)
    s_gather = ham_t.astype(torch.float32).matvec(torch.as_tensor(c)).numpy().astype(np.float64)
    assert np.abs(s_dense - s_gather).max() < 1e-4 * np.abs(s_gather).max()


def test_with_padding():
    """Clamped padded tables stay inert through the one-hot build."""
    ham_j, ham_t = _both(9, (4, 4), 20, 20, seed=7, pad_to=(24, 32))
    op = dense_df.densify(ham_t, dtype=torch.float64)
    _assert_operator_matches(op, jax_dense_df.densify(ham_j, dtype=jnp.float64), 1e-12)
    c = torch.as_tensor(_vector(ham_t.shape, (20, 20), seed=2))
    s_gather, s_dense = ham_t.matvec(c).numpy(), op.matvec(c).numpy()
    np.testing.assert_allclose(s_dense, s_gather, rtol=0, atol=1e-10 * np.abs(s_gather).max())
    assert np.all(s_dense[20:, :] == 0) and np.all(s_dense[:, 20:] == 0)
    assert not op.wa[:, 20:].any() and not op.wa[:, :, 20:].any()
    assert not op.haa[20:].any() and not op.hbb[:, 20:].any()


def _theta(matvec, operator, hdiag):
    hd = hdiag.reshape(-1)
    return davidson_ground_state(
        matvec, operator, hd, davidson_initial_guess(hd, torch.float64),
        tol=1e-9, max_subspace=20, max_iterations=200,
    )


def test_davidson_ground_state():
    """The solve through the dense operator lands on the gather solve and on
    ``sqd_tpu``'s dense solve."""
    from sqd_tpu.ops.davidson import davidson_ground_state as jax_davidson
    from sqd_tpu.ops.davidson import davidson_initial_guess as jax_guess

    ham_j, ham_t = _both(10, (5, 5), 36, 36, seed=11)
    op = dense_df.densify(ham_t, dtype=torch.float64)
    r_dense = _theta(dense_df.dense_df_matvec_flat, op, op.hdiag)
    r_gather = _theta(sci_matvec_flat, ham_t, ham_t.hdiag)
    assert r_dense.converged
    assert abs(r_dense.theta - r_gather.theta) < 1e-8
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64)
    hd_j = op_j.hdiag.reshape(-1)
    r_jax = jax_davidson(jax_dense_df.dense_df_matvec_flat, op_j, hd_j,
                         jax_guess(hd_j, jnp.float64), tol=1e-9, max_subspace=20,
                         max_iterations=200)
    assert abs(r_dense.theta - float(r_jax.theta)) < 1e-8


SEGMENTED = {"converges": dict(tol=1e-9, max_iterations=200),
             "capped": dict(tol=1e-12, max_iterations=10)}


@pytest.mark.parametrize("case", list(SEGMENTED))
def test_davidson_ground_state_segmented(case):
    """``davidson_ground_state_segmented`` against ``sqd_tpu``'s on
    ``tests/test_dense_df.py``'s operator (7-iteration segments): the same
    energy within 1e-10 Ha and the same iteration count, converged or capped
    at ``max_iterations``."""
    from sqd_tpu.ops.davidson import davidson_ground_state_segmented as jax_segmented
    from sqd_tpu.ops.davidson import davidson_initial_guess as jax_guess

    from sqd_tpu_torch.ops.davidson import davidson_ground_state_segmented

    kwargs = dict(max_subspace=20, segment_iterations=7, **SEGMENTED[case])
    ham_j, ham_t = _both(10, (5, 5), 36, 36, seed=11)
    op = dense_df.densify(ham_t, dtype=torch.float64)
    hd = op.hdiag.reshape(-1)
    res = davidson_ground_state_segmented(dense_df.dense_df_matvec_flat, op, hd,
                                          davidson_initial_guess(hd, torch.float64), **kwargs)
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64)
    hd_j = op_j.hdiag.reshape(-1)
    ref = jax_segmented(jax_dense_df.dense_df_matvec_flat, op_j, hd_j,
                        jax_guess(hd_j, jnp.float64), **kwargs)
    assert abs(res.theta - float(ref.theta)) < 1e-10
    assert res.iterations == int(ref.iterations)
    assert res.converged == bool(ref.converged)
    if case == "converges":
        assert res.converged and res.iterations > 7  # it took several segments
    else:
        assert res.iterations == 10 and not res.converged
    np.testing.assert_allclose(abs(float(torch.dot(res.vector, res.vector))), 1.0, atol=1e-12)


@pytest.mark.parametrize("pad_to", [None, (32, 40)], ids=["same_pads", "mismatched_pads"])
def test_densify_aliases_wb_for_identical_sets(pad_to):
    """``sa == sb``: ``wb`` is the very tensor ``wa`` is, also when the two
    spins arrive padded to different widths, and the matvec pads and slices
    ``c`` around the square factors exactly."""
    ham_j, ham_t = _both(9, (4, 4), 25, 25, seed=19, same_sets=True, pad_to=pad_to)
    if pad_to is not None:
        assert ham_t.src_a.shape != ham_t.src_b.shape  # the mismatch under test
    op = dense_df.densify(ham_t, dtype=torch.float64)
    assert op.wb is op.wa and op.hbb is op.haa
    assert op.wa.data_ptr() == op.wb.data_ptr()
    width = 25 if pad_to is None else 40
    assert op.wa.shape[1:] == (width, width) and op.shape == ham_t.shape
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64)
    assert op_j.wb is op_j.wa
    _assert_operator_matches(op, op_j, 1e-12)
    c = torch.as_tensor(_vector(ham_t.shape, (25, 25), seed=6))
    s_gather, s_dense = ham_t.matvec(c).numpy(), op.matvec(c).numpy()
    assert s_dense.shape == s_gather.shape
    np.testing.assert_allclose(s_dense, s_gather, rtol=0, atol=1e-10 * np.abs(s_gather).max())
    assert np.all(s_dense[25:, :] == 0) and np.all(s_dense[:, 25:] == 0)
    # the flat solve goes through the same pad and slice
    r_dense = _theta(dense_df.dense_df_matvec_flat, op, op.hdiag)
    r_gather = _theta(sci_matvec_flat, ham_t, ham_t.hdiag)
    assert abs(r_dense.theta - r_gather.theta) < 1e-8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_two_builds_are_bit_equal(dtype, monkeypatch):
    """Tiles smaller than the tables (ragged pair and row tiles): the build
    adds in a fixed order, so a second build gives the same bits, and the
    tiling does not change them beyond rounding."""
    _, ham_t = _both(9, (4, 5), 30, 27, seed=3)
    whole = dense_df.densify(ham_t, dtype=dtype)
    monkeypatch.setattr(dense_df, "_BUILD_PAIR_CHUNK", 7)
    monkeypatch.setattr(dense_df, "_BUILD_COL_BLOCK", 8)
    first = dense_df.densify(ham_t, dtype=dtype)
    second = dense_df.densify(ham_t, dtype=dtype)
    for name in ("wa", "wb", "haa", "hbb", "hdiag"):
        assert torch.equal(getattr(first, name), getattr(second, name))
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    torch.testing.assert_close(first.wa, whole.wa, rtol=0, atol=tol)
    torch.testing.assert_close(first.wb, whole.wb, rtol=0, atol=tol)


def test_x_chunks_agree():
    """``x_chunk`` 0 (the whole stack in one contraction), 3 and 8 (ragged)."""
    _, ham_t = _both(9, (4, 5), 30, 27, seed=3)
    c = torch.as_tensor(_vector(ham_t.shape, (30, 27), seed=4))
    ops = {cx: dense_df.densify(ham_t, dtype=torch.float64, x_chunk=cx) for cx in (0, 3, 8)}
    assert ops[0].wa.shape[0] > 8 and ops[0].wa.shape[0] % 8  # several chunks, the last ragged
    ref = ops[8].matvec(c)
    for cx in (0, 3):
        assert ops[cx].x_chunk == cx
        torch.testing.assert_close(ops[cx].matvec(c), ref, rtol=0, atol=1e-12 * float(ref.abs().max()))


def test_sqd_tpu_operator_runs_through_the_port_matvec():
    """``convert.dense_df_operator_from_numpy``: one operator, both matvecs."""
    ham_j, _ = _both(9, (4, 4), 25, 25, seed=17, same_sets=True, pad_to=(32, 40))
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64, x_chunk=3)
    fields = {k: np.asarray(getattr(op_j, k)) for k in DENSE_DF_FIELDS}
    op = dense_df_operator_from_numpy(fields, x_chunk=op_j.x_chunk, aliased=op_j.wb is op_j.wa,
                                      device="cpu")
    assert op.x_chunk == 3 and op.wb is op.wa and op.shape == (32, 40)
    c = _vector(op.shape, (25, 25), seed=8)
    ref = np.asarray(op_j.matvec(jnp.asarray(c)))
    np.testing.assert_allclose(op.matvec(torch.as_tensor(c)).numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    apart = dense_df_operator_from_numpy(fields, x_chunk=8, device="cpu")
    assert apart.wb is not apart.wa
    with pytest.raises(KeyError):
        dense_df_operator_from_numpy({"wa": fields["wa"]}, x_chunk=8, device="cpu")


@pytest.fixture(scope="module")
def api_problem():
    """``tests/test_dense_df.py::test_solve_sci_dense_df_strategy``'s problem:
    17 orbitals, so that ``eri_factor="auto"`` factors the integrals."""
    norb, nelec = 17, (3, 3)
    rng = np.random.default_rng(21)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    ch = rng.normal(size=(3 * norb, norb, norb)) * (0.4 / np.sqrt(3 * norb))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    all_s = dense_fci.all_hamming_strings(norb, 3)
    sa = np.sort(rng.choice(all_s, 25, replace=False))
    sb = np.sort(rng.choice(all_s, 25, replace=False))
    eri_bad = rng.normal(size=(norb,) * 4)
    eri_bad = eri_bad + eri_bad.transpose(1, 0, 2, 3)
    eri_bad = eri_bad + eri_bad.transpose(0, 1, 3, 2)
    eri_bad = eri_bad + eri_bad.transpose(2, 3, 0, 1)
    return (sa, sb), h1, eri, eri_bad, norb, nelec


@pytest.mark.parametrize("solver", ["f64", "f32"])
def test_solve_sci_dense_df_strategy(api_problem, solver):
    strs, h1, eri, _, norb, nelec = api_problem
    kwargs = {} if solver == "f64" else {"tol": 1e-9, "refine_iterations": 40}
    dt_t = {} if solver == "f64" else {"solver_dtype": torch.float32}
    dt_j = {} if solver == "f64" else {"solver_dtype": jnp.float32}
    r_dense = fermion.solve_sci(strs, h1, eri, norb, nelec, device="cpu",
                                matvec_strategy="dense_df", **kwargs, **dt_t)
    r_gather = fermion.solve_sci(strs, h1, eri, norb, nelec, device="cpu", **kwargs, **dt_t)
    r_jax = jax_fermion.solve_sci(strs, h1, eri, norb, nelec, matvec_strategy="dense_df",
                                  **kwargs, **dt_j)
    assert abs(r_dense.energy - r_jax.energy) < 1e-8
    assert abs(r_dense.energy - r_gather.energy) < 1e-8
    for got, ref in zip(r_dense.orbital_occupancies, r_jax.orbital_occupancies):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r_dense.rdm2, r_jax.rdm2, rtol=0, atol=1e-6)


def test_solve_sci_dense_df_errors(api_problem):
    """``sqd_tpu``'s two ``ValueError``s, in its words, and the unknown strategy."""
    strs, h1, eri, eri_bad, norb, nelec = api_problem
    cases = (
        ("fused spin penalty", dict(two=eri, spin_sq=0.0, matvec_strategy="dense_df")),
        ("requires a PSD ERI factor", dict(two=eri_bad, spin_sq=None, matvec_strategy="dense_df")),
        ("unknown matvec_strategy 'bogus'", dict(two=eri, spin_sq=None, matvec_strategy="bogus")),
    )
    for words, case in cases:
        two = case.pop("two")
        with pytest.raises(ValueError, match=words) as ours:
            fermion.solve_sci(strs, h1, two, norb, nelec, device="cpu", **case)
        with pytest.raises(ValueError, match=words) as theirs:
            jax_fermion.solve_sci(strs, h1, two, norb, nelec, **case)
        assert str(ours.value) == str(theirs.value)


def test_densify_requires_factor_and_no_penalty():
    h1, eri, pa, pb = _problem(8, (4, 4), 15, 15, seed=13)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, 8, (4, 4), eri_factor=None, device="cpu")
    with pytest.raises(ValueError, match="densify requires an ERI factor"):
        dense_df.densify(ham)
    ell = pivoted_cholesky_pairs(eri, 8)
    ham_pen = build_sci_hamiltonian(pa, pb, h1, eri, 8, (4, 4), eri_factor=ell, spin_shift=0.2,
                                    device="cpu")
    with pytest.raises(ValueError, match="does not support the fused spin penalty"):
        dense_df.densify(ham_pen)


def test_chip_smoke_config5_is_the_bench_recipe():
    """``chip_smoke.config5_problem`` against ``bench.py``'s BASELINE config 5
    lines at the bench's small size (96 strings), bit for bit; the strings are
    two words wide and ``"auto"`` factors the integrals at rank 108."""
    smoke, bench = _load("chip_smoke"), _load("bench")
    h1, eri, strs = smoke.config5_problem(96)
    norb7, nelec7 = 36, (27, 27)
    rng7 = np.random.default_rng(7)
    orb_e7 = np.linspace(-14.0, 4.0, norb7)
    h17 = np.diag(orb_e7) + 0.05 * rng7.normal(size=(norb7, norb7))
    h17 = (h17 + h17.T) / 2
    chol7 = rng7.normal(size=(3 * norb7, norb7, norb7)) * (0.5 / np.sqrt(3 * norb7))
    chol7 = (chol7 + chol7.transpose(0, 2, 1)) / 2
    eri7 = np.einsum("xpq,xrs->pqrs", chol7, chol7)
    np.testing.assert_array_equal(h1, h17)
    np.testing.assert_array_equal(eri, eri7)
    np.testing.assert_array_equal(strs, bench.excitation_strings(96, norb7, nelec7[0], 1))
    assert (smoke.CONFIG5["norb"], smoke.CONFIG5["nelec"], smoke.CONFIG5["strings"]) == (
        norb7, nelec7, 3163)
    assert {k: smoke.CONFIG5_SOLVER[k] for k in ("tol", "max_subspace", "max_cycle")} == {
        "tol": 1e-4, "max_subspace": 12, "max_cycle": 200}
    packed = bitpack.pack_ints(strs, norb7)
    assert packed.shape == (96, 2)
    ham = build_sci_hamiltonian(packed, packed, h1, eri, norb7, nelec7, device="cpu")
    assert ham.eri_chol is not None and ham.eri_chol.shape[0] == 108 <= norb7 ** 2 // 3
    # the script's device quotient is the host quotient
    c = np.random.default_rng(0).normal(size=ham.shape)
    assert abs(smoke.device_f64_energy(ham, c) - smoke.host_f64_energy(ham, c)) < 1e-9
