# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's large-shape paths against ``sqd_tpu`` on the CPU.

The column-blocked f64 and f32 matvecs (both variants, forced by their
mangled names), the pivoted-Cholesky pair factor (and the f32 matvecs,
which contract the exact integrals, against ``sqd_tpu``'s factored ones),
the padding and column block by device, the pair factor computed only for
the routes that read it, the diagonal assembled on the device, the
``"sparse"`` same-spin tables and ``solve_sci`` where ``eri_factor="auto"``
factors.  Tolerances:
f64 matvecs ``1e-12 * max(|ref|, 1)``; f32 matvecs ``1e-5 * max(|ref|, 1)``;
the factor and the diagonal ``1e-12``; tables bit for bit; energies
``1e-9`` Ha.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu import native as jax_native
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops import hamiltonian as jax_ham

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion, native
from sqd_tpu_torch.convert import FIELDS, hamiltonian_from_numpy
from sqd_tpu_torch.ops import hamiltonian as port_ham

torch.set_num_threads(2)

NORB, NELEC = 6, (3, 2)
VARIANTS = ("_SCIHamiltonian__matvec_blocked",
            "_SCIHamiltonian__matvec_blocked_beta_first_rowmajor")


def _random_integrals(norb, seed):
    """Symmetric integrals whose pair matrix is indefinite (no factor)."""
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    e = rng.normal(size=(norb,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    return h1 + h1.T, 0.1 * e


def _psd_integrals(norb, rank, seed):
    """8-fold-symmetric integrals ``sum_k L_k (x) L_k`` with symmetric ``L_k``:
    a PSD pair matrix of rank ``rank``."""
    rng = np.random.default_rng(seed)
    chol = rng.normal(size=(rank, norb, norb)) * (0.4 / np.sqrt(rank))
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    h1 = rng.normal(size=(norb, norb))
    return (h1 + h1.T) / 2, np.einsum("xpq,xrs->pqrs", chol, chol)


def _strings(norb, nelec, count, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec), count, replace=False))


def _pair(norb, nelec, strs, h1, eri, **kwargs):
    """``sqd_tpu``'s operator and the port's, converted from the same fields."""
    pa, pb = (bitpack.pack_ints(s, norb) for s in strs)
    ham_j = jax_ham.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, **kwargs)
    fields = {k: np.asarray(getattr(ham_j, k)) for k in FIELDS}
    if ham_j.eri_chol is not None:
        fields["eri_chol"] = np.asarray(ham_j.eri_chol)
    ham_t = hamiltonian_from_numpy(
        fields, norb=norb, nelec=nelec, spin_shift=kwargs.get("spin_shift", 0.0),
        spin_target=kwargs.get("spin_target", 0.0), col_block=ham_j.col_block, device="cpu")
    return ham_j, ham_t


def _amplitudes(shape, m, n, seed=9):
    c = np.zeros(shape)
    c[:m, :n] = np.random.default_rng(seed).normal(size=(m, n))
    return c


def _close(out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * max(np.max(np.abs(ref)), 1.0)


@pytest.fixture(scope="module")
def strings():
    return _strings(NORB, 3, 14, 6), _strings(NORB, 2, 11, 7)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("spin", [(0.0, 0.0), (0.35, 2.0)], ids=["bare", "spin_penalty"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["two_pass", "beta_first"])
def test_blocked_variants_match(strings, variant, spin, dtype):
    """Ragged padding (15 x 13, N padded to 16 for col_block 4)."""
    h1, eri = _random_integrals(NORB, 5)
    ham_j, ham_t = _pair(NORB, NELEC, strings, h1, eri, pad_to=(15, 13), col_block=4,
                         spin_shift=spin[0], spin_target=spin[1])
    assert ham_j.shape == ham_t.shape == (15, 16) and ham_t.col_block == 4
    c = _amplitudes(ham_j.shape, *map(len, strings))
    if dtype == "f32":
        ham_j, ham_t = ham_j.astype(jnp.float32), ham_t.astype(torch.float32)
        c = c.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = getattr(ham_j, variant)(jnp.asarray(c))
    out = getattr(ham_t, variant)(torch.as_tensor(c))
    assert out.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    _close(out, ref, 1e-12 if dtype == "f64" else 1e-5)


@pytest.mark.parametrize("variant", VARIANTS, ids=["two_pass", "beta_first"])
def test_blocked_variants_through_factor_match(variant):
    """f32 blocked variants contract the exact integrals, ``sqd_tpu``'s the
    attached factor: the same operator."""
    norb, nelec = 8, (3, 3)
    h1, eri = _psd_integrals(norb, 10, seed=3)
    strs = (_strings(norb, 3, 20, 1), _strings(norb, 3, 17, 2))
    factor = jax_ham.pivoted_cholesky_pairs(eri, norb)
    ham_j, ham_t = _pair(norb, nelec, strs, h1, eri, col_block=8, eri_factor=factor)
    assert ham_t.eri_chol is not None
    ham_j, ham_t = ham_j.astype(jnp.float32), ham_t.astype(torch.float32)
    c = _amplitudes(ham_j.shape, *map(len, strs)).astype(np.float32)
    ref = getattr(ham_j, variant)(jnp.asarray(c))
    _close(getattr(ham_t, variant)(torch.as_tensor(c)), ref, 1e-5)


def test_blocked_dispatch_follows_the_g_buffer(strings, monkeypatch):
    """``matvec`` in f64 takes the two pass below ``TWO_PASS_G_BYTES`` and the
    beta-first pass above it, with ``sqd_tpu``'s result either way."""
    h1, eri = _random_integrals(NORB, 5)
    ham_j, _ = _pair(NORB, NELEC, strings, h1, eri, pad_to=(15, 13), col_block=4)
    pa, pb = (bitpack.pack_ints(s, NORB) for s in strings)
    ham_t = port_ham.build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, pad_to=(15, 13),
                                           col_block=4, device="cpu")
    c = _amplitudes(ham_j.shape, *map(len, strings))
    ref = ham_j.matvec(jnp.asarray(c))
    called = []
    for variant in VARIANTS:
        original = getattr(port_ham.SCIHamiltonian, variant)

        def spy(self, x, original=original, variant=variant):
            called.append(variant)
            return original(self, x)

        monkeypatch.setattr(port_ham.SCIHamiltonian, variant, spy)
    _close(ham_t.matvec(torch.as_tensor(c)), ref, 1e-12)
    monkeypatch.setattr(port_ham, "TWO_PASS_G_BYTES", 0)
    _close(ham_t.matvec(torch.as_tensor(c)), ref, 1e-12)
    assert called == list(VARIANTS)


@pytest.mark.parametrize("case", ["psd", "indefinite", "rank_cap"])
def test_pivoted_cholesky_pairs_matches(case):
    norb = 6
    if case == "indefinite":
        _, eri = _random_integrals(norb, 2)
    else:
        _, eri = _psd_integrals(norb, 9, seed=4)
    max_rank = 5 if case == "rank_cap" else None
    ref = jax_ham.pivoted_cholesky_pairs(eri, norb, max_rank=max_rank)
    out = port_ham.pivoted_cholesky_pairs(eri, norb, max_rank=max_rank)
    if case != "psd":
        assert ref is None and out is None
        return
    assert out.shape == ref.shape and out.shape[0] <= 9
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    v = eri.reshape(norb * norb, -1)
    np.testing.assert_allclose(out.T @ out, v, rtol=0, atol=1e-12)


def test_f32_matvec_full_matches():
    """The f32 ``_matvec_full`` (exact integrals) against ``sqd_tpu``'s,
    which contracts the attached factor, and against the kernel route."""
    norb, nelec = 10, (4, 3)
    h1, eri = _psd_integrals(norb, 12, seed=6)
    strs = (_strings(norb, 4, 24, 3), _strings(norb, 3, 19, 4))
    factor = jax_ham.pivoted_cholesky_pairs(eri, norb)
    ham_j, ham_t = _pair(norb, nelec, strs, h1, eri, eri_factor=factor,
                         spin_shift=0.2, spin_target=0.75)
    ham_j, ham_t = ham_j.astype(jnp.float32), ham_t.astype(torch.float32)
    c = _amplitudes(ham_j.shape, *map(len, strs)).astype(np.float32)
    ref = ham_j._matvec_full(jnp.asarray(c))
    out = ham_t._matvec_full(torch.as_tensor(c))
    _close(out, ref, 1e-5)
    _close(out, ham_t.matvec(torch.as_tensor(c)), 1e-5)


def test_auto_factor_matches_at_npair_above_256():
    """18 orbitals: npair 324 > 256, so ``"auto"`` factors in both packages."""
    norb, nelec = 18, (2, 2)
    h1, eri = _psd_integrals(norb, 30, seed=8)
    strs = (_strings(norb, 2, 12, 5), _strings(norb, 2, 10, 6))
    pa, pb = (bitpack.pack_ints(s, norb) for s in strs)
    ham_j = jax_ham.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec)
    ham_t = port_ham.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device="cpu")
    assert ham_j.eri_chol is not None and ham_t.eri_chol is not None
    np.testing.assert_allclose(ham_t.eri_chol.numpy(), np.asarray(ham_j.eri_chol),
                               rtol=0, atol=1e-12)
    off = port_ham.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device="cpu",
                                         eri_factor=None)
    assert off.eri_chol is None
    with pytest.raises(ValueError, match="eri_factor"):
        port_ham.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device="cpu",
                                       eri_factor=np.zeros((3, 5)))


# Each benchmark cell's operator: (npair, strings per spin, solve_sci's
# pad_to), and its layout (m_pad, n_pad, col_block) on the CPU, which is
# sqd_tpu's, and on a CUDA device, where no route reads a column block.
CELL_LAYOUTS = {
    "n2_631g.sqd_loop": ((256, 950, 950, (960, 960)), (960, 1024, 0), (960, 1024, 0)),
    "n2_631g.solve_1e6": ((256, 1000, 1000, (1024, 1024)), (1024, 1024, 0), (1024, 1024, 0)),
    "n2_631g.casci": ((256, 4368, 4368, (4384, 4384)), (4384, 4480, 128), (4384, 4480, 0)),
    "n2_ccpvdz.solve_1e6": ((676, 1000, 1000, (1024, 1024)), (1024, 1024, 128),
                            (1024, 1024, 0)),
    "fe4s4_class.solve_1e6": ((1296, 1000, 1000, (1024, 1024)), (1024, 1120, 112),
                              (1024, 1024, 0)),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("cell", sorted(CELL_LAYOUTS))
def test_padded_layout_by_device(cell, device):
    """``padded_layout`` is pure: a CUDA device needs no card.  On the CPU
    the block is ``sqd_tpu``'s ``_auto_col_block``; on a CUDA device none,
    with the 8/128 alignment kept; an explicit block is kept on both."""
    (npair, m, n, pad_to), cpu, cuda = CELL_LAYOUTS[cell]
    assert jax_ham._auto_col_block(npair, *pad_to) == cpu[2]
    got = port_ham.padded_layout(npair, m, n, pad_to, "auto", torch.device(device))
    assert got == (cpu if device == "cpu" else cuda)
    assert port_ham.padded_layout(npair, m, n, pad_to, 128, torch.device(device)) == (
        pad_to[0], -(-pad_to[1] // 128) * 128, 128)


def _counted_factors(monkeypatch):
    calls = []
    factor = port_ham.pivoted_cholesky_pairs

    def counted(*args, **kwargs):
        calls.append(1)
        return factor(*args, **kwargs)

    monkeypatch.setattr(port_ham, "pivoted_cholesky_pairs", counted)
    return calls


def _solvers():
    from sqd_tpu_torch import parallel

    f64 = {"solver_dtype": torch.float64, "device": "cpu"}
    return {
        "solve_sci_gather": (partial(fermion.solve_sci, **f64), 0),
        "solve_sci_dense_df": (partial(fermion.solve_sci, matvec_strategy="dense_df", **f64), 1),
        "solve_sci_excited": (partial(fermion.solve_sci_excited, k=2, device="cpu"), 0),
        "batch_sharded": (lambda s, *a: parallel.solve_sci_batch_sharded([s], *a, **f64), 0),
        "distributed": (partial(parallel.solve_sci_distributed, **f64), 0),
        "rowsharded": (partial(parallel.solve_sci_rowsharded, **f64), 0),
        "gridsharded": (partial(parallel.solve_sci_gridsharded, **f64), 0),
        "dfsharded": (partial(parallel.solve_sci_dfsharded, **f64), 1),
    }


@pytest.mark.parametrize("solver", ["solve_sci_gather", "solve_sci_dense_df", "solve_sci_excited",
                                    "batch_sharded", "distributed", "rowsharded",
                                    "gridsharded", "dfsharded"])
def test_pair_factor_only_for_its_readers(solver, monkeypatch):
    """At npair 324 > 256, where ``"auto"`` factors, the pair factor is
    computed once by the dense density-fitted solvers and never by the
    gather route's."""
    norb, nelec = 18, (2, 2)
    h1, eri = _psd_integrals(norb, 30, seed=8)
    strs = (_strings(norb, 2, 8, 5), _strings(norb, 2, 7, 6))
    solve, want = _solvers()[solver]
    calls = _counted_factors(monkeypatch)
    solve(strs, h1, eri, norb, nelec)
    assert len(calls) == want


@pytest.mark.parametrize("pad_to", [None, (16, 21)], ids=["unpadded", "padded"])
def test_device_diagonal_matches(strings, pad_to, monkeypatch):
    h1, eri = _random_integrals(NORB, 5)
    pa, pb = (bitpack.pack_ints(s, NORB) for s in strings)
    host = port_ham.build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, pad_to=pad_to,
                                          device="cpu")
    monkeypatch.setattr(jax_ham, "DEVICE_DIAG_MIN_ELEMS", 1)
    monkeypatch.setattr(port_ham, "DEVICE_DIAG_MIN_ELEMS", 1)
    ham_j = jax_ham.build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, pad_to=pad_to)
    ham_t = port_ham.build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, pad_to=pad_to,
                                           device="cpu")
    np.testing.assert_allclose(ham_t.hdiag.numpy(), np.asarray(ham_j.hdiag),
                               rtol=1e-12, atol=1e-12)
    m, n = map(len, strings)
    np.testing.assert_allclose(ham_t.hdiag.numpy()[:m, :n], host.hdiag.numpy()[:m, :n],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("algo", ["sparse", "auto"])
def test_sparse_samespin_tables_high_filling(algo):
    """20 orbitals, 6 electrons, 3000 strings: 3000 x 1450 candidates is past
    the 4M probes at which ``"auto"`` turns sparse."""
    norb, nelec = 20, 6
    h1, eri = _random_integrals(norb, 11)
    packed = bitpack.pack_ints(_strings(norb, nelec, 3000, 12), norb)
    assert len(packed) * native.samespin_width(norb, nelec) > 4_000_000
    ref = jax_native.samespin_tables(packed, h1, eri, norb, nelec, algo=algo)
    out = native.samespin_tables(packed, h1, eri, norb, nelec, algo=algo)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    for o, r in zip(out, native.samespin_tables(packed, h1, eri, norb, nelec, algo="enum")):
        np.testing.assert_array_equal(o, r)


def test_sparse_samespin_tables_multiword():
    """40 orbitals: two-word packed strings."""
    norb, nelec = 40, 4
    h1, eri = _random_integrals(norb, 13)
    rng = np.random.default_rng(14)
    occ = np.array(sorted({tuple(sorted(rng.choice(norb, nelec, replace=False)))
                           for _ in range(300)}))
    ints = np.array([sum(1 << int(p) for p in row) for row in occ], dtype=object)
    packed = bitpack.pack_ints(np.sort(ints), norb)
    assert packed.shape[1] == 2
    ref = jax_native.samespin_tables(packed, h1, eri, norb, nelec, algo="enum")
    for algo in ("sparse", "enum"):
        out = native.samespin_tables(packed, h1, eri, norb, nelec, algo=algo)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)
    with pytest.raises(ValueError, match="algo"):
        native.samespin_tables(packed, h1, eri, norb, nelec, algo="dense")


def test_table_cache_skips_wide_candidate_sets():
    """28 orbitals, 7 electrons: 4558 candidates per string, past the cache's
    4096, so the build takes the direct native tables."""
    from sqd_tpu_torch.ops.table_cache import TableCache

    norb, nelec = 28, (7, 7)
    h1, eri = _random_integrals(norb, 15)
    rng = np.random.default_rng(16)
    strs = np.unique([sum(1 << int(p) for p in rng.choice(norb, 7, replace=False))
                      for _ in range(12)])
    packed = bitpack.pack_ints(strs, norb)
    cache = TableCache()
    ham = port_ham.build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device="cpu",
                                         table_cache=cache, eri_factor=None)
    assert native.samespin_width(norb, 7) == 4558
    assert cache.native_rows_computed == 0
    ref = jax_ham.build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, eri_factor=None)
    np.testing.assert_array_equal(ham.nbr_idx_a.numpy(), np.asarray(ref.nbr_idx_a))
    np.testing.assert_array_equal(ham.nbr_val_a.numpy(), np.asarray(ref.nbr_val_a))


@pytest.mark.parametrize("col_block", [None, 8], ids=["unblocked", "forced_col_block"])
def test_solve_sci_with_auto_factor_matches(col_block, monkeypatch):
    """``solve_sci`` at 18 orbitals (npair 324, so ``"auto"`` factors), with
    and without a column block forced on both packages."""
    norb, nelec = 18, (2, 2)
    h1, eri = _psd_integrals(norb, 30, seed=17)
    strs = (_strings(norb, 2, 30, 18), _strings(norb, 2, 27, 19))
    if col_block:
        monkeypatch.setattr(jax_ham, "_auto_col_block", lambda *args: col_block)
        monkeypatch.setattr(port_ham, "_auto_col_block", lambda *args: col_block)
    ref = jax_fermion.solve_sci(strs, h1, eri, norb, nelec, tol=1e-10)
    out = fermion.solve_sci(strs, h1, eri, norb, nelec, tol=1e-10, device="cpu")
    assert abs(out.energy - ref.energy) <= 1e-9
    np.testing.assert_allclose(out.rdm1, ref.rdm1, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk_bytes", [1, 4096], ids=["one_line", "a_few_lines"])
def test_chunked_gathers_match(strings, chunk_bytes, monkeypatch):
    """The same-spin channels in column/row chunks and the plain cross-spin
    version in alpha-row chunks give ``sqd_tpu``'s results (torch
    materialises the gathers that XLA fuses, so large shapes take chunks)."""
    from sqd_tpu_torch.ops import cross_spin

    h1, eri = _random_integrals(NORB, 5)
    ham_j, ham_t = _pair(NORB, NELEC, strings, h1, eri, pad_to=(15, 13),
                         spin_shift=0.35, spin_target=2.0)
    c = _amplitudes(ham_j.shape, *map(len, strings))
    monkeypatch.setattr(port_ham, "SAMESPIN_CHUNK_BYTES", chunk_bytes)
    monkeypatch.setattr(cross_spin, "PLAIN_CHUNK_BYTES", chunk_bytes)
    for name in ("apply_samespin_alpha", "apply_samespin_beta"):
        _close(getattr(ham_t, name)(torch.as_tensor(c)), getattr(ham_j, name)(jnp.asarray(c)),
               1e-12)
    _close(ham_t._matvec_full(torch.as_tensor(c)), ham_j._matvec_full(jnp.asarray(c)), 1e-12)
    ham32 = ham_t.astype(torch.float32)
    c32 = c.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = ham_j.astype(jnp.float32)._matvec_full(jnp.asarray(c32))
    _close(ham32.matvec(torch.as_tensor(c32)), ref, 1e-5)
