# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's device table builds (``tables_backend="device"``) against
``sqd_tpu``'s and against the port's native build.

Tolerances: gather ``sign`` exactly, ``src`` exactly where ``sign != 0``
(``sqd_tpu`` leaves an invalid source unclamped, the port clamps it to 0);
same-spin ``idx`` bit for bit and ``val`` within 1e-14 (the same
Slater-Condon terms; the mean-field matmul and the diagonal's einsum may
round in another order); operators built by both backends: every table equal
and one f64 matvec within 1e-11.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.ops import hamiltonian as jax_hamiltonian
from sqd_tpu.ops import linktab as jax_linktab
from sqd_tpu.ops.dense_fci import all_hamming_strings

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import native
from sqd_tpu_torch.ops import bitpack, hamiltonian, linktab

torch.set_num_threads(2)

TOL_VAL = 1e-14
TOL_MATVEC = 1e-11


def _integrals(norb, seed, rank=8):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(rank, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    return h1, np.einsum("xpq,xrs->pqrs", chol, chol)


def _strings(norb, nelec, count, seed):
    """``count`` sorted unique packed strings of weight ``nelec`` (at most all)."""
    rng = np.random.default_rng(seed)
    if norb <= 12:
        pool = all_hamming_strings(norb, nelec)
        ints = np.sort(rng.choice(pool, min(count, len(pool)), replace=False))
    else:
        chosen = set()
        while len(chosen) < count:
            chosen.add(sum(1 << int(b) for b in rng.choice(norb, nelec, replace=False)))
        ints = np.array(sorted(chosen), dtype=object)
    return bitpack.pack_ints(ints, norb)


@pytest.mark.parametrize("nbits", [20, 32, 33, 64])
def test_int64_key_search_matches_host_search(nbits):
    """The one-``torch.searchsorted`` path of rows up to two words, over the
    whole unsigned range (top bits set), against the host search."""
    rng = np.random.default_rng(nbits)
    w = bitpack.num_words(nbits)
    rows = rng.integers(0, 2**32, (500, w), dtype=np.uint64).astype(np.uint32)
    if nbits % 32:
        rows[:, -1] &= np.uint32((1 << (nbits % 32)) - 1)
    sp = bitpack.unique_packed(rows)
    queries = np.vstack([sp[::4], rows[:50] ^ np.uint32(1), np.zeros((1, w), np.uint32),
                         np.full((1, w), 0xFFFFFFFF, np.uint32)])
    t_sp, t_q = (bitpack.to_device_words(x, "cpu") for x in (sp, queries))
    want = bitpack.searchsorted_packed(sp, queries)
    np.testing.assert_array_equal(bitpack.torch_searchsorted_packed(t_sp, t_q).numpy(), want)
    np.testing.assert_array_equal(bitpack._searchsorted_words(t_sp, t_q).numpy(), want)
    np.testing.assert_array_equal(bitpack.torch_find_packed(t_sp, t_q).numpy(),
                                  bitpack.find_packed(sp, queries))


# (norb, nelec, strings, pairs per batch or None): one- and two-word strings
GATHER_CASES = {
    "one_word": (6, 3, 14, None),
    "one_word_full": (6, 2, 15, None),
    "two_words": (36, 4, 50, None),
    "ragged_batches": (36, 2, 40, 7),
    "empty": (6, 3, 0, None),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_tables_match_sqd_tpu(case, monkeypatch):
    norb, nelec, count, pairs_per_batch = GATHER_CASES[case]
    packed = _strings(norb, nelec, count, seed=norb + count)
    n, w = packed.shape
    if pairs_per_batch is not None:
        monkeypatch.setattr(linktab, "GATHER_BATCH_BYTES", pairs_per_batch * n * (6 + 3 * w) * 8)
    src, sign = linktab.build_gather_tables(packed, norb, device="cpu")
    assert src.dtype == torch.int64 and sign.dtype == torch.int8
    assert src.shape == sign.shape == (norb * norb, n)
    src_n, sign_n = native.gather_tables(packed, norb)
    np.testing.assert_array_equal(src.numpy(), src_n)
    np.testing.assert_array_equal(sign.numpy(), sign_n)
    if n == 0:
        return
    src_j, sign_j = (np.asarray(t) for t in jax_linktab.build_gather_tables(
        jnp.asarray(packed), norb))
    np.testing.assert_array_equal(sign.numpy(), sign_j)
    np.testing.assert_array_equal(src.numpy()[sign_j != 0], src_j[sign_j != 0])
    assert not src.numpy()[sign_j == 0].any()
    assert np.count_nonzero(sign_j) > n  # more than the diagonal pairs


# (norb, nelec_spin, strings, rows per chunk or None)
SAMESPIN_CASES = {
    "norb6_n1": (6, 1, 6, None),
    "norb6_n2": (6, 2, 12, None),
    "norb6_n3": (6, 3, 20, None),
    "norb6_n3_chunks": (6, 3, 20, 3),
    "norb36_n1": (36, 1, 30, None),
    "norb36_n2": (36, 2, 45, None),
    "norb36_n3": (36, 3, 60, None),
    "norb36_n3_chunks": (36, 3, 60, 7),
}


@pytest.mark.parametrize("case", list(SAMESPIN_CASES))
def test_samespin_tables_match_sqd_tpu(case, monkeypatch):
    norb, nelec, count, rows_per_chunk = SAMESPIN_CASES[case]
    packed = _strings(norb, nelec, count, seed=3 * norb + nelec)
    h1, eri = _integrals(norb, seed=nelec)
    if rows_per_chunk is not None:
        per_row = native.samespin_width(norb, nelec) * (12 + 6 * packed.shape[1]) * 8
        monkeypatch.setattr(hamiltonian, "SAMESPIN_BUILD_BYTES", rows_per_chunk * per_row)
    idx, val = hamiltonian.build_samespin_tables(packed, h1, eri, norb, nelec, device="cpu")
    idx_j, val_j = (np.asarray(t) for t in jax_hamiltonian.build_samespin_tables(
        packed, jnp.asarray(h1), jnp.asarray(eri), norb, nelec))
    assert idx.dtype == torch.int64 and val.dtype == torch.float64
    assert idx.shape == idx_j.shape
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_allclose(val.numpy(), val_j, rtol=0, atol=TOL_VAL)
    # invalid slots: index 0, value 0; every row holds its diagonal first
    np.testing.assert_array_equal(idx.numpy()[:, 0], np.arange(len(packed)))
    assert not idx.numpy()[val.numpy() == 0].any()


def test_samespin_tables_chunks_equal_one_pass(monkeypatch):
    """Chunks of one row at a time give the one-pass tables bit for bit,
    including rows whose valid count is below the widest row's."""
    norb, nelec = 10, 3
    packed = _strings(norb, nelec, 40, seed=5)
    h1, eri = _integrals(norb, seed=6)
    whole = hamiltonian.build_samespin_tables(packed, h1, eri, norb, nelec, device="cpu")
    monkeypatch.setattr(hamiltonian, "SAMESPIN_BUILD_BYTES", 1)
    rows = hamiltonian.build_samespin_tables(packed, h1, eri, norb, nelec, device="cpu")
    for a, b in zip(whole, rows):
        assert torch.equal(a, b)
    counts = (whole[1] != 0).sum(dim=1)
    assert int(counts.min()) < int(counts.max())


def test_samespin_tables_edges():
    """No doubles with one electron or one hole; an empty set gives empty
    tables of the bucket width; f32 integrals give f32 values."""
    norb = 6
    h1, eri = _integrals(norb, seed=9)
    for nelec in (1, 5):
        packed = _strings(norb, nelec, 6, seed=nelec)
        idx, val = hamiltonian.build_samespin_tables(packed, h1, eri, norb, nelec, device="cpu")
        assert idx.shape[1] == native.samespin_width(norb, nelec) == 6
    empty = np.zeros((0, 1), dtype=np.uint32)
    idx, val = hamiltonian.build_samespin_tables(empty, h1, eri, norb, 3, device="cpu")
    assert idx.shape == val.shape == (0, 8)
    packed = _strings(norb, 3, 20, seed=2)
    idx32, val32 = hamiltonian.build_samespin_tables(
        packed, torch.as_tensor(h1, dtype=torch.float32), torch.as_tensor(eri, dtype=torch.float32),
        norb, 3, device="cpu")
    idx64, val64 = hamiltonian.build_samespin_tables(packed, h1, eri, norb, 3, device="cpu")
    assert val32.dtype == torch.float32
    assert torch.equal(idx32, idx64)
    np.testing.assert_allclose(val32.numpy(), val64.numpy(), rtol=0, atol=1e-5)


TABLES = ("src_a", "sign_a", "src_b", "sign_b", "nbr_idx_a", "nbr_val_a", "nbr_idx_b",
          "nbr_val_b", "eri_t", "hdiag")
# (norb, nelec, strings per spin, pad_to, device diagonal, spin shift)
BACKEND_CASES = {
    "open_shell": (8, (3, 2), (30, 20), None, False, 0.0),
    "pad_to": (8, (3, 3), (25, 28), (30, 33), False, 0.0),
    "device_diagonal": (8, (3, 3), (40, 40), (43, 45), True, 0.0),
    "two_words_spin_penalty": (34, (2, 2), (30, 24), None, False, 0.4),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_device_backend_equals_native(case, monkeypatch):
    norb, nelec, counts, pad_to, device_diag, shift = BACKEND_CASES[case]
    pa = _strings(norb, nelec[0], counts[0], seed=11)
    pb = _strings(norb, nelec[1], counts[1], seed=12)
    h1, eri = _integrals(norb, seed=13)
    if device_diag:
        for module in (hamiltonian, jax_hamiltonian):
            monkeypatch.setattr(module, "DEVICE_DIAG_MIN_ELEMS", 1000)
    kwargs = {"pad_to": pad_to, "spin_shift": shift, "spin_target": 0.0}
    ham = {backend: hamiltonian.build_sci_hamiltonian(
        pa, pb, h1, eri, norb, nelec, device="cpu", tables_backend=backend, **kwargs)
        for backend in ("native", "device", "auto")}
    for name in TABLES:
        assert getattr(ham["device"], name).dtype == getattr(ham["native"], name).dtype
        for backend in ("device", "auto"):
            torch.testing.assert_close(getattr(ham[backend], name), getattr(ham["native"], name),
                                       rtol=0, atol=TOL_VAL)
    assert ham["device"].shape == (pad_to or counts)
    c = torch.as_tensor(np.random.default_rng(14).normal(size=ham["native"].shape))
    torch.testing.assert_close(ham["device"].matvec(c), ham["native"].matvec(c),
                               rtol=0, atol=TOL_MATVEC)
    # and against sqd_tpu's own device build: the same tables
    ref = jax_hamiltonian.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec,
                                                tables_backend="device", **kwargs)
    for spin in "ab":
        sign = np.asarray(getattr(ref, f"sign_{spin}"))
        np.testing.assert_array_equal(getattr(ham["device"], f"sign_{spin}").numpy(), sign)
        np.testing.assert_array_equal(getattr(ham["device"], f"src_{spin}").numpy()[sign != 0],
                                      np.asarray(getattr(ref, f"src_{spin}"))[sign != 0])
        np.testing.assert_array_equal(getattr(ham["device"], f"nbr_idx_{spin}").numpy(),
                                      np.asarray(getattr(ref, f"nbr_idx_{spin}")))
    np.testing.assert_allclose(ham["device"].matvec(c).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(c.numpy()))),
                               rtol=0, atol=TOL_MATVEC)


def test_device_backend_f32_values_in_f32():
    """``dtype=float32``: the device build computes the same-spin values in
    f32 (as ``sqd_tpu``), the native one in f64 and casts."""
    norb, nelec = 8, (3, 3)
    pa = _strings(norb, 3, 30, seed=21)
    h1, eri = _integrals(norb, seed=22)
    dev, nat = (hamiltonian.build_sci_hamiltonian(
        pa, pa, h1, eri, norb, nelec, device="cpu", dtype=torch.float32, tables_backend=b)
        for b in ("device", "native"))
    ref = jax_hamiltonian.build_sci_hamiltonian(pa, pa, h1, eri, norb, nelec,
                                                dtype=jnp.float32, tables_backend="device")
    assert dev.nbr_val_a.dtype == torch.float32
    assert torch.equal(dev.nbr_idx_a, nat.nbr_idx_a)
    np.testing.assert_allclose(dev.nbr_val_a.numpy(), nat.nbr_val_a.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev.nbr_val_a.numpy(), np.asarray(ref.nbr_val_a),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "native", "device", "anything_else"])
def test_build_sci_basis_backends(backend):
    """``build_sci_basis`` takes ``sqd_tpu``'s meanings: ``"auto"`` and
    ``"native"`` build on the host, any other value on the device."""
    norb = 7
    pa, pb = _strings(norb, 3, 25, seed=31), _strings(norb, 2, 15, seed=32)
    basis = hamiltonian.build_sci_basis(pa, pb, norb, (3, 2), device="cpu",
                                        tables_backend=backend)
    want = hamiltonian.build_sci_basis(pa, pb, norb, (3, 2), device="cpu",
                                       tables_backend="native")
    for name in ("src_a", "sign_a", "src_b", "sign_b"):
        assert torch.equal(getattr(basis, name), getattr(want, name))
    c = torch.as_tensor(np.random.default_rng(3).normal(size=basis.shape))
    ref = jax_hamiltonian.build_sci_basis(pa, pb, norb, (3, 2), tables_backend="device")
    assert abs(float(basis.spin_square(c)) - float(ref.spin_square(jnp.asarray(c.numpy())))) < 1e-12


def test_unknown_tables_backend_raises():
    pa = _strings(4, 2, 4, seed=1)
    with pytest.raises(ValueError, match="unknown tables_backend"):
        hamiltonian.build_sci_hamiltonian(pa, pa, np.eye(4), np.zeros((4,) * 4), 4, (2, 2),
                                          device="cpu", tables_backend="numpy")


@pytest.mark.parametrize("spin", [(0.0, 0.0), (0.35, 2.0)], ids=["bare", "spin_penalty"])
def test_converted_device_built_operator_matches(spin):
    """An ``sqd_tpu`` operator built with ``tables_backend="device"`` (invalid
    gather sources left at -1) converts, and the port's f64 and f32 matvecs
    equal ``sqd_tpu``'s within 1e-12 and 1e-5 of ``max(|sigma|, 1)``."""
    from sqd_tpu_torch.convert import FIELDS, hamiltonian_from_numpy

    norb, nelec = 7, (3, 2)
    h1, eri = _integrals(norb, seed=41)
    pa, pb = _strings(norb, 3, 27, seed=42), _strings(norb, 2, 17, seed=43)
    ham_j = jax_hamiltonian.build_sci_hamiltonian(
        pa, pb, h1, eri, norb, nelec, pad_to=(32, 24), tables_backend="device",
        spin_shift=spin[0], spin_target=spin[1])
    assert int(np.asarray(ham_j.src_a).min()) < 0  # the unclamped sources this converts
    ham_t = hamiltonian_from_numpy(
        {k: np.asarray(getattr(ham_j, k)) for k in FIELDS}, norb=norb, nelec=nelec,
        spin_shift=spin[0], spin_target=spin[1], device="cpu")
    assert int(ham_t.src_a.min()) == 0 and int(ham_t.src_b.min()) == 0
    c = np.zeros(ham_j.shape)
    c[:27, :17] = np.random.default_rng(44).normal(size=(27, 17))
    for dtype, jdtype, tol in ((torch.float64, jnp.float64, 1e-12),
                               (torch.float32, jnp.float32, 1e-5)):
        ref = np.asarray(ham_j.astype(jdtype).matvec(jnp.asarray(c, jdtype)), np.float64)
        out = ham_t.astype(dtype).matvec(torch.as_tensor(c, dtype=dtype)).double().numpy()
        assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1.0)
