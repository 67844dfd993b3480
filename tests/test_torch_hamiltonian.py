# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's operator build and f64 matvec against ``sqd_tpu`` on the CPU.

Integer tables must be equal; values agree to 1e-12 relative; the f64 matvec
to ``1e-12 * scale`` (f64 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu import native as jax_native
from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian as jax_build
from sqd_tpu.ops.hamiltonian import expectation_value as jax_expectation

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import native
from sqd_tpu_torch.convert import FIELDS, hamiltonian_from_numpy
from sqd_tpu_torch.ops import bitpack as port_bitpack
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian, expectation_value

torch.set_num_threads(2)

NORB, NELEC = 6, (3, 2)
INDEX_TABLES = ("src_a", "sign_a", "src_b", "sign_b", "nbr_idx_a", "nbr_idx_b")
VALUE_TABLES = ("nbr_val_a", "nbr_val_b", "eri_t", "hdiag")


def _integrals(norb, seed):
    rng = np.random.default_rng(seed)
    h1, eri = hubbard_integrals(norb, u=3.0)
    a = rng.normal(size=(norb, norb))
    e = rng.normal(size=(norb,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    return h1 + 0.05 * (a + a.T), eri + 0.01 * e


@pytest.fixture(scope="module")
def problem():
    h1, eri = _integrals(NORB, seed=5)
    rng = np.random.default_rng(6)
    sa = np.sort(rng.choice(dense_fci.all_hamming_strings(NORB, 3), 14, replace=False))
    sb = np.sort(rng.choice(dense_fci.all_hamming_strings(NORB, 2), 11, replace=False))
    return sa, sb, h1, eri


def _packed(strs):
    return bitpack.pack_ints(strs, NORB)


@pytest.mark.parametrize("pad_to", [None, (16, 16)], ids=["unpadded", "padded"])
def test_tables_match(problem, pad_to):
    sa, sb, h1, eri = problem
    ham_j = jax_build(_packed(sa), _packed(sb), h1, eri, NORB, NELEC, pad_to=pad_to)
    ham_t = build_sci_hamiltonian(_packed(sa), _packed(sb), h1, eri, NORB, NELEC,
                                  pad_to=pad_to, device="cpu")
    assert ham_t.shape == ham_j.shape
    for name in INDEX_TABLES:
        ours, ref = getattr(ham_t, name).numpy(), np.asarray(getattr(ham_j, name))
        np.testing.assert_array_equal(ours, ref)
    assert ham_t.src_a.dtype == torch.int64 and ham_t.sign_a.dtype == torch.int8
    for name in VALUE_TABLES:
        ref = np.asarray(getattr(ham_j, name))
        np.testing.assert_allclose(getattr(ham_t, name).numpy(), ref, rtol=1e-12, atol=0)


def _ham_pair(problem, *, pad_to=(16, 16), spin_shift=0.0, spin_target=0.0):
    sa, sb, h1, eri = problem
    ham_j = jax_build(_packed(sa), _packed(sb), h1, eri, NORB, NELEC, pad_to=pad_to,
                      spin_shift=spin_shift, spin_target=spin_target)
    ham_t = build_sci_hamiltonian(_packed(sa), _packed(sb), h1, eri, NORB, NELEC, pad_to=pad_to,
                                  spin_shift=spin_shift, spin_target=spin_target, device="cpu")
    c = np.zeros(ham_j.shape)
    c[: len(sa), : len(sb)] = np.random.default_rng(9).normal(size=(len(sa), len(sb)))
    return ham_j, ham_t, c


def _close64(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-12 * max(np.max(np.abs(ref)), 1.0)


@pytest.mark.parametrize("spin", [(0.0, 0.0), (0.35, 2.0)], ids=["bare", "spin_penalty"])
def test_f64_matvec_matches(problem, spin):
    ham_j, ham_t, c = _ham_pair(problem, spin_shift=spin[0], spin_target=spin[1])
    ref = ham_j.matvec(jnp.asarray(c))
    _close64(ham_t.matvec(torch.as_tensor(c)), ref)
    converted = hamiltonian_from_numpy(
        {k: np.asarray(getattr(ham_j, k)) for k in FIELDS}, norb=NORB, nelec=NELEC,
        spin_shift=spin[0], spin_target=spin[1], device="cpu",
    )
    _close64(converted.matvec(torch.as_tensor(c)), ref)


def test_f64_matvec_matches_dense_fci():
    """Full small CAS: the port's matvec equals the dense Hamiltonian's."""
    norb, nelec = 5, (2, 2)
    h1, eri = _integrals(norb, seed=7)
    strs = dense_fci.all_hamming_strings(norb, 2)
    packed = bitpack.pack_ints(strs, norb)
    ham_t = build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device="cpu")
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    c = np.random.default_rng(2).normal(size=(len(strs), len(strs)))
    out = ham_t.matvec(torch.as_tensor(c)).numpy().reshape(-1)
    _close64(out, h_dense @ c.reshape(-1))
    np.testing.assert_allclose(ham_t.hdiag.numpy().reshape(-1), np.diag(h_dense), atol=1e-12)


@pytest.mark.parametrize("spin_penalty", [True, False])
def test_expectation_value_matches(problem, spin_penalty):
    ham_j, ham_t, c = _ham_pair(problem, spin_shift=0.35, spin_target=2.0)
    ref = float(jax_expectation(ham_j, jnp.asarray(c).reshape(-1), spin_penalty=spin_penalty))
    out = expectation_value(ham_t, torch.as_tensor(c).reshape(-1), spin_penalty=spin_penalty)
    assert abs(out - ref) <= 1e-12 * max(abs(ref), 1.0)


def test_spin_square_matches(problem):
    ham_j, ham_t, c = _ham_pair(problem)
    ref = float(ham_j.spin_square(jnp.asarray(c)))
    assert abs(float(ham_t.spin_square(torch.as_tensor(c))) - ref) < 1e-12


def test_gather_scatter_blocks_match(problem):
    ham_j, ham_t, c = _ham_pair(problem)
    cj, ct = jnp.asarray(c), torch.as_tensor(c)
    g = np.random.default_rng(1).normal(size=(NORB * NORB, *c.shape))
    for name, arg_j, arg_t in (
        ("gather_alpha", cj, ct),
        ("gather_beta", cj, ct),
        ("scatter_alpha", jnp.asarray(g), torch.as_tensor(g)),
        ("scatter_beta", jnp.asarray(g), torch.as_tensor(g)),
    ):
        ref = np.asarray(getattr(ham_j, name)(arg_j))
        np.testing.assert_allclose(getattr(ham_t, name)(arg_t).numpy(), ref, rtol=0, atol=1e-12)


def test_native_bindings_match(problem):
    sa, sb, h1, eri = problem
    pa = _packed(sa)
    for ours, theirs in zip(native.gather_tables(pa, NORB), jax_native.gather_tables(pa, NORB)):
        np.testing.assert_array_equal(ours, theirs)
    for ours, theirs in zip(
        native.samespin_tables(pa, h1, eri, NORB, 3),
        jax_native.samespin_tables(pa, h1, eri, NORB, 3, algo="enum"),
    ):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(native.desdes_unique(pa, 3), jax_native.desdes_unique(pa, 3))
    np.testing.assert_array_equal(native.popcount_rows(pa), jax_native.popcount_rows(pa))


def test_bitpack_host_half_matches():
    rng = np.random.default_rng(4)
    ints = np.unique(rng.integers(0, 1 << 40, size=50))
    for nbits in (40, 70):
        vals = ints if nbits < 63 else np.array([int(x) << 25 for x in ints], dtype=object)
        packed = port_bitpack.pack_ints(vals, nbits)
        np.testing.assert_array_equal(packed, bitpack.pack_ints(vals, nbits))
        np.testing.assert_array_equal(
            port_bitpack.unpack_to_ints(packed, nbits), bitpack.unpack_to_ints(packed, nbits)
        )
        queries = np.concatenate([packed[::3], packed[:4] ^ np.uint32(1)])
        np.testing.assert_array_equal(
            port_bitpack.find_packed(packed, queries), bitpack.find_packed(packed, queries)
        )
    np.testing.assert_array_equal(port_bitpack.prefix_masks(40), bitpack.prefix_masks(40))
    np.testing.assert_array_equal(port_bitpack.bit_masks(40), bitpack.bit_masks(40))


def test_large_shape_options_match(problem):
    """The three options that raised before they were ported now give
    ``sqd_tpu``'s result: an explicit ``eri_factor`` (attached as given, and
    what the dense density-fitted operator contracts: its W stack 1e-12), an
    f64 matvec with ``col_block > 0`` (1e-12) and the ``"sparse"`` same-spin
    tables past 4M probes (bit for bit)."""
    from sqd_tpu.ops import dense_df as jax_dense_df
    from sqd_tpu_torch.ops import dense_df

    sa, sb, h1, eri = problem
    pa, pb = _packed(sa), _packed(sb)
    factor = np.eye(NORB * NORB)
    ham_j = jax_build(pa, pb, h1, eri, NORB, NELEC, eri_factor=factor)
    ham_t = build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, device="cpu", eri_factor=factor)
    np.testing.assert_array_equal(ham_t.eri_chol.numpy(), np.asarray(ham_j.eri_chol))
    # the identity "factor" is not the integrals' own: the W stack shows it was read
    op = dense_df.densify(ham_t, dtype=torch.float64)
    op_j = jax_dense_df.densify(ham_j, dtype=jnp.float64)
    assert op.wa.shape[0] == NORB * NORB
    np.testing.assert_allclose(op.wa.numpy(), np.asarray(op_j.wa), rtol=0, atol=1e-12)

    blocked_j = jax_build(pa, pb, h1, eri, NORB, NELEC, col_block=4)
    blocked = build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, device="cpu", col_block=4)
    assert blocked.col_block == 4 and blocked.shape == blocked_j.shape == (14, 12)
    c = np.random.default_rng(4).normal(size=blocked.shape)
    _close64(blocked.matvec(torch.as_tensor(c)), blocked_j.matvec(jnp.asarray(c)))

    # 3000 strings x 1450 candidates (20 orbitals, 6 electrons) is past 4M probes
    rng = np.random.default_rng(5)
    strs = np.sort(rng.choice(dense_fci.all_hamming_strings(20, 6), 3000, replace=False))
    packed = bitpack.pack_ints(strs, 20)
    h1_20, eri_20 = _integrals(20, seed=6)
    for ours, theirs in zip(native.samespin_tables(packed, h1_20, eri_20, 20, 6),
                            jax_native.samespin_tables(packed, h1_20, eri_20, 20, 6)):
        np.testing.assert_array_equal(ours, theirs)
