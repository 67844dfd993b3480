# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's ``TableCache``: the same tables as the direct build, reuse of
rows across overlapping string sets, and refusal of other integrals.

Held against the port's direct native build bit for bit, and against
``sqd_tpu``'s own table builders (``ops.linktab.build_gather_tables`` and
``ops.hamiltonian.build_samespin_tables``, through ``tables_backend="device"``).
Not against ``sqd_tpu.native``, whose build may lose a race between test
workers.
"""

import numpy as np
import pytest
import torch

from sqd_tpu.fermion import solve_sci as jax_solve_sci
from sqd_tpu.ops import dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian as jax_build

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion, native
from sqd_tpu_torch.ops import bitpack
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
from sqd_tpu_torch.ops.table_cache import TableCache

torch.set_num_threads(2)

NORB, NE = 8, 3


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    h1 = rng.normal(size=(NORB, NORB))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(16, NORB, NORB)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    return h1, eri, dense_fci.all_hamming_strings(NORB, NE)


def _pick(all_strs, seed, n):
    return np.sort(np.random.default_rng(seed).choice(all_strs, n, replace=False))


def _assert_tables_equal(cache, packed, h1, eri):
    for ours, ref in zip(cache.gather_tables(packed, NORB), native.gather_tables(packed, NORB)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(cache.samespin_tables(packed, h1, eri, NORB, NE),
                         native.samespin_tables(packed, h1, eri, NORB, NE)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_cached_tables_equal_direct_build_across_overlapping_sets(system):
    h1, eri, all_strs = system
    first = _pick(all_strs, 1, 40)
    cache = TableCache()
    _assert_tables_equal(cache, bitpack.pack_ints(first, NORB), h1, eri)
    assert cache.native_rows_computed == 2 * 40  # one gather + one same-spin row per string
    _assert_tables_equal(cache, bitpack.pack_ints(first, NORB), h1, eri)
    assert cache.native_rows_computed == 2 * 40  # the same set again: nothing new
    # a 75 % overlapping set: native work for the new quarter only
    extra = np.setdiff1d(all_strs, first)
    second = np.sort(np.concatenate([first[:30], _pick(extra, 3, 10)]))
    _assert_tables_equal(cache, bitpack.pack_ints(second, NORB), h1, eri)
    assert cache.native_rows_computed == 2 * 50


@pytest.mark.parametrize("seed", [2, 4])
def test_cached_operator_equals_sqd_tpu_builders(system, seed):
    """Index tables bit for bit; matrix elements to 1e-14 (``sqd_tpu``'s jnp
    builder sums the Slater-Condon terms in another order)."""
    h1, eri, _ = system
    sa = _pick(dense_fci.all_hamming_strings(NORB, 3), seed, 30)
    sb = _pick(dense_fci.all_hamming_strings(NORB, 2), seed + 1, 20)
    pa, pb = bitpack.pack_ints(sa, NORB), bitpack.pack_ints(sb, NORB)
    ref = jax_build(pa, pb, h1, eri, NORB, (3, 2), tables_backend="device")
    cache = TableCache()
    for _ in range(2):  # cold, then every row from the cache
        ham = build_sci_hamiltonian(pa, pb, h1, eri, NORB, (3, 2), device="cpu",
                                    table_cache=cache)
        direct = build_sci_hamiltonian(pa, pb, h1, eri, NORB, (3, 2), device="cpu")
        for name in ("src_a", "sign_a", "src_b", "sign_b", "nbr_idx_a", "nbr_idx_b",
                     "nbr_val_a", "nbr_val_b", "hdiag"):
            torch.testing.assert_close(getattr(ham, name), getattr(direct, name), rtol=0, atol=0)
        for spin in "ab":
            sign = np.asarray(getattr(ref, f"sign_{spin}"))
            np.testing.assert_array_equal(getattr(ham, f"sign_{spin}").numpy(), sign)
            # sqd_tpu's device tables leave the source of an invalid entry unclamped
            src = np.asarray(getattr(ref, f"src_{spin}"))
            np.testing.assert_array_equal(getattr(ham, f"src_{spin}").numpy()[sign != 0],
                                          src[sign != 0])
            np.testing.assert_array_equal(getattr(ham, f"nbr_idx_{spin}").numpy(),
                                          np.asarray(getattr(ref, f"nbr_idx_{spin}")))
            np.testing.assert_allclose(getattr(ham, f"nbr_val_{spin}").numpy(),
                                       np.asarray(getattr(ref, f"nbr_val_{spin}")),
                                       rtol=0, atol=1e-14)
    assert cache.native_rows_computed == 2 * (30 + 20)


def test_cache_rejects_other_integrals(system):
    h1, eri, all_strs = system
    packed = bitpack.pack_ints(_pick(all_strs, 4, 10), NORB)
    cache = TableCache()
    cache.samespin_tables(packed, h1, eri, NORB, NE)
    with pytest.raises(ValueError, match="different integrals"):
        cache.samespin_tables(packed, h1 * 1.5, eri, NORB, NE)


def test_solve_sci_with_cache_matches_without(system):
    h1, eri, all_strs = system
    sel = _pick(all_strs, 5, 20)
    cache = TableCache()
    with_cache = fermion.solve_sci((sel, sel), h1, eri, NORB, (NE, NE), table_cache=cache,
                                   device="cpu")
    again = fermion.solve_sci((sel, sel), h1, eri, NORB, (NE, NE), table_cache=cache,
                              device="cpu")
    without = fermion.solve_sci((sel, sel), h1, eri, NORB, (NE, NE), device="cpu")
    ref = jax_solve_sci((sel, sel), h1, eri, NORB, (NE, NE))
    assert cache.native_rows_computed == 2 * 20  # alpha and beta share the rows
    for res in (with_cache, again):
        assert res.energy == without.energy
        np.testing.assert_array_equal(res.sci_state.amplitudes, without.sci_state.amplitudes)
    assert abs(with_cache.energy - ref.energy) < 1e-8
