# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's RDMs and RDM energy against ``sqd_tpu`` (``<= 1e-10`` absolute),
unblocked and with blocking forced (``block_bytes=0``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.ops import bitpack, dense_fci, linktab as jax_linktab
from sqd_tpu.ops import rdm as jax_rdm
from sqd_tpu.ops.hamiltonian import build_sci_basis as jax_basis

from sqd_tpu_torch.ops import linktab, rdm
from sqd_tpu_torch.ops.hamiltonian import build_sci_basis

torch.set_num_threads(2)

NORB, NELEC = 6, (3, 3)
TOL = 1e-10


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(17)
    allstr = dense_fci.all_hamming_strings(NORB, 3)
    sa = np.sort(rng.choice(allstr, 15, replace=False))
    sb = np.sort(rng.choice(allstr, 12, replace=False))
    pa, pb = bitpack.pack_ints(sa, NORB), bitpack.pack_ints(sb, NORB)
    c = rng.normal(size=(len(sa), len(sb)))
    a = rng.normal(size=(NORB, NORB))
    e = rng.normal(size=(NORB,) * 4)
    return pa, pb, c, a + a.T, e + e.transpose(2, 3, 0, 1)


@pytest.mark.parametrize("block_bytes", [128 * 1024**2, 0], ids=["unblocked", "blocked"])
@pytest.mark.parametrize("spin_resolved", [False, True], ids=["summed", "spin_resolved"])
def test_make_rdms_matches(state, block_bytes, spin_resolved):
    pa, pb, c, _, _ = state
    ref = jax_rdm.make_rdms(
        jax_basis(pa, pb, NORB, NELEC), jnp.asarray(c), pa, pb,
        spin_resolved=spin_resolved, block_bytes=block_bytes,
    )
    out = rdm.make_rdms(
        build_sci_basis(pa, pb, NORB, NELEC, device="cpu"), torch.as_tensor(c), pa, pb,
        spin_resolved=spin_resolved, block_bytes=block_bytes,
    )
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=TOL)


def test_energy_from_rdms_matches(state):
    pa, pb, c, h1, eri = state
    ref = jax_rdm.make_rdms(jax_basis(pa, pb, NORB, NELEC), jnp.asarray(c), pa, pb)
    out = rdm.make_rdms(build_sci_basis(pa, pb, NORB, NELEC, device="cpu"),
                        torch.as_tensor(c), pa, pb)
    e_ref = float(jax_rdm.energy_from_rdms(h1, eri, ref["dm1a"] + ref["dm1b"], ref["dm2"]))
    e_out = float(rdm.energy_from_rdms(h1, eri, out["dm1a"] + out["dm1b"], out["dm2"]))
    assert abs(e_out - e_ref) <= TOL


def test_rdms_match_dense_oracle(state):
    pa, pb, c, _, _ = state
    out = rdm.make_rdms(build_sci_basis(pa, pb, NORB, NELEC, device="cpu"),
                        torch.as_tensor(c), pa, pb, block_bytes=0)
    sa, sb = bitpack.unpack_to_ints(pa, NORB), bitpack.unpack_to_ints(pb, NORB)
    vec = (c / np.linalg.norm(c)).reshape(-1)
    dm1, dm2 = dense_fci.dense_rdm12(vec, sa, sb, NORB)
    np.testing.assert_allclose((out["dm1a"] + out["dm1b"]).numpy(), dm1, atol=TOL)
    np.testing.assert_allclose(out["dm2"].numpy(), dm2, atol=TOL)


def _random_strings(norb, nelec, count, seed):
    """``count`` sorted unique packed strings of ``nelec`` set bits in ``norb``."""
    rng = np.random.default_rng(seed)
    rows = {tuple(sorted(rng.choice(norb, nelec, replace=False))) for _ in range(4 * count)}
    ints = sorted(sum(1 << int(b) for b in row) for row in rows)[:count]
    return bitpack.pack_ints(np.array(ints, dtype=object if norb > 62 else np.int64), norb)


# (norb, nelec_spin, strings, pair-batch budget in bytes or None for the default)
DESDES_CASES = {
    "fixture": (NORB, 3, None, None),
    "one_word": (8, 4, 20, None),
    "two_words": (40, 5, 12, None),
    # 64 pairs in batches of 5: twelve full batches and one ragged
    "ragged_batches": (8, 4, 20, 5),
    "two_words_single_pair_batches": (40, 3, 6, 1),
    "one_electron": (8, 1, 5, None),
    "empty_set": (8, 3, 0, None),
}


@pytest.mark.parametrize("case", list(DESDES_CASES))
def test_desdes_tables_match(state, case, monkeypatch):
    norb, nelec_spin, count, pairs_per_batch = DESDES_CASES[case]
    if count is None:
        strs = state[0]
    elif count == 0:
        strs = np.zeros((0, bitpack.num_words(norb)), dtype=np.uint32)
    else:
        strs = _random_strings(norb, nelec_spin, count, seed=23)
    inter_j, src_j, sign_j = jax_linktab.build_desdes_tables(strs, norb, nelec_spin)
    if pairs_per_batch is not None:
        w = strs.shape[1]
        monkeypatch.setattr(
            linktab, "DESDES_BATCH_BYTES", pairs_per_batch * len(inter_j) * (5 + 2 * w) * 8
        )
    inter, src, sign = linktab.build_desdes_tables(strs, norb, nelec_spin, device="cpu")
    assert src.dtype == torch.int64 and sign.dtype == torch.int8
    assert src.shape == sign.shape == (norb * norb, len(inter_j))
    np.testing.assert_array_equal(inter, inter_j)
    sign_j = np.asarray(sign_j)
    np.testing.assert_array_equal(sign.numpy(), sign_j)
    np.testing.assert_array_equal(src.numpy()[sign_j != 0], np.asarray(src_j)[sign_j != 0])
    # absent entries point at slot 0 and diagonal pairs are all zero
    assert not src.numpy()[sign_j == 0].any()
    assert not sign.numpy()[:: norb + 1].any()
    if case in ("one_word", "two_words", "ragged_batches"):
        assert np.count_nonzero(sign_j) > 0


def test_rdms_match_with_batched_two_hole_tables(state, monkeypatch):
    """The RDMs through two-hole tables built three pairs at a time."""
    pa, pb, c, _, _ = state
    basis = build_sci_basis(pa, pb, NORB, NELEC, device="cpu")
    ref = rdm.make_rdms(basis, torch.as_tensor(c), pa, pb, spin_resolved=True)
    monkeypatch.setattr(linktab, "DESDES_BATCH_BYTES", 3 * 20 * 7 * 8)
    out = rdm.make_rdms(basis, torch.as_tensor(c), pa, pb, spin_resolved=True)
    for key in ref:
        assert torch.equal(out[key], ref[key])
