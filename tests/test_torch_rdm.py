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


def test_desdes_tables_match(state):
    pa, _, _, _, _ = state
    inter_j, src_j, sign_j = jax_linktab.build_desdes_tables(pa, NORB, NELEC[0])
    inter, src, sign = linktab.build_desdes_tables(pa, NORB, NELEC[0], device="cpu")
    np.testing.assert_array_equal(inter, inter_j)
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(sign_j))
