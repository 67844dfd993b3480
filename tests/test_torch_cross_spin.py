# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's cross-spin channel against ``sqd_tpu`` on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here the plain PyTorch version is held
against the Pallas kernel in interpret mode and against ``sqd_tpu``'s
``_matvec_full`` minus its same-spin channels, and a NumPy emulation of the
kernel's compacted-pair arithmetic is held against both.  Tolerance:
``max|diff| <= 1e-5 * max(|ref|, 1)`` in f32 (sums in another order), as
``tests/test_pallas_matvec.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian
from sqd_tpu.ops.pallas_matvec import cross_spin_matvec as pallas_cross_spin

from sqd_tpu_torch.convert import FIELDS, hamiltonian_from_numpy
from sqd_tpu_torch.ops import cross_spin

torch.set_num_threads(2)

NORB, NELEC = 8, (3, 3)


def _sym2(rng, norb):
    a = rng.normal(size=(norb, norb))
    return (a + a.T) / 2


def _sym4(rng, norb):
    e = rng.normal(size=(norb,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    return e / 8


@pytest.fixture(scope="module")
def problem():
    """The ``tests/test_pallas_matvec.py`` fixture: 48 x 40 selected strings."""
    h1, eri = hubbard_integrals(NORB, u=4.0)
    rng = np.random.default_rng(3)
    h1 = h1 + 0.05 * _sym2(rng, NORB)
    eri = eri + 0.05 * _sym4(rng, NORB)
    allstr = dense_fci.all_hamming_strings(NORB, 3)
    sel_a = np.sort(rng.choice(allstr, 48, replace=False))
    sel_b = np.sort(rng.choice(allstr, 40, replace=False))
    pa, pb = bitpack.pack_ints(sel_a, NORB), bitpack.pack_ints(sel_b, NORB)
    return pa, pb, h1, eri


def _pair(problem, *, pad_to, spin_shift=0.0, spin_target=0.0):
    """The same f32 operator in both packages and one random amplitude matrix."""
    pa, pb, h1, eri = problem
    ham_j = build_sci_hamiltonian(
        pa, pb, h1, eri, NORB, NELEC, dtype=jnp.float32, pad_to=pad_to, col_block=0,
        spin_shift=spin_shift, spin_target=spin_target,
    )
    ham_t = hamiltonian_from_numpy(
        {k: np.asarray(getattr(ham_j, k)) for k in FIELDS},
        norb=NORB, nelec=NELEC, spin_shift=spin_shift, spin_target=spin_target, device="cpu",
    )
    c = np.random.default_rng(11).normal(size=ham_j.shape).astype(np.float32)
    return ham_j, ham_t, c


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * max(np.max(np.abs(ref)), 1.0)


def _jax_cross_spin(ham_j, c):
    cj = jnp.asarray(c)
    return ham_j._matvec_full(cj) - ham_j.apply_samespin_alpha(cj) - ham_j.apply_samespin_beta(cj)


def test_plain_matches_pallas_interpret(problem):
    ham_j, ham_t, c = _pair(problem, pad_to=(48, 128))
    ka = -(-(3 * (NORB - 3 + 1)) // 8) * 8
    ref = pallas_cross_spin(
        jnp.asarray(c), ham_j.src_a, ham_j.sign_a, ham_j.src_b, ham_j.sign_b, ham_j.eri_t,
        ka=ka, interpret=True,
    )
    out = cross_spin.cross_spin_plain(torch.as_tensor(c), ham_t.cross_spin_operands())
    _close(out, ref)


def test_plain_matches_xla_cross_spin(problem):
    ham_j, ham_t, c = _pair(problem, pad_to=(48, 128))
    out = cross_spin.cross_spin_plain(torch.as_tensor(c), ham_t.cross_spin_operands())
    _close(out, _jax_cross_spin(ham_j, c))


@pytest.mark.parametrize(
    "pad_to, spin",
    [((48, 128), (0.35, 2.0)), (None, (0.0, 0.0)), (None, (0.35, 2.0))],
    ids=["spin_penalty", "ragged", "ragged_spin_penalty"],
)
def test_f32_matvec_matches_full(problem, pad_to, spin):
    """The whole f32 matvec (cross-spin wrapper + same-spin + penalty term)
    against ``sqd_tpu``'s ``_matvec_full``; the ragged cases have N = 40."""
    ham_j, ham_t, c = _pair(problem, pad_to=pad_to, spin_shift=spin[0], spin_target=spin[1])
    out = ham_t.matvec(torch.as_tensor(c))
    assert out.dtype == torch.float32
    _close(out, ham_j._matvec_full(jnp.asarray(c)))


def test_kernel_arithmetic_emulated(problem):
    """The kernel's formulation — per alpha row, only its compacted valid pairs
    feed g, then each output column picks g[rs, src_b[rs, j]] — emulated in
    NumPy from the wrapper's operands, against ``sqd_tpu``."""
    ham_j, ham_t, c = _pair(problem, pad_to=(48, 128), spin_shift=0.35, spin_target=2.0)
    ops = ham_t.cross_spin_operands()
    eri = ops.eri.numpy().astype(np.float64)
    src_b, sign_b = ops.src_b32.numpy(), ops.sign_b8.numpy()
    rs = np.arange(eri.shape[0])[:, None]
    out = np.zeros(c.shape)
    for i in range(c.shape[0]):
        k = int(ops.ka_n[i])
        pq, src, sgn = (x[i, :k].numpy() for x in (ops.ka_pq, ops.ka_src, ops.ka_sgn))
        g = (eri[:, pq] * sgn) @ c[src].astype(np.float64)
        out[i] = np.sum(sign_b * g[rs, src_b], axis=0)
    ham_nop = dataclasses.replace(ham_j, spin_shift=0.0)
    ref = _jax_cross_spin(ham_nop, c) - _s2_mixed(ham_j, c)
    _close(out, ref)


def _s2_mixed(ham_j, c):
    """``shift * sum_pq E^a_pq E^b_qp c``: the penalty's mixed term in sqd_tpu."""
    cj = jnp.asarray(c)
    s2c = ham_j.s2_apply_from_alpha(ham_j.gather_alpha(cj), cj)
    n_a, n_b = ham_j.nelec
    sz = 0.5 * (n_a - n_b)
    const = sz * sz + sz + n_b
    return ham_j.spin_shift * (const * cj - s2c)


def test_compacted_pairs(problem):
    ham_j, ham_t, _ = _pair(problem, pad_to=(48, 128))
    ops = ham_t.cross_spin_operands()
    sign_a = np.asarray(ham_j.sign_a)
    valid = sign_a != 0
    np.testing.assert_array_equal(ops.ka_n.numpy(), valid.sum(axis=0))
    assert ops.ka_pq.shape[1] == valid.sum(axis=0).max() <= 3 * (NORB - 3 + 1)
    for i in range(sign_a.shape[1]):
        k = int(ops.ka_n[i])
        pq = np.flatnonzero(valid[:, i])
        np.testing.assert_array_equal(ops.ka_pq[i, :k].numpy(), pq)
        np.testing.assert_array_equal(ops.ka_src[i, :k].numpy(), np.asarray(ham_j.src_a)[pq, i])
        np.testing.assert_array_equal(ops.ka_sgn[i, :k].numpy(), sign_a[pq, i])
        assert not ops.ka_sgn[i, k:].any()


def test_wrapper_dispatch_on_cpu(problem):
    """A CPU tensor takes the plain version and launches nothing."""
    _, ham_t, c = _pair(problem, pad_to=(48, 128))
    ops = ham_t.cross_spin_operands()
    before = cross_spin.cross_spin_matvec.launches
    out = cross_spin.cross_spin_matvec(torch.as_tensor(c), ops)
    assert cross_spin.cross_spin_matvec.launches == before
    torch.testing.assert_close(out, cross_spin.cross_spin_plain(torch.as_tensor(c), ops))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cross_spin.cross_spin_matvec(torch.as_tensor(c, device="meta"), ops)
