# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's cross-spin channel against ``sqd_tpu`` on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here the plain PyTorch version is held
against the Pallas kernel in interpret mode and against ``sqd_tpu``'s
``_matvec_full`` minus its same-spin channels, and a NumPy emulation of the
kernel's arithmetic (compacted alpha and beta pairs, tiled runs) is held
against both.  The compacted operands, the kernel's shared-memory plan and
the port's own native build are checked too.  Tolerance:
``max|diff| <= 1e-5 * max(|ref|, 1)`` in f32 (sums in another order), as
``tests/test_pallas_matvec.py``.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian
from sqd_tpu.ops.pallas_matvec import cross_spin_matvec as pallas_cross_spin

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
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


def _fold_penalty_jax(ham_j):
    """``sqd_tpu``'s own fold of the penalty's mixed term into ``eri_t``."""
    npair = NORB * NORB
    eri = ham_j.eri_t.astype(jnp.float32)
    if ham_j.spin_shift != 0.0:
        perm = jnp.asarray(ham_j._qp_perm())
        eri = eri.at[perm, jnp.arange(npair)].add(jnp.float32(-ham_j.spin_shift))
    return eri


def _kernel_runs(ops, tiles):
    """The entries each (k tile, rs tile) step of the kernel takes.

    A cursor per column walks its sorted entries while the source lies below
    the k tile's end, as the kernel does; each rs tile of that k tile takes
    the entries of the run whose pair row it holds.  Returns the boolean
    ``(N, kb)`` masks, one per step, checked to take every valid entry once.
    """
    n, npair = ops.shape[1], ops.eri.shape[0]
    kp = cross_spin.row_stride(ops.ka_pq.shape[1])
    tile_cols, tile_rs = cross_spin.plan(n, npair, kp) if tiles is None else tiles
    kb_n, kb_rs, kb_src = (x.numpy() for x in (ops.kb_n, ops.kb_rs, ops.kb_src))
    t = np.arange(kb_rs.shape[1])[None, :]
    cur = np.zeros(n, dtype=np.int64)
    masks = []
    for k0 in range(0, n, tile_cols):
        k1 = min(n, k0 + tile_cols)
        start = cur.copy()
        for j in range(n):
            while cur[j] < kb_n[j] and kb_src[j, cur[j]] < k1:
                cur[j] += 1
        run = (t >= start[:, None]) & (t < cur[:, None])
        assert ((kb_src[run] >= k0) & (kb_src[run] < k1)).all()
        for r0 in range(0, npair, tile_rs):
            masks.append(run & (kb_rs >= r0) & (kb_rs < min(npair, r0 + tile_rs)))
    np.testing.assert_array_equal(sum(m.astype(int) for m in masks), t < kb_n[:, None])
    return masks


def _emulate_kernel(ops, c, tiles):
    """The kernel's arithmetic in NumPy (f64), from the wrapper's operands:
    per alpha row the staged ``A_i[rs, l]`` and gathered rows of ``c``, per
    column the dot products of its entries, summed over the tiled runs."""
    masks = _kernel_runs(ops, tiles)
    eri = ops.eri.numpy().astype(np.float64)
    kb_rs, kb_src, kb_sgn = (x.numpy() for x in (ops.kb_rs, ops.kb_src, ops.kb_sgn))
    out = np.zeros(c.shape)
    for i in range(c.shape[0]):
        nv = int(ops.ka_n[i])
        if nv == 0:
            continue
        pq, src, sgn = (x[i, :nv].numpy() for x in (ops.ka_pq, ops.ka_src, ops.ka_sgn))
        a = eri[:, pq] * sgn  # (npair, nv)
        g = c[src].astype(np.float64).T  # (N, nv): c[src_l, k]
        dots = kb_sgn * np.einsum("jtl,jtl->jt", a[kb_rs], g[kb_src])
        out[i] = sum(np.where(m, dots, 0.0).sum(axis=1) for m in masks)
    return out


@pytest.mark.parametrize(
    "tiles", [None, (16, None), (16, 24)], ids=["whole", "k_tiled", "k_and_rs_tiled"])
@pytest.mark.parametrize(
    "pad_to, spin",
    [((48, 128), (0.35, 2.0)), (None, (0.0, 0.0)), ((64, 256), (0.0, 0.0))],
    ids=["spin_penalty", "ragged", "padded"],
)
def test_kernel_arithmetic_emulated(problem, pad_to, spin, tiles):
    """The kernel's formulation, emulated with its k tiling (and rs tiling)
    from the wrapper's operands, against ``sqd_tpu``: ``_matvec_full`` minus
    its same-spin channels and, where its shape gate admits the operator, the
    Pallas kernel in interpret mode.  ``k_tiled`` splits N = 40 into 3 runs,
    N = 128 into 8 and N = 256 into 16; ``k_and_rs_tiled`` also splits the
    64 pair rows into 3 tiles."""
    ham_j, ham_t, c = _pair(problem, pad_to=pad_to, spin_shift=spin[0], spin_target=spin[1])
    ops = ham_t.cross_spin_operands()
    if tiles is not None and tiles[1] is None:
        tiles = (tiles[0], ops.eri.shape[0])
    out = _emulate_kernel(ops, c, tiles)
    ham_nop = dataclasses.replace(ham_j, spin_shift=0.0)
    _close(out, _jax_cross_spin(ham_nop, c) - _s2_mixed(ham_j, c))
    if pad_to is not None:
        ka = -(-(3 * (NORB - 3 + 1)) // 8) * 8
        ref = pallas_cross_spin(
            jnp.asarray(c), ham_j.src_a, ham_j.sign_a, ham_j.src_b, ham_j.sign_b,
            _fold_penalty_jax(ham_j), ka=ka, interpret=True,
        )
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


@pytest.mark.parametrize("pad_to", [(48, 128), None], ids=["padded", "ragged"])
def test_compacted_beta_pairs(problem, pad_to):
    """The beta side: per column its valid pairs, sorted by source (then by
    pair), zero past the count, stored entry-major."""
    ham_j, ham_t, _ = _pair(problem, pad_to=pad_to)
    ops = ham_t.cross_spin_operands()
    src_b, sign_b = np.asarray(ham_j.src_b), np.asarray(ham_j.sign_b)
    valid = sign_b != 0
    np.testing.assert_array_equal(ops.kb_n.numpy(), valid.sum(axis=0))
    assert ops.kb_rs.shape == (sign_b.shape[1], valid.sum(axis=0).max())
    for t in (ops.kb_rs, ops.kb_src, ops.kb_sgn):
        assert t.T.is_contiguous()
    assert ops.kb_rs.dtype == ops.kb_src.dtype == torch.int32
    assert ops.kb_sgn.dtype == torch.float32
    for j in range(sign_b.shape[1]):
        k = int(ops.kb_n[j])
        rs = np.flatnonzero(valid[:, j])
        rs = rs[np.argsort(src_b[rs, j], kind="stable")]
        np.testing.assert_array_equal(ops.kb_rs[j, :k].numpy(), rs)
        np.testing.assert_array_equal(ops.kb_src[j, :k].numpy(), src_b[rs, j])
        np.testing.assert_array_equal(ops.kb_sgn[j, :k].numpy(), sign_b[rs, j])
        assert not ops.kb_rs[j, k:].any() and not ops.kb_src[j, k:].any()
        assert not ops.kb_sgn[j, k:].any()


@pytest.mark.parametrize(
    "n, npair, ka, expect",
    [(1024, 256, 36, (1024, 256)), (4480, 256, 36, (1355, 256)), (1024, 676, 182, (153, 153))],
    ids=["headline", "wide", "rs_tiled"],
)
def test_kernel_plan(n, npair, ka, expect):
    """The shared-memory plan: the headline stages all of A_i and all 1024
    columns (184,752 bytes with the pair lists); N = 4480 takes 4 k tiles; npair = 676 with 182
    valid pairs per row (26 orbitals, 13 electrons) tiles the rs axis."""
    kp = cross_spin.row_stride(ka)
    assert kp >= ka and kp % 4 == 0 and (kp // 4) % 2 == 1
    tile_cols, tile_rs = cross_spin.plan(n, npair, kp)
    assert (tile_cols, tile_rs) == expect
    assert 4 * kp * (tile_cols + tile_rs + 3) <= cross_spin.SMEM_BYTES
    if n == 1024 and npair == 256:
        assert 4 * kp * (tile_cols + tile_rs + 3) == 184_752
    for k in range(1, 200):
        q = cross_spin.row_stride(k) // 4
        assert q % 2 == 1 and 4 * q >= k and 4 * q - k < 8


_BUILD_ALONE = """
import os, sys
import numpy as np
from sqd_tpu_torch import native
here = os.path.dirname(os.path.abspath(__file__))
assert native.SOURCE.startswith(here), native.SOURCE
d = np.load(os.path.join(here, "inputs.npz"))
src, sign = native.gather_tables(d["packed"], int(d["norb"]))
idx, val = native.samespin_tables(d["packed"], d["h1"], d["eri"], int(d["norb"]), int(d["nelec"]))
built = os.listdir(os.path.join(here, "sqd_tpu_torch", "_build"))
np.savez(os.path.join(here, "tables.npz"), src=src, sign=sign, idx=idx, val=val)
print(native.SOURCE, built)
"""


def test_native_builds_alone(tmp_path):
    """The port's package alone, with no ``sqd_tpu`` beside it, builds its
    native library from its own ``csrc/sqdcore.cpp``, and its tables equal
    ``sqd_tpu.native``'s bit for bit."""
    from sqd_tpu import native as jax_native

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(
        os.path.join(root, "sqd_tpu_torch"), tmp_path / "sqd_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    norb, nelec = 10, 4
    rng = np.random.default_rng(7)
    strs = np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec), 90, replace=False))
    packed = bitpack.pack_ints(strs, norb)
    h1, eri = _sym2(rng, norb), _sym4(rng, norb)
    np.savez(tmp_path / "inputs.npz", packed=packed, h1=h1, eri=eri, norb=norb, nelec=nelec)
    (tmp_path / "run.py").write_text(_BUILD_ALONE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "run.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    source, built = proc.stdout.strip().split(" ", 1)
    assert source == str(tmp_path / "sqd_tpu_torch" / "csrc" / "sqdcore.cpp")
    assert "libsqdcore_" in built
    assert not (tmp_path / "sqd_tpu").exists()
    got = np.load(tmp_path / "tables.npz")
    for name, ref in zip(("src", "sign"), jax_native.gather_tables(packed, norb)):
        assert got[name].dtype == ref.dtype
        np.testing.assert_array_equal(got[name], ref)
    ref = jax_native.samespin_tables(packed, h1, eri, norb, nelec, algo="enum")
    for name, r in zip(("idx", "val"), ref):
        assert got[name].dtype == r.dtype
        np.testing.assert_array_equal(got[name], r)


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


@pytest.mark.parametrize("spin", [(0.0, 0.0), (0.35, 2.0)], ids=["bare", "spin_penalty"])
def test_row_restricted_operands(problem, spin):
    """Operands built from some alpha rows' tables give those rows of the
    whole operator's cross-spin channel; their sources read rows past the
    output range, so ``c`` must hold at least ``src_rows`` rows."""
    _, ham_t, c = _pair(problem, pad_to=(48, 128), spin_shift=spin[0], spin_target=spin[1])
    full_ops = ham_t.cross_spin_operands()
    c = torch.as_tensor(c)
    rows = slice(12, 30)
    ops = cross_spin.prepare(ham_t.src_a[:, rows], ham_t.sign_a[:, rows], ham_t.src_b,
                             ham_t.sign_b, full_ops.eri)
    assert ops.shape == (18, 128) and ops.src_rows > 30
    out = cross_spin.cross_spin_matvec(c, ops)
    assert out.shape == (18, 128)
    torch.testing.assert_close(out, cross_spin.cross_spin_plain(c, full_ops)[rows],
                               rtol=0, atol=1e-5 * max(float(out.abs().max()), 1.0))
    with pytest.raises(ValueError, match="reading"):
        cross_spin.cross_spin_matvec(c[: ops.src_rows - 1], ops)
    with pytest.raises(ValueError, match="reading"):
        cross_spin.cross_spin_plain(c[:, :100], ops)
