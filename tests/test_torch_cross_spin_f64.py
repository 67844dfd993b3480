# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's f64 cross-spin channel against ``sqd_tpu`` on the CPU.

The f64 CUDA kernel runs only on the card (``tests/test_torch_cross_spin_card.py``
and ``chip_smoke.py`` hold it against the dense route there).  Here the f64
plain version and a NumPy emulation of the kernel's tiled arithmetic are held
against ``sqd_tpu``'s f64 ``_matvec_full`` minus its same-spin channels, the
kernel's 8-byte shared-memory plan is checked at the main path's shapes, and
the operator's f64 matvec on the CPU is checked to keep its dense routes.
Tolerance: ``max|diff| <= 1e-12 * max(|ref|, 1)`` (f64 sums in another order).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian as jax_build

from test_torch_cross_spin import NORB, NELEC, _emulate_kernel, problem  # noqa: F401  (fixture)
from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch.ops import cross_spin
from sqd_tpu_torch.ops import hamiltonian as ham_ops
from sqd_tpu_torch.ops.hamiltonian import SCIHamiltonian, build_sci_hamiltonian, expectation_value

torch.set_num_threads(2)

CASES = {  # pad_to, (spin_shift, spin_target)
    "spin_penalty": ((48, 128), (0.35, 2.0)),
    "ragged": (None, (0.0, 0.0)),
    "padded": ((64, 256), (0.0, 0.0)),
}


def _pair64(problem, name, *, col_block=0):
    """The same f64 operator in both packages and one random amplitude matrix."""
    pa, pb, h1, eri = problem
    pad_to, (shift, target) = CASES[name]
    kwargs = dict(pad_to=pad_to, col_block=col_block, spin_shift=shift, spin_target=target)
    ham_j = jax_build(pa, pb, h1, eri, NORB, NELEC, dtype=jnp.float64, **kwargs)
    ham_t = build_sci_hamiltonian(pa, pb, h1, eri, NORB, NELEC, device="cpu", **kwargs)
    c = np.random.default_rng(12).normal(size=ham_j.shape)
    return ham_j, ham_t, c


def _close64(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-12 * max(np.max(np.abs(ref)), 1.0)


def _jax_cross_spin64(ham_j, c):
    """``sqd_tpu``'s f64 cross-spin channel with the penalty's mixed term:
    ``_matvec_full`` minus its same-spin channels and minus the penalty's
    diagonal ``shift * (const - target) * c``, which the kernel route adds
    apart."""
    cj = jnp.asarray(c)
    n_a, n_b = ham_j.nelec
    sz = 0.5 * (n_a - n_b)
    diag = ham_j.spin_shift * (sz * sz + sz + n_b - ham_j.spin_target)
    return (ham_j._matvec_full(cj) - ham_j.apply_samespin_alpha(cj)
            - ham_j.apply_samespin_beta(cj) - diag * cj)


@pytest.mark.parametrize("name", list(CASES))
def test_f64_plain_matches_xla_cross_spin(problem, name):
    """The plain version in f64, from the operator's f64 operands."""
    ham_j, ham_t, c = _pair64(problem, name)
    ops = ham_t.cross_spin_operands(torch.float64)
    assert ops.eri.dtype == ops.ka_sgn.dtype == ops.kb_sgn.dtype == torch.float64
    out = cross_spin.cross_spin_plain(torch.as_tensor(c), ops)
    assert out.dtype == torch.float64
    _close64(out, _jax_cross_spin64(ham_j, c))
    # the f64 wrapper takes the plain version for a CPU tensor, launching nothing
    launches = cross_spin.cross_spin_matvec.launches, cross_spin.cross_spin_matvec_f64.launches
    assert torch.equal(cross_spin.cross_spin_matvec_f64(torch.as_tensor(c), ops), out)
    assert (cross_spin.cross_spin_matvec.launches,
            cross_spin.cross_spin_matvec_f64.launches) == launches


@pytest.mark.parametrize(
    "tiles", [None, (16, None), (16, 24)], ids=["whole", "k_tiled", "k_and_rs_tiled"])
@pytest.mark.parametrize("name", list(CASES))
def test_f64_kernel_arithmetic_emulated(problem, name, tiles):
    """The f64 kernel's formulation, emulated with its 8-byte plan's tiles
    (whole: one k tile and all of A) and with k tiles (and rs tiles) forced,
    from the f64 operands, against ``sqd_tpu``'s f64 channel."""
    ham_j, ham_t, c = _pair64(problem, name)
    ops = ham_t.cross_spin_operands(torch.float64)
    n, npair = ops.shape[1], ops.eri.shape[0]
    kp = cross_spin.row_stride(ops.ka_pq.shape[1], 8)
    if tiles is None:
        tiles = cross_spin.plan(n, npair, kp, itemsize=8)
        assert tiles == (n, npair)
    elif tiles[1] is None:
        tiles = (tiles[0], npair)
    _close64(_emulate_kernel(ops, c, tiles), _jax_cross_spin64(ham_j, c))


@pytest.mark.parametrize(
    "n, npair, ka, expect",
    [(1024, 256, 36, (506, 256)), (4480, 256, 60, (210, 256)),
     (1024, 676, 110, (131, 131)), (1024, 1296, 270, (53, 52))],
    ids=["headline", "casci", "ccpvdz_26o", "fe4s4"],
)
def test_f64_kernel_plan(n, npair, ka, expect):
    """The 8-byte plan: rows of an odd count of 16-byte groups; the headline
    and the CASCI (60 pairs a row) keep all of A beside 506 and 210 columns,
    where the f32 minimum of 256 columns would tile the CASCI's rs axis;
    npair 676 and 1296 tile the rs axis, half the rows each."""
    kp = cross_spin.row_stride(ka, 8)
    assert kp >= ka and kp % 2 == 0 and (kp // 2) % 2 == 1
    assert cross_spin.plan(n, npair, kp, itemsize=8) == expect
    assert 8 * kp * (sum(expect) + 2) <= cross_spin.SMEM_BYTES
    rows = cross_spin.SMEM_BYTES // (8 * kp) - 2
    if npair == 256:
        assert expect[1] == npair and npair + min(n, cross_spin.MIN_TILE_COLS_F64) <= rows
    if n == 4480:
        assert npair + cross_spin.MIN_TILE_COLS > rows  # the f32 minimum would tile rs
    for k in range(1, 300):
        q = cross_spin.row_stride(k, 8) // 2
        assert q % 2 == 1 and 2 * q >= k and 2 * q - k < 4
        assert cross_spin.row_stride(k) == cross_spin.row_stride(k, 4)


def test_f64_operands_share_the_tables(problem):
    """The f64 operands are cached on the operator and share the compacted
    integer tables with the f32 ones, in either order of building, across
    :meth:`astype`; ``astype`` to the operator's own dtype is the operator."""
    _, ham64, _ = _pair64(problem, "spin_penalty")
    assert ham64.astype(torch.float64) is ham64
    ham32 = ham64.astype(torch.float32)
    assert ham32 is not ham64 and ham32.eri_t.dtype == torch.float32
    ops32 = ham32.cross_spin_operands()
    ops64 = ham64.cross_spin_operands(torch.float64)
    assert ham64.cross_spin_operands(torch.float64) is ops64
    assert ops64.eri.dtype == torch.float64 and ops32.eri.dtype == torch.float32
    for name in ("ka_n", "ka_pq", "ka_src", "kb_n", "kb_rs", "kb_src", "src_a", "src_b"):
        assert getattr(ops64, name) is getattr(ops32, name), name
    for name in ("ka_sgn", "kb_sgn", "sign_a", "sign_b"):
        assert torch.equal(getattr(ops64, name), getattr(ops32, name).to(torch.float64)), name
        assert getattr(ops64, name).dtype == torch.float64
    assert ops64.kb_sgn.T.is_contiguous()
    # the penalty is folded in f64: the same matrix the f64 operator gives alone
    torch.testing.assert_close(ops64.eri, ham64.penalty_folded_eri(torch.float64),
                               rtol=0, atol=0)
    fresh = dataclasses.replace(ham64)  # no cache: built from the gather tables
    alone = fresh.cross_spin_operands(torch.float64)
    for name in ("ka_n", "ka_pq", "ka_src", "ka_sgn", "kb_n", "kb_rs", "kb_src", "kb_sgn"):
        assert torch.equal(getattr(alone, name), getattr(ops64, name)), name


def _spy_routes(monkeypatch):
    """Record which of the operator's routes run, in order."""
    ran = []
    for route in ("_matvec_dense", "_matvec_blocked", "_matvec_kernel"):
        original = getattr(SCIHamiltonian, route)

        def spy(self, x, _route=route, _fn=original):
            ran.append(_route)
            return _fn(self, x)

        monkeypatch.setattr(SCIHamiltonian, route, spy)
    return ran


@pytest.mark.parametrize("name, col_block", [("spin_penalty", 0), ("spin_penalty", 32),
                                             ("ragged", 0), ("padded", 32)])
def test_f64_kernel_route_matches_full(problem, monkeypatch, name, col_block):
    """The card's f64 route, with the plain version standing in for the
    kernel (the route test forced true on the CPU): ``matvec`` takes
    ``_matvec_full`` -> ``_matvec_kernel`` even on a column-blocked operator,
    and equals ``sqd_tpu``'s f64 ``_matvec_full`` (penalty included); the
    energy reuses the operator's operands, with the penalty and without it."""
    ham_j, ham_t, c = _pair64(problem, name, col_block=col_block)
    assert ham_t.col_block == col_block
    monkeypatch.setattr(ham_ops, "_f64_kernel_takes", lambda x: x.dtype == torch.float64)
    ran = _spy_routes(monkeypatch)
    ct = torch.as_tensor(c)
    out = ham_t.matvec(ct)
    assert ran == ["_matvec_kernel"]
    _close64(out, ham_j._matvec_full(jnp.asarray(c)))
    built = []
    monkeypatch.setattr(cross_spin, "prepare", lambda *a: built.append(a))
    for penalty in (True, False):
        ref = float(jnp.vdot(jnp.asarray(c), ham_j._matvec_full(jnp.asarray(c)))
                    / jnp.vdot(jnp.asarray(c), jnp.asarray(c))) if penalty else None
        e = expectation_value(ham_t, ct.reshape(-1), spin_penalty=penalty)
        if ref is not None:
            assert abs(e - ref) <= 1e-12 * max(abs(ref), 1.0)
    assert built == [] and ran == ["_matvec_kernel"] * 3


@pytest.mark.parametrize("name", ["spin_penalty", "padded"])
def test_f64_kernel_route_takes_any_layout(problem, monkeypatch, name):
    """The card's f64 route on amplitudes that are not C-contiguous (a
    transposed copy, a column slice), with a stand-in for the kernel's
    wrapper that refuses them as the kernel's launch does: ``matvec`` hands
    it contiguous amplitudes and equals the dense route."""
    _, ham_t, c = _pair64(problem, name)
    monkeypatch.setattr(ham_ops, "_f64_kernel_takes", lambda x: x.dtype == torch.float64)
    plain = cross_spin.cross_spin_matvec_f64

    def strict(x, ops):
        if not x.is_contiguous():
            raise ValueError("the cross-spin kernel needs C-contiguous amplitudes")
        return plain(x, ops)

    monkeypatch.setattr(cross_spin, "cross_spin_matvec_f64", strict)
    m, n = c.shape
    wide = torch.as_tensor(np.random.default_rng(13).normal(size=(m, 2 * n)))
    for x in (torch.as_tensor(c).T.contiguous().T, wide[:, ::2]):
        assert not x.is_contiguous()
        _close64(ham_t.matvec(x), ham_t._matvec_dense(x.contiguous()))


@pytest.mark.parametrize("name, col_block", [("spin_penalty", 0), ("spin_penalty", 32),
                                             ("ragged", 0), ("padded", 32)])
def test_cpu_f64_matvec_keeps_the_dense_routes(problem, monkeypatch, name, col_block):
    """On the CPU the f64 matvec is the dense route as before: unblocked
    through ``_matvec_full`` -> ``_matvec_dense``, column-blocked through
    ``_matvec_blocked``, bit for bit those bodies, within 1e-12 of
    ``sqd_tpu``'s, with no cross-spin operands built and no kernel."""
    ham_j, ham_t, c = _pair64(problem, name, col_block=col_block)
    ct = torch.as_tensor(c)
    ran = _spy_routes(monkeypatch)
    launches = cross_spin.cross_spin_matvec.launches, cross_spin.cross_spin_matvec_f64.launches
    out = ham_t.matvec(ct)
    assert ran == (["_matvec_blocked"] if col_block else ["_matvec_dense"])
    assert "_cross_spin_operands" not in ham_t.__dict__
    monkeypatch.undo()
    dense = ham_t._matvec_blocked(ct) if col_block else ham_t._matvec_dense(ct)
    assert torch.equal(out, dense)
    assert torch.equal(ham_t._matvec_full(ct), ham_t._matvec_dense(ct))
    _close64(out, ham_j.matvec(jnp.asarray(c)))
    assert (cross_spin.cross_spin_matvec.launches,
            cross_spin.cross_spin_matvec_f64.launches) == launches


def test_f64_kernel_takes_only_f64_on_the_card():
    """The route test reads only the device type and the dtype."""
    meta64 = torch.empty((2, 2), dtype=torch.float64, device="meta")
    assert not ham_ops._f64_kernel_takes(meta64)
    assert not ham_ops._f64_kernel_takes(torch.zeros((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cross_spin.cross_spin_matvec_f64(meta64, None)


def test_kernel_names_keep_the_f32_reader():
    """The f64 kernel's device function does not contain
    ``cross_spin_kernel`` (the f32 kernel's roofline reader sums device time
    by that name); both entries are in the one source."""
    with open(cross_spin.SOURCE) as f:
        source = f.read()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                         source)
    assert kernels == ["cross_spin_kernel", "cross_spin_f64_rows"]
    assert [k for k in kernels if "cross_spin_kernel" in k] == ["cross_spin_kernel"]
    for entry in ("cross_spin_matvec_f32", "cross_spin_matvec_f64"):
        assert re.search(rf'extern "C" int {entry}\(', source)
    assert os.path.basename(cross_spin.SOURCE) == "cross_spin_matvec.cu"


def test_f64_kernel_launches_reader(monkeypatch):
    """``f64_kernel_launches`` reads the f64 kernel's counter per solve, and
    a program without the kernel (an earlier one) gives it nothing to read."""
    from benchmark import harness

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def reader():
        return harness.load_module(
            os.path.join(root, "benchmark", "metrics", "f64_kernel_launches.py"),
            "benchmark_metric_test_f64_kernel_launches")

    assert reader().COUNTERS == ("cross_spin_f64_launches",) and "solve" in reader().SPANS
    solves = [{"seconds": 1.0, "counters": {"cross_spin_f64_launches": n}} for n in (5, 4, 6)]
    assert reader().read({"calls": {"solve": solves}}) == pytest.approx(5.0)
    assert reader().read({}) is None
    assert reader().read({"calls": {"solve": [{"seconds": 1.0, "counters": {}}]}}) is None
    monkeypatch.delattr(cross_spin.cross_spin_matvec_f64, "launches")
    assert reader().COUNTERS == ()
