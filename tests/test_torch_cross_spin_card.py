# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The f64 cross-spin kernel route of the exact operator on the card.

Every test here needs an NVIDIA card and skips without one.  On the card the
f64 route of ``SCIHamiltonian.matvec`` (the f64 kernel, the same-spin
gathers, the penalty's diagonal) is held against the dense f64 route that the
CPU takes (``_matvec_dense``, or ``_matvec_blocked`` for a column-blocked
operator; the operators carry the CPU's column block, given explicitly,
since ``"auto"`` gives none on the card) at the headline (1024 x 1024,
npair 256), the cc-pVDZ batch (npair 784), config 5 (3168 x 3200, npair 1296, two-word strings) and the CASCI
(4384 x 4480), within ``1e-12 * max(|dense|, 1)``; the kernel's launches are
counted per exact application, apart from the f32 kernel's; and one f64
application launches no GEMM of its own.  The file imports no JAX, so it
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cross_spin_card.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from bench_torch import config5_problem, excitation_strings
from sqd_tpu_torch import fermion
from sqd_tpu_torch.models.fcidump import read_fcidump
from sqd_tpu_torch.ops import bitpack, cross_spin
from sqd_tpu_torch.ops.hamiltonian import SCIHamiltonian, build_sci_hamiltonian, padded_layout

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqd_tpu_torch", "data")
TOL = 1e-12  # relative to max(|dense|, 1): f64 sums in another order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _fcidump(name):
    d = read_fcidump(os.path.join(DATA, name))
    return np.asarray(d["h1e"], np.float64), np.asarray(d["eri"], np.float64)


def _operator(name, device, **kwargs):
    """The f64 operator of one shape, as ``solve_sci`` builds it on the CPU:
    the CPU's shape and column block, so that its dense reference fits on the
    card (config 5's unblocked one would take ~105 GB)."""
    if name in ("headline", "casci"):
        h1, eri = _fcidump("n2_631g_cas16o_5a5b.fcidump")
        norb, nelec = 16, (5, 5)
        if name == "headline":
            sa, sb = excitation_strings(1000, 16, 5, 1), excitation_strings(1000, 16, 5, 2)
            pad_to = (1024, 1024)
        else:
            sa = sb = np.array([s for s in range(1 << 16) if s.bit_count() == 5])
            pad_to = (4384, 4384)
    elif name == "ccpvdz":
        h1, eri = _fcidump("n2_ccpvdz_28o_7a7b.fcidump")
        norb, nelec = 28, (7, 7)
        sa, sb = excitation_strings(1000, 28, 7, 3), excitation_strings(1000, 28, 7, 4)
        pad_to = (1024, 1024)
    else:  # config 5
        h1, eri, sa = config5_problem()
        sb = sa
        norb, nelec = 36, (27, 27)
        pad_to = (-(-len(sa) // 32) * 32,) * 2
    m_pad, n_pad, col_block = padded_layout(norb * norb, len(sa), len(sb), pad_to, "auto",
                                            torch.device("cpu"))
    return build_sci_hamiltonian(
        bitpack.pack_ints(sa, norb), bitpack.pack_ints(sb, norb), h1, eri, norb, nelec,
        device=device, pad_to=(m_pad, n_pad), col_block=col_block, eri_factor=None, **kwargs)


def _dense(ham, c):
    """The dense f64 route the CPU takes for this operator."""
    if ham.col_block and c.shape[1] > ham.col_block:
        return ham._matvec_blocked(c)
    return ham._matvec_dense(c)


def _amplitudes(ham, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=ham.shape),
                           dtype=torch.float64, device=ham.src_a.device)


@pytest.mark.card
@pytest.mark.parametrize("name, spin", [
    ("headline", {}), ("headline", {"spin_shift": 0.35, "spin_target": 2.0}),
    ("ccpvdz", {}), ("config5", {}), ("casci", {}),
], ids=["headline", "headline_spin_penalty", "ccpvdz", "config5", "casci"])
def test_f64_route_matches_dense(card, name, spin):
    """``matvec`` in f64 takes the kernel route (no dense intermediates, at
    any ``col_block``) and equals the dense route within 1e-12."""
    ham = _operator(name, card, **spin)
    c = _amplitudes(ham, 1)
    before = cross_spin.cross_spin_matvec_f64.launches, cross_spin.cross_spin_matvec.launches
    out = ham.matvec(c)
    torch.cuda.synchronize()
    assert (cross_spin.cross_spin_matvec_f64.launches,
            cross_spin.cross_spin_matvec.launches) == (before[0] + 1, before[1])
    ref = _dense(ham, c)
    assert out.dtype == torch.float64 and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max())
    assert err <= TOL * max(float(ref.abs().max()), 1.0), err


@pytest.mark.card
@pytest.mark.parametrize("name, tiles", [("headline", (128, 96)), ("ccpvdz", (64, 40))],
                         ids=["headline", "ccpvdz"])
def test_f64_kernel_forced_tiles(card, name, tiles):
    """The kernel with small k and rs tiles forced equals its plain version
    and the kernel at its own plan."""
    ham = _operator(name, card)
    ops = ham.cross_spin_operands(torch.float64)
    c = _amplitudes(ham, 2)
    plain = cross_spin.cross_spin_plain(c, ops)
    scale = max(float(plain.abs().max()), 1.0)
    for t in (None, tiles):
        out = cross_spin.cross_spin_matvec_f64(c, ops, tiles=t)
        torch.cuda.synchronize()
        assert float((out - plain).abs().max()) <= TOL * scale


@pytest.mark.card
def test_f64_launches_per_exact_application(card, monkeypatch):
    """In a ``solve_sci`` call, the f64 kernel launches once per exact
    application (``_matvec_full``; ``_matvec_blocked`` never runs on the
    card) and the f32 kernel once per f32 application."""
    h1, eri = _fcidump("n2_631g_cas16o_5a5b.fcidump")
    strs = (excitation_strings(1000, 16, 5, 1), excitation_strings(1000, 16, 5, 2))
    calls = {"_matvec_full": 0, "_matvec_blocked": 0, "f32": 0}
    full, blocked, kernel = (SCIHamiltonian._matvec_full, SCIHamiltonian._matvec_blocked,
                             SCIHamiltonian._matvec_kernel)

    def counted_full(self, c):
        calls["_matvec_full"] += 1
        return full(self, c)

    def counted_blocked(self, c):
        calls["_matvec_blocked"] += 1
        return blocked(self, c)

    def counted_kernel(self, c):
        calls["f32"] += c.dtype == torch.float32
        return kernel(self, c)

    monkeypatch.setattr(SCIHamiltonian, "_matvec_full", counted_full)
    monkeypatch.setattr(SCIHamiltonian, "_matvec_blocked", counted_blocked)
    monkeypatch.setattr(SCIHamiltonian, "_matvec_kernel", counted_kernel)
    before = cross_spin.cross_spin_matvec_f64.launches, cross_spin.cross_spin_matvec.launches
    result = fermion.solve_sci(strs, h1, eri, 16, (5, 5), device=card)
    f64 = cross_spin.cross_spin_matvec_f64.launches - before[0]
    f32 = cross_spin.cross_spin_matvec.launches - before[1]
    assert np.isfinite(result.energy)
    assert calls["_matvec_blocked"] == 0
    assert f64 == calls["_matvec_full"] > 1  # the refinement and the energy
    assert f32 == calls["f32"] > 0


def _kernels_launched(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.card
@pytest.mark.parametrize("name", ["headline", "config5"])
def test_f64_application_runs_no_dense_gemm(card, name):
    """One f64 ``matvec`` launches the f64 kernel once and no GEMM beyond
    those its two same-spin channels launch alone: nothing contracts the
    ``npair x npair`` matrix densely."""
    ham = _operator(name, card)
    c = _amplitudes(ham, 3)
    ham.matvec(c)  # warm: operands, library, cuBLAS handles
    torch.cuda.synchronize()
    names = _kernels_launched(lambda: ham.matvec(c))
    samespin = _kernels_launched(
        lambda: (ham.apply_samespin_alpha(c), ham.apply_samespin_beta(c)))

    def gemms(kernels):
        return sorted(k for k in kernels if "gemm" in k.lower())

    assert sum("cross_spin_f64_rows" in k for k in names) == 1, names
    assert not any("cross_spin_kernel" in k for k in names), names
    assert gemms(names) == gemms(samespin), names
