# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Selected-CI Hamiltonian application over a (strs_a x strs_b) product basis.

The PyTorch port of ``sqd_tpu.ops.hamiltonian``.  Because the subspace is a
Cartesian product, the projected Hamiltonian splits exactly into

    P H P = H_aa (x) I   +   I (x) H_bb   +   H_ab

* ``H_ab = sum_pqrs (pq|rs) E^a_pq E^b_rs`` (opposite spin): per-pair gathers,
  one matmul over the ``norb^2`` pair axis, gathers back.  In f32 it runs
  through :mod:`sqd_tpu_torch.ops.cross_spin` (the CUDA kernel on the card);
  in f64 through :meth:`SCIHamiltonian._matvec_full`, as ``sqd_tpu`` sends
  f64 to XLA and only f32 to its Pallas kernel.
* ``H_aa`` / ``H_bb`` (same spin): padded Slater-Condon neighbour lists
  applied as row/column gathers.

The optional spin penalty ``shift * (S^2 - target)`` is exact in the product
basis too.  Padded determinants have zero couplings and a 1e30 diagonal, so
they stay exactly zero through the Krylov iteration.

Index tables are stored as int64 — the dtype torch's gathers take — once at
build time, never converted per matvec.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from . import cross_spin
from .precision import highest_precision

__all__ = [
    "SCIBasis",
    "SCIHamiltonian",
    "build_sci_basis",
    "build_sci_hamiltonian",
    "expectation_value",
    "sci_matvec_flat",
]


def _qp_perm_np(norb: int) -> np.ndarray:
    p, q = np.divmod(np.arange(norb * norb), norb)
    return q * norb + p


@dataclass(frozen=True)
class SCIBasis:
    """Single-excitation gather tables over a (strs_a x strs_b) product basis.

    Integral-free: enough for RDMs, occupancies and ``S^2``.  All index tables
    are CLAMPED — an invalid entry points at slot 0 with sign 0.
    """

    src_a: torch.Tensor  # (npair, M) int64
    sign_a: torch.Tensor  # (npair, M) int8
    src_b: torch.Tensor  # (npair, N) int64
    sign_b: torch.Tensor  # (npair, N) int8
    norb: int
    nelec: tuple[int, int]

    @property
    def shape(self) -> tuple[int, int]:
        return self.src_a.shape[1], self.src_b.shape[1]

    @property
    def dim(self) -> int:
        m, n = self.shape
        return m * n

    def gather_alpha(self, c: torch.Tensor) -> torch.Tensor:
        """``D_a[pq] = E^a_pq c`` for all pairs: (npair, M, N) via row gathers."""
        return self.sign_a.to(c.dtype)[:, :, None] * c[self.src_a]

    def gather_beta(self, c: torch.Tensor) -> torch.Tensor:
        """``D_b[pq] = E^b_pq c``: (npair, M, N) via column gathers."""
        g = c[:, self.src_b]  # (M, npair, N)
        return g.transpose(0, 1) * self.sign_b.to(c.dtype)[:, None, :]

    def scatter_alpha(self, g: torch.Tensor) -> torch.Tensor:
        """``sum_pq E^a_pq g[pq]`` — same tables, gather form (no scatters)."""
        picked = torch.gather(g, 1, self.src_a[:, :, None].expand(-1, -1, g.shape[2]))
        return (self.sign_a.to(g.dtype)[:, :, None] * picked).sum(dim=0)

    def scatter_beta(self, g: torch.Tensor) -> torch.Tensor:
        picked = torch.gather(g, 2, self.src_b[:, None, :].expand(-1, g.shape[1], -1))
        return (self.sign_b.to(g.dtype)[:, None, :] * picked).sum(dim=0)

    def _qp_perm(self) -> np.ndarray:
        return _qp_perm_np(self.norb)

    def _s2_const(self) -> float:
        n_a, n_b = self.nelec
        sz = 0.5 * (n_a - n_b)
        return sz * sz + sz + n_b

    def s2_apply_from_alpha(self, d_a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """``S^2 c`` given ``d_a = gather_alpha(c)`` (exact in product basis)."""
        perm = torch.as_tensor(self._qp_perm(), device=c.device)
        src_qp = self.src_b[perm]  # (npair, N)
        sign_qp = self.sign_b[perm].to(c.dtype)
        picked = torch.gather(d_a, 2, src_qp[:, None, :].expand(-1, d_a.shape[1], -1))
        mixed = (sign_qp[:, None, :] * picked).sum(dim=0)
        return self._s2_const() * c - mixed

    def spin_square(self, c: torch.Tensor) -> torch.Tensor:
        """``<c|S^2|c> / <c|c>``."""
        s2c = self.s2_apply_from_alpha(self.gather_alpha(c), c)
        return torch.sum(c * s2c) / torch.sum(c * c)


@dataclass(frozen=True)
class SCIHamiltonian(SCIBasis):
    """Projected Hamiltonian over a (strs_a x strs_b) basis, on one device.

    The amplitude layout is an ``(M, N)`` matrix over (alpha x beta strings).
    """

    nbr_idx_a: torch.Tensor = None  # (M, La) int64
    nbr_val_a: torch.Tensor = None  # (M, La)
    nbr_idx_b: torch.Tensor = None  # (N, Lb) int64
    nbr_val_b: torch.Tensor = None  # (N, Lb)
    eri_t: torch.Tensor = None  # (npair, npair): eri_t[rs, pq] = (pq|rs)
    hdiag: torch.Tensor = None  # (M, N)
    spin_shift: float = 0.0  # penalty shift * (S^2 - spin_target); 0 disables
    spin_target: float = 0.0
    col_block: int = 0  # beta-column block of the f64 path; > 0 is not ported

    def astype(self, dtype: torch.dtype) -> "SCIHamiltonian":
        """Cast the floating-point payload once (so matvecs avoid per-call casts)."""
        return dataclasses.replace(
            self,
            eri_t=self.eri_t.to(dtype),
            nbr_val_a=self.nbr_val_a.to(dtype),
            nbr_val_b=self.nbr_val_b.to(dtype),
            hdiag=self.hdiag.to(dtype),
        )

    def cross_spin_operands(self) -> cross_spin.CrossSpinOperands:
        """The f32 cross-spin operands with the penalty folded into ``eri``.

        Built on first use and cached on this operator.  The spin penalty's
        mixed term ``-shift * sum_pq E^a_pq E^b_qp`` has the same (coefficient
        x alpha gather x beta gather) shape as the cross-spin contraction, so
        ``-shift`` goes into ``eri[qp, pq]``.
        """
        ops = self.__dict__.get("_cross_spin_operands")
        if ops is None:
            eri = self.eri_t.to(torch.float32, copy=True)
            if self.spin_shift != 0.0:
                npair = self.norb * self.norb
                perm = torch.as_tensor(self._qp_perm(), device=eri.device)
                eri[perm, torch.arange(npair, device=eri.device)] -= self.spin_shift
            ops = cross_spin.prepare(self.src_a, self.sign_a, self.src_b, self.sign_b, eri)
            object.__setattr__(self, "_cross_spin_operands", ops)
        return ops

    def apply_samespin_alpha(self, c: torch.Tensor) -> torch.Tensor:
        """``(H_aa (x) I) c`` via the neighbour list (row gathers)."""
        picked = c[self.nbr_idx_a]  # (M, La, N)
        return torch.einsum("jl,jln->jn", self.nbr_val_a.to(c.dtype), picked)

    def apply_samespin_beta(self, c: torch.Tensor) -> torch.Tensor:
        """``(I (x) H_bb) c`` via the neighbour list (column gathers)."""
        picked = c[:, self.nbr_idx_b]  # (M, N, Lb)
        return torch.einsum("kl,mkl->mk", self.nbr_val_b.to(c.dtype), picked)

    def matvec(self, c: torch.Tensor) -> torch.Tensor:
        """``sigma = (P H P) c`` (+ the spin penalty if configured).

        f32 goes through the cross-spin kernel wrapper (the Pallas dispatch of
        ``sqd_tpu``, which also takes only f32); every other dtype through
        :meth:`_matvec_full`.
        """
        with highest_precision():
            if c.dtype == torch.float32:
                return self._matvec_kernel(c)
            if self.col_block and c.shape[1] > self.col_block:
                raise NotImplementedError(
                    "the column-blocked matvec (col_block > 0) is not ported yet; "
                    "see ROADMAP.md"
                )
            return self._matvec_full(c)

    def _matvec_kernel(self, c: torch.Tensor) -> torch.Tensor:
        """Cross-spin channel via :func:`cross_spin.cross_spin_matvec` + same-spin."""
        sigma = cross_spin.cross_spin_matvec(c, self.cross_spin_operands())
        sigma = sigma + self.apply_samespin_alpha(c) + self.apply_samespin_beta(c)
        if self.spin_shift != 0.0:
            sigma = sigma + self.spin_shift * (self._s2_const() - self.spin_target) * c
        return sigma

    def _matvec_full(self, c: torch.Tensor) -> torch.Tensor:
        m, n = c.shape
        npair = self.norb * self.norb
        d_a = self.gather_alpha(c)  # (npair, M, N)
        # cross-spin: sigma_ab = sum_rs E^b_rs [ sum_pq (pq|rs) E^a_pq c ]
        g = (self.eri_t.to(c.dtype) @ d_a.reshape(npair, m * n)).reshape(npair, m, n)
        sigma = self.scatter_beta(g)
        del g
        sigma = sigma + self.apply_samespin_alpha(c) + self.apply_samespin_beta(c)
        if self.spin_shift != 0.0:
            s2c = self.s2_apply_from_alpha(d_a, c)
            sigma = sigma + self.spin_shift * (s2c - self.spin_target * c)
        return sigma


def sci_matvec_flat(ham: SCIHamiltonian, x: torch.Tensor) -> torch.Tensor:
    """Flat-vector matvec adapter for the Davidson driver."""
    m, n = ham.shape
    return ham.matvec(x.reshape(m, n)).reshape(-1)


def expectation_value(
    ham: SCIHamiltonian, c: torch.Tensor, *, spin_penalty: bool = True
) -> float:
    """``<c|H|c> / <c|c>`` as a plain f64 Rayleigh quotient.

    The card has true f64 matmuls, so ``sqd_tpu``'s chunk-accumulated TPU
    scheme is not needed; this is its CPU branch.
    """
    m, n = ham.shape
    ham_e = ham.astype(torch.float64)
    if not spin_penalty and ham.spin_shift != 0.0:
        ham_e = dataclasses.replace(ham_e, spin_shift=0.0)
    c64 = c.to(torch.float64).reshape(m, n)
    hv = ham_e.matvec(c64)
    return float(torch.sum(c64 * hv) / torch.sum(c64 * c64))


def _occupancy_np(packed: np.ndarray, norb: int) -> np.ndarray:
    """Host (N, norb) 0/1 occupation matrix from packed uint32 strings."""
    packed = np.asarray(packed, np.uint32)
    out = np.empty((packed.shape[0], norb), np.float64)
    for p in range(norb):
        out[:, p] = (packed[:, p // 32] >> (p % 32)) & 1
    return out


def _hdiag_np(occ_a, occ_b, h1e, eri) -> np.ndarray:
    """Diagonal ``<Ia Ib|H|Ia Ib>`` on the host in f64."""
    a_part, b_part, w = _hdiag_parts_np(occ_a, occ_b, h1e, eri)
    return a_part[:, None] + b_part[None, :] + occ_a @ w.T


def _hdiag_parts_np(occ_a, occ_b, h1e, eri):
    """Rank-structured pieces: ``hd = a_part[:, None] + b_part[None, :] + occ_a @ w.T``."""
    h1e = np.asarray(h1e, np.float64)
    eri = np.asarray(eri, np.float64)
    hd = np.diagonal(h1e)
    jm = np.einsum("ppqq->pq", eri)
    km = np.einsum("pqqp->pq", eri)
    jk = jm - km
    a_part = occ_a @ hd + 0.5 * np.einsum("ip,pq,iq->i", occ_a, jk, occ_a)
    b_part = occ_b @ hd + 0.5 * np.einsum("ip,pq,iq->i", occ_b, jk, occ_b)
    w = occ_b @ jm.T
    return a_part, b_part, w


def _auto_col_block(npair: int, m_pad: int, n_pad: int) -> int:
    """Beta-column block size of ``sqd_tpu``'s cross-spin channel (0 = unblocked)."""
    budget_elems = 320 * 1024 * 1024
    if npair * m_pad * n_pad <= budget_elems:
        return 0
    blk_elems = 48 * 1024 * 1024
    cb = max(128, min(n_pad, blk_elems // (npair * m_pad)))
    cb = max(128, (cb // 128) * 128)
    hard_cap_elems = 144 * 1024 * 1024
    if npair * m_pad * cb > hard_cap_elems:
        cb = max(8, (hard_cap_elems // (npair * m_pad) // 8) * 8)
    return cb if cb < n_pad else 0


def _check_weights(strs_a_packed, strs_b_packed, nelec) -> None:
    for name, packed, want in (
        ("alpha", strs_a_packed, nelec[0]),
        ("beta", strs_b_packed, nelec[1]),
    ):
        counts = np.bitwise_count(np.asarray(packed, np.uint32)).sum(axis=-1)
        if counts.size and not np.all(counts == want):
            bad = int(counts[counts != want][0])
            raise ValueError(
                f"{name} CI strings have Hamming weight {bad}, expected nelec = {want}"
            )


def build_sci_basis(
    strs_a_packed: np.ndarray,
    strs_b_packed: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    device,
) -> SCIBasis:
    """Gather-table-only basis view (for RDM/S^2 queries), on ``device``."""
    src_a, sign_a = native.gather_tables(np.asarray(strs_a_packed), norb)
    src_b, sign_b = native.gather_tables(np.asarray(strs_b_packed), norb)
    return SCIBasis(
        src_a=torch.as_tensor(src_a, dtype=torch.int64, device=device),
        sign_a=torch.as_tensor(sign_a, device=device),
        src_b=torch.as_tensor(src_b, dtype=torch.int64, device=device),
        sign_b=torch.as_tensor(sign_b, device=device),
        norb=int(norb),
        nelec=tuple(int(x) for x in nelec),
    )


def build_sci_hamiltonian(
    strs_a_packed: np.ndarray,
    strs_b_packed: np.ndarray,
    h1e: np.ndarray,
    eri: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    device,
    spin_shift: float = 0.0,
    spin_target: float = 0.0,
    dtype: torch.dtype = torch.float64,
    pad_to: tuple[int, int] | None = None,
    table_cache=None,
    eri_factor: np.ndarray | str | None = "auto",
) -> SCIHamiltonian:
    """Assemble the projected Hamiltonian on ``device`` from native host tables.

    The native branch of ``sqd_tpu.ops.hamiltonian.build_sci_hamiltonian``
    with its default ``col_block="auto"``: the same padding (``pad_to``;
    clamped tables extended with zero weights, padded diagonal entries at
    1e30) and the same automatic column-block / alignment rule.  The diagonal
    is always assembled on the host in f64.  A ``table_cache``
    (:class:`sqd_tpu_torch.ops.table_cache.TableCache`) supplies the tables
    where ``sqd_tpu`` would use it: packed width <= 2 words and at most 4096
    same-spin candidates per string on both spins; the tables are the same
    either way.  A Cholesky ``eri_factor`` (an explicit factor, or ``"auto"``
    with ``norb**2 > 256``) is not ported yet and raises.
    """
    m, n = np.asarray(strs_a_packed).shape[0], np.asarray(strs_b_packed).shape[0]
    n_a, n_b = (int(x) for x in nelec)
    _check_weights(strs_a_packed, strs_b_packed, (n_a, n_b))
    npair = norb * norb
    if isinstance(eri_factor, np.ndarray) or (eri_factor == "auto" and npair > 256):
        raise NotImplementedError(
            "the Cholesky-factored cross-spin contraction (eri_factor) is not ported "
            "yet; pass eri_factor=None (see ROADMAP.md)"
        )
    if eri_factor not in (None, "auto"):
        raise ValueError(f"unknown eri_factor {eri_factor!r}")
    m_pad, n_pad = pad_to if pad_to is not None else (m, n)
    if m_pad < m or n_pad < n:
        raise ValueError(f"pad_to {pad_to} smaller than subspace ({m}, {n})")
    col_block = _auto_col_block(npair, m_pad, n_pad)
    if npair * m_pad * n_pad > 32 * 1024 * 1024:
        m_pad = -(-m_pad // 8) * 8
        n_pad = -(-n_pad // 128) * 128
    if col_block:
        n_pad = -(-n_pad // col_block) * col_block
    pad_m, pad_n = m_pad - m, n_pad - n

    h1_np = np.asarray(h1e, np.float64)
    eri_np = np.asarray(eri, np.float64)
    # the cache stores per-string rows at the full candidate width: at high
    # filling that width explodes and the direct build is the cheaper one
    cached = (
        table_cache is not None
        and table_cache.usable(np.asarray(strs_a_packed))
        and max(native.samespin_width(norb, n_a), native.samespin_width(norb, n_b)) <= 4096
    )
    tables = table_cache if cached else native
    src_a, sign_a = tables.gather_tables(strs_a_packed, norb)
    src_b, sign_b = tables.gather_tables(strs_b_packed, norb)
    ia, va = tables.samespin_tables(strs_a_packed, h1_np, eri_np, norb, n_a)
    ib, vb = tables.samespin_tables(strs_b_packed, h1_np, eri_np, norb, n_b)
    occ_a = _occupancy_np(strs_a_packed, norb)
    occ_b = _occupancy_np(strs_b_packed, norb)
    hd = _hdiag_np(occ_a, occ_b, h1_np, eri_np)
    if pad_m or pad_n:
        src_a = np.pad(src_a, ((0, 0), (0, pad_m)))
        sign_a = np.pad(sign_a, ((0, 0), (0, pad_m)))
        src_b = np.pad(src_b, ((0, 0), (0, pad_n)))
        sign_b = np.pad(sign_b, ((0, 0), (0, pad_n)))
        ia = np.pad(ia, ((0, pad_m), (0, 0)))
        va = np.pad(va, ((0, pad_m), (0, 0)))
        ib = np.pad(ib, ((0, pad_n), (0, 0)))
        vb = np.pad(vb, ((0, pad_n), (0, 0)))
        hd = np.pad(hd, ((0, pad_m), (0, pad_n)), constant_values=1e30)
    eri_t = np.ascontiguousarray(eri_np.reshape(npair, npair).T)

    def idx(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    def val(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return SCIHamiltonian(
        src_a=idx(src_a),
        sign_a=torch.as_tensor(sign_a, device=device),
        src_b=idx(src_b),
        sign_b=torch.as_tensor(sign_b, device=device),
        nbr_idx_a=idx(ia),
        nbr_val_a=val(va),
        nbr_idx_b=idx(ib),
        nbr_val_b=val(vb),
        eri_t=val(eri_t),
        hdiag=val(hd),
        norb=int(norb),
        nelec=(n_a, n_b),
        spin_shift=float(spin_shift),
        spin_target=float(spin_target),
        col_block=col_block,
    )
