# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Selected-CI Hamiltonian application over a (strs_a x strs_b) product basis.

The PyTorch port of ``sqd_tpu.ops.hamiltonian``.  Because the subspace is a
Cartesian product, the projected Hamiltonian splits exactly into

    P H P = H_aa (x) I   +   I (x) H_bb   +   H_ab

* ``H_ab = sum_pqrs (pq|rs) E^a_pq E^b_rs`` (opposite spin): per-pair gathers,
  one matmul over the ``norb^2`` pair axis, gathers back.  In f32 it runs
  through :mod:`sqd_tpu_torch.ops.cross_spin` (the CUDA kernel on the card);
  in f64 through :meth:`SCIHamiltonian._matvec_full`, or past
  ``sqd_tpu``'s size budget through the column-blocked
  :meth:`SCIHamiltonian._matvec_blocked`, as ``sqd_tpu`` sends f64 to XLA
  and only f32 to its Pallas kernel.
* ``H_aa`` / ``H_bb`` (same spin): padded Slater-Condon neighbour lists
  applied as row/column gathers.

The optional spin penalty ``shift * (S^2 - target)`` is exact in the product
basis too.  Padded determinants have zero couplings and a 1e30 diagonal, so
they stay exactly zero through the Krylov iteration.

Index tables are stored as int64 — the dtype torch's gathers take — once at
build time, never converted per matvec.

The blocking thresholds below are ``sqd_tpu``'s, sized for a TPU's memory,
and kept so that the port takes ``sqd_tpu``'s path for every shape.
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
    "build_samespin_tables",
    "build_sci_basis",
    "build_sci_hamiltonian",
    "expectation_value",
    "pivoted_cholesky_pairs",
    "sci_matvec_flat",
]

# Padded M*N from which the f64 diagonal is assembled on the device from its
# rank-structured parts instead of being uploaded whole.
DEVICE_DIAG_MIN_ELEMS = 4_000_000
# Column blocking of the f64 cross-spin channel: unblocked up to this many
# (npair x M x N) elements; past it, blocks of about COL_BLOCK_TILE_ELEMS,
# at least 128 columns unless one block would pass COL_BLOCK_CAP_ELEMS.
COL_BLOCK_BUDGET_ELEMS = 320 * 1024 * 1024
COL_BLOCK_TILE_ELEMS = 48 * 1024 * 1024
COL_BLOCK_CAP_ELEMS = 144 * 1024 * 1024
# Largest full (M, N, npair) G buffer of the two-pass blocked matvec; past it
# the beta-first single pass runs.
TWO_PASS_G_BYTES = 4 * 1024**3
# Largest gathered neighbour tensor of a same-spin channel.  XLA fuses that
# gather into its contraction; torch materialises it, so above this size the
# channel runs in column (alpha) or row (beta) chunks.
SAMESPIN_CHUNK_BYTES = 1024**3


def _chunk(total: int, bytes_per_item: int) -> int:
    """Items per chunk so that a chunk's gathered tensor stays within
    ``SAMESPIN_CHUNK_BYTES`` (``total`` when everything fits)."""
    return max(1, min(total, SAMESPIN_CHUNK_BYTES // max(bytes_per_item, 1)))


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
    # optional pivoted-Cholesky factor L (X, npair) of the PSD pair matrix
    # V[pq, rs] = (pq|rs) = (L^T L)[pq, rs]: f32 contractions outside the
    # kernel go through it; f64 always uses the exact eri_t
    eri_chol: torch.Tensor | None = None
    spin_shift: float = 0.0  # penalty shift * (S^2 - spin_target); 0 disables
    spin_target: float = 0.0
    col_block: int = 0  # beta-column block of the f64 cross-spin channel; 0 = unblocked

    def astype(self, dtype: torch.dtype) -> "SCIHamiltonian":
        """Cast the floating-point payload once (so matvecs avoid per-call casts)."""
        return dataclasses.replace(
            self,
            eri_t=self.eri_t.to(dtype),
            nbr_val_a=self.nbr_val_a.to(dtype),
            nbr_val_b=self.nbr_val_b.to(dtype),
            hdiag=self.hdiag.to(dtype),
            eri_chol=None if self.eri_chol is None else self.eri_chol.to(dtype),
        )

    def _use_chol(self, dtype: torch.dtype) -> bool:
        """The factored contraction is for f32 only."""
        return self.eri_chol is not None and dtype == torch.float32

    def _chol_left(self, flat: torch.Tensor) -> torch.Tensor:
        """``V @ flat`` through the factor.  ``V`` is symmetric (the factor is
        attached only to a symmetric PSD pair matrix), so this also serves
        the ``eri_t.T @ flat`` of the blocked paths."""
        lf = self.eri_chol.to(flat.dtype)
        return lf.T @ (lf @ flat)

    def _chol_right(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat @ V`` through the factor."""
        lf = self.eri_chol.to(flat.dtype)
        return (flat @ lf.T) @ lf

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
        """``(H_aa (x) I) c`` via the neighbour list (row gathers), in column
        chunks when the gathered ``(M, La, N)`` tensor would be too large."""
        vals = self.nbr_val_a.to(c.dtype)
        m, n = c.shape
        step = _chunk(n, m * self.nbr_idx_a.shape[1] * c.element_size())
        if step == n:
            return torch.einsum("jl,jln->jn", vals, c[self.nbr_idx_a])
        out = torch.empty_like(c)
        for j0 in range(0, n, step):
            picked = c[:, j0 : j0 + step][self.nbr_idx_a]  # (M, La, step)
            out[:, j0 : j0 + step] = torch.einsum("jl,jln->jn", vals, picked)
        return out

    def apply_samespin_beta(self, c: torch.Tensor) -> torch.Tensor:
        """``(I (x) H_bb) c`` via the neighbour list (column gathers), in row
        chunks when the gathered ``(M, N, Lb)`` tensor would be too large."""
        vals = self.nbr_val_b.to(c.dtype)
        m, n = c.shape
        step = _chunk(m, n * self.nbr_idx_b.shape[1] * c.element_size())
        if step == m:
            return torch.einsum("kl,mkl->mk", vals, c[:, self.nbr_idx_b])
        out = torch.empty_like(c)
        for i0 in range(0, m, step):
            picked = c[i0 : i0 + step][:, self.nbr_idx_b]  # (step, N, Lb)
            out[i0 : i0 + step] = torch.einsum("kl,mkl->mk", vals, picked)
        return out

    def matvec(self, c: torch.Tensor) -> torch.Tensor:
        """``sigma = (P H P) c`` (+ the spin penalty if configured).

        f32 goes through the cross-spin kernel wrapper (the Pallas dispatch of
        ``sqd_tpu``, which also takes only f32; the kernel covers every
        shape); every other dtype through :meth:`_matvec_blocked` when the
        operator is column-blocked, else :meth:`_matvec_full`.
        """
        with highest_precision():
            if c.dtype == torch.float32:
                return self._matvec_kernel(c)
            if self.col_block and c.shape[1] > self.col_block:
                return self._matvec_blocked(c)
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
        flat = d_a.reshape(npair, m * n)
        if self._use_chol(c.dtype):
            g = self._chol_left(flat).reshape(npair, m, n)
        else:
            g = (self.eri_t.to(c.dtype) @ flat).reshape(npair, m, n)
        sigma = self.scatter_beta(g)
        del g
        sigma = sigma + self.apply_samespin_alpha(c) + self.apply_samespin_beta(c)
        if self.spin_shift != 0.0:
            s2c = self.s2_apply_from_alpha(d_a, c)
            sigma = sigma + self.spin_shift * (s2c - self.spin_target * c)
        return sigma

    def _matvec_blocked(self, c: torch.Tensor) -> torch.Tensor:
        """Column-blocked application; the variant is chosen by the G buffer.

        The alpha-first two pass keeps a full ``(M, N, npair)`` G buffer; past
        ``TWO_PASS_G_BYTES`` the beta-first single pass runs, which holds
        only one column block's intermediates at a time.
        """
        m, n = c.shape
        g_bytes = self.norb * self.norb * m * n * c.element_size()
        with highest_precision():
            if g_bytes <= TWO_PASS_G_BYTES:
                return self.__matvec_blocked(c)
            return self.__matvec_blocked_beta_first_rowmajor(c)

    def _block_size(self, n: int) -> int:
        cb = self.col_block
        if n % cb:
            raise ValueError(f"N = {n} must be a multiple of col_block = {cb}")
        return cb

    def _s2_penalty_tables(self, dtype):
        """Beta tables at the qp-permuted pairs (the penalty's mixed term)."""
        perm = torch.as_tensor(self._qp_perm(), device=self.src_b.device)
        return self.src_b[perm], self.sign_b[perm].to(dtype)

    def __matvec_blocked_beta_first_rowmajor(self, c: torch.Tensor) -> torch.Tensor:
        """Beta-first single pass: per column block, gather the beta side from
        rows of ``c.T``, contract the pair axis, and pick the alpha side through
        each alpha row's compacted valid pairs (``ka`` of them)."""
        dt = c.dtype
        m, n = c.shape
        npair = self.norb * self.norb
        cb = self._block_size(n)
        ct = c.T.contiguous()  # (n, m): the beta gathers read contiguous rows
        sign_a_f = self.sign_a.to(dt)
        sign_b_f = self.sign_b.to(dt)
        # per alpha row, its valid pairs as flat row indices into
        # g2.reshape(npair * m, cb)
        n_a = int(self.nelec[0])
        ka = min(npair, n_a * (self.norb - n_a + 1))
        valid_a = self.sign_a != 0  # (npair, M)
        order_a = torch.argsort((~valid_a).to(torch.uint8), dim=0, stable=True)[:ka]
        ok_a = torch.gather(valid_a, 0, order_a)
        src_sel = torch.gather(self.src_a, 0, order_a)
        flat_rows = (order_a * m + src_sel).T.reshape(-1)  # (M * ka,)
        sign_sel = torch.where(ok_a, torch.gather(sign_a_f, 0, order_a), 0.0).T  # (M, ka)
        nbr_val_a_f = self.nbr_val_a.to(dt)
        nbr_val_b_f = self.nbr_val_b.to(dt)
        eri_m = self.eri_t.to(dt).T  # [pq, rs] = (pq|rs)
        with_penalty = self.spin_shift != 0.0
        if with_penalty:
            src_qp, sign_qp = self._s2_penalty_tables(dt)
            src_a_idx = self.src_a[:, :, None].expand(npair, m, cb)
        sigma = torch.empty((m, n), dtype=dt, device=c.device)
        for b0 in range(0, n, cb):
            cols = slice(b0, b0 + cb)
            # D_b in (npair, cb, m): row gathers of ct
            db = ct[self.src_b[:, cols]] * sign_b_f[:, cols, None]
            flat = db.reshape(npair, cb * m)
            del db
            g2 = self._chol_left(flat) if self._use_chol(dt) else eri_m @ flat
            del flat
            # (npair, m, cb), so that the alpha pick reads contiguous cb-runs
            g2 = g2.reshape(npair, cb, m).transpose(1, 2).contiguous()
            picked = g2.reshape(npair * m, cb)[flat_rows]  # (M * ka, cb)
            del g2
            sig = torch.einsum("mk,mkc->mc", sign_sel, picked.reshape(m, ka, cb))
            del picked
            c_blk = c[:, cols]
            sig += torch.einsum("jl,jlc->jc", nbr_val_a_f, c_blk[self.nbr_idx_a])
            # same-spin beta of these output columns: row gathers of ct
            picked_b = ct[self.nbr_idx_b[cols]]  # (cb, Lb, m)
            sig += torch.einsum("kl,klm->mk", nbr_val_b_f[cols], picked_b)
            del picked_b
            if with_penalty:
                # mixed term: c picked at the qp-permuted beta columns, then
                # at the alpha sources along m
                picked_m = ct[src_qp[:, cols]].transpose(1, 2)  # (npair, m, cb)
                picked_m = torch.gather(picked_m, 1, src_a_idx)
                mixed = torch.einsum(
                    "pj,pc,pjc->jc", sign_a_f, sign_qp[:, cols], picked_m)
                del picked_m
                sig += self.spin_shift * (
                    (self._s2_const() - self.spin_target) * c_blk - mixed)
            sigma[:, cols] = sig
        return sigma

    def __matvec_blocked(self, c: torch.Tensor) -> torch.Tensor:
        """Alpha-first two pass: pass 1 contracts each column block's alpha
        gathers into the full ``(M, N, npair)`` G buffer; pass 2 picks the
        beta side out of it, block by block."""
        dt = c.dtype
        m, n = c.shape
        npair = self.norb * self.norb
        cb = self._block_size(n)
        sign_a_f = self.sign_a.to(dt)
        eri_m = self.eri_t.to(dt).T  # [pq, rs] = (pq|rs)
        with_penalty = self.spin_shift != 0.0
        gt = torch.empty((m, n, npair), dtype=dt, device=c.device)
        dat = torch.empty((m, n, npair), dtype=dt, device=c.device) if with_penalty else None
        for b0 in range(0, n, cb):
            cols = slice(b0, b0 + cb)
            d = sign_a_f[:, :, None] * c[:, cols][self.src_a]  # (npair, m, cb)
            d_t = d.permute(1, 2, 0)  # (m, cb, npair)
            flat = d_t.reshape(m * cb, npair)
            g_blk = self._chol_right(flat) if self._use_chol(dt) else flat @ eri_m
            gt[:, cols] = g_blk.reshape(m, cb, npair)
            if with_penalty:
                dat[:, cols] = d_t
        if with_penalty:
            src_qp, sign_qp = self._s2_penalty_tables(dt)
        sign_b_f = self.sign_b.to(dt)
        nbr_val_a_f = self.nbr_val_a.to(dt)
        nbr_val_b_f = self.nbr_val_b.to(dt)
        pairs = torch.arange(npair, device=c.device)[None, :]
        sigma = torch.empty((m, n), dtype=dt, device=c.device)
        for b0 in range(0, n, cb):
            cols = slice(b0, b0 + cb)
            # cross-spin: sum_rs sign_b[rs, col] * G'[j, src_b[rs, col], rs]
            picked = gt[:, self.src_b[:, cols].T, pairs]  # (m, cb, npair)
            sig = torch.einsum("jcr,rc->jc", picked, sign_b_f[:, cols])
            del picked
            blk = c[:, cols]
            sig += torch.einsum("jl,jlc->jc", nbr_val_a_f, blk[self.nbr_idx_a])
            # same-spin beta of these output columns (gathers across blocks)
            picked_b = c[:, self.nbr_idx_b[cols]]  # (m, cb, Lb)
            sig += torch.einsum("kl,mkl->mk", nbr_val_b_f[cols], picked_b)
            if with_penalty:
                picked_s2 = dat[:, src_qp[:, cols].T, pairs]
                mixed = torch.einsum("jcr,rc->jc", picked_s2, sign_qp[:, cols])
                sig += self.spin_shift * (
                    self._s2_const() * blk - mixed - self.spin_target * blk)
            sigma[:, cols] = sig
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


def _hdiag_device(a_part, b_part, occ_a, w, *, dtype) -> torch.Tensor:
    """The exact ``(M, N)`` diagonal assembled on the parts' device.

    ``hd[i, j] = a_part[i] + b_part[j] + sum_p occ_a[i, p] * w[j, p]``, with
    the ``norb`` adds in ``sqd_tpu``'s order: ``occ_a`` is 0/1, so every
    product is exact and each add rounds once, as on the host.
    """
    acc = a_part[:, None] + b_part[None, :]
    for p in range(occ_a.shape[1]):
        acc.addcmul_(occ_a[:, p : p + 1], w[None, :, p])
    return acc.to(dtype)


def pivoted_cholesky_pairs(
    eri: np.ndarray, norb: int, *, tol: float = 1e-13, max_rank: int | None = None
) -> np.ndarray | None:
    """Pivoted Cholesky factor ``L (X, npair)`` of ``V[pq, rs] = (pq|rs)``
    (a NumPy copy of ``sqd_tpu``'s): ``V = L^T L`` to ``tol`` relative.

    ``None`` when ``V`` is not symmetric PSD to ``tol``, when ``max_rank``
    runs out before convergence, or when the reconstruction check fails.
    """
    npair = norb * norb
    v = np.asarray(eri, np.float64).reshape(npair, npair)
    if not np.array_equal(v, v.T) and not np.allclose(v, v.T, atol=1e-12, rtol=0.0):
        return None
    d = np.diagonal(v).copy()
    d0 = float(d.max(initial=0.0))
    if d0 <= 0.0:
        return None
    cap = npair if max_rank is None else int(max_rank)
    ell = np.zeros((cap, npair))
    k = 0
    converged = False
    while k < cap:
        p = int(np.argmax(d))
        piv = float(d[p])
        if piv <= tol * d0:
            converged = True
            break
        row = v[p] - ell[:k, p] @ ell[:k]
        ell[k] = row / np.sqrt(piv)
        d -= ell[k] * ell[k]
        d[p] = 0.0
        k += 1
    if not converged and float(d.max(initial=0.0)) > tol * d0:
        return None
    ell = ell[:k].copy()
    if k == 0:
        return None
    # the recursion assumes PSD: check the reconstruction before trusting it
    err = float(np.abs(ell.T @ ell - v).max())
    if err > 100.0 * tol * d0:
        return None
    return ell


def _auto_col_block(npair: int, m_pad: int, n_pad: int) -> int:
    """Beta-column block size of ``sqd_tpu``'s cross-spin channel (0 = unblocked)."""
    if npair * m_pad * n_pad <= COL_BLOCK_BUDGET_ELEMS:
        return 0
    cb = max(128, min(n_pad, COL_BLOCK_TILE_ELEMS // (npair * m_pad)))
    cb = max(128, (cb // 128) * 128)
    if npair * m_pad * cb > COL_BLOCK_CAP_ELEMS:
        cb = max(8, (COL_BLOCK_CAP_ELEMS // (npair * m_pad) // 8) * 8)
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


def build_samespin_tables(*args, **kwargs):
    """The device build of the same-spin neighbour lists
    (``sqd_tpu.ops.hamiltonian.build_samespin_tables``): not ported yet; the
    lists come from :func:`sqd_tpu_torch.native.samespin_tables`."""
    raise NotImplementedError("build_samespin_tables is not ported yet; see ROADMAP.md")


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
    col_block: int | str = "auto",
    table_cache=None,
    eri_factor: np.ndarray | str | None = "auto",
) -> SCIHamiltonian:
    """Assemble the projected Hamiltonian on ``device`` from native host tables.

    The native branch of ``sqd_tpu.ops.hamiltonian.build_sci_hamiltonian``:
    the same padding (``pad_to``; clamped tables extended with zero weights,
    padded diagonal entries at 1e30), the same ``col_block`` (``"auto"``:
    :func:`_auto_col_block` and the alignment rule; an int: that block, 0 for
    none; ``N`` is padded to a multiple of it) and the same ``eri_factor``
    (``"auto"``: :func:`pivoted_cholesky_pairs` with rank at most
    ``npair // 3`` when ``npair > 256``, kept if it succeeds; ``None``: no
    factor; an ``(X, npair)`` array: used as given).  The f64 diagonal is
    computed on the host, or from ``DEVICE_DIAG_MIN_ELEMS`` padded
    determinants on, assembled on ``device`` from its rank-structured parts.
    A ``table_cache`` (:class:`sqd_tpu_torch.ops.table_cache.TableCache`)
    supplies the tables where ``sqd_tpu`` would use it: packed width <= 2
    words and at most 4096 same-spin candidates per string on both spins;
    the tables are the same either way.
    """
    m, n = np.asarray(strs_a_packed).shape[0], np.asarray(strs_b_packed).shape[0]
    n_a, n_b = (int(x) for x in nelec)
    _check_weights(strs_a_packed, strs_b_packed, (n_a, n_b))
    npair = norb * norb
    m_pad, n_pad = pad_to if pad_to is not None else (m, n)
    if m_pad < m or n_pad < n:
        raise ValueError(f"pad_to {pad_to} smaller than subspace ({m}, {n})")
    if col_block == "auto":
        col_block = _auto_col_block(npair, m_pad, n_pad)
        if npair * m_pad * n_pad > 32 * 1024 * 1024:
            m_pad = -(-m_pad // 8) * 8
            n_pad = -(-n_pad // 128) * 128
    col_block = int(col_block)
    if col_block:
        n_pad = -(-n_pad // col_block) * col_block
    pad_m, pad_n = m_pad - m, n_pad - n

    h1_np = np.asarray(h1e, np.float64)
    eri_np = np.asarray(eri, np.float64)
    eri_chol = None
    if isinstance(eri_factor, np.ndarray):
        eri_chol = np.ascontiguousarray(eri_factor, np.float64)
        if eri_chol.ndim != 2 or eri_chol.shape[1] != npair:
            raise ValueError(f"eri_factor must be (X, {npair}), got {eri_chol.shape}")
    elif eri_factor == "auto" and npair > 256:
        eri_chol = pivoted_cholesky_pairs(eri_np, norb, max_rank=npair // 3)
    elif eri_factor not in (None, "auto"):
        raise ValueError(f"unknown eri_factor {eri_factor!r}")
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
    if pad_m or pad_n:
        src_a = np.pad(src_a, ((0, 0), (0, pad_m)))
        sign_a = np.pad(sign_a, ((0, 0), (0, pad_m)))
        src_b = np.pad(src_b, ((0, 0), (0, pad_n)))
        sign_b = np.pad(sign_b, ((0, 0), (0, pad_n)))
        ia = np.pad(ia, ((0, pad_m), (0, 0)))
        va = np.pad(va, ((0, pad_m), (0, 0)))
        ib = np.pad(ib, ((0, pad_n), (0, 0)))
        vb = np.pad(vb, ((0, pad_n), (0, 0)))
    eri_t = np.ascontiguousarray(eri_np.reshape(npair, npair).T)

    def idx(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    def val(x):
        return torch.as_tensor(x, device=device).to(dtype)

    if m_pad * n_pad >= DEVICE_DIAG_MIN_ELEMS:
        # only the O((M + N) * norb) parts cross to the device
        a_part, b_part, w = _hdiag_parts_np(occ_a, occ_b, h1_np, eri_np)
        hd = _hdiag_device(
            torch.as_tensor(np.pad(a_part, (0, pad_m), constant_values=1e30), device=device),
            torch.as_tensor(np.pad(b_part, (0, pad_n), constant_values=1e30), device=device),
            torch.as_tensor(np.pad(occ_a, ((0, pad_m), (0, 0))), device=device),
            torch.as_tensor(np.pad(w, ((0, pad_n), (0, 0))), device=device),
            dtype=dtype,
        )
    else:
        hd = val(np.pad(_hdiag_np(occ_a, occ_b, h1_np, eri_np), ((0, pad_m), (0, pad_n)),
                        constant_values=1e30))

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
        hdiag=hd,
        eri_chol=None if eri_chol is None else torch.as_tensor(eri_chol, device=device),
        norb=int(norb),
        nelec=(n_a, n_b),
        spin_shift=float(spin_shift),
        spin_target=float(spin_target),
        col_block=col_block,
    )
