# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Selected-CI Hamiltonian application over a (strs_a x strs_b) product basis.

The PyTorch port of ``sqd_tpu.ops.hamiltonian``.  Because the subspace is a
Cartesian product, the projected Hamiltonian splits exactly into

    P H P = H_aa (x) I   +   I (x) H_bb   +   H_ab

* ``H_ab = sum_pqrs (pq|rs) E^a_pq E^b_rs`` (opposite spin): per-pair gathers,
  one matmul over the ``norb^2`` pair axis, gathers back.  In f32 it runs
  through :mod:`sqd_tpu_torch.ops.cross_spin` (the f32 CUDA kernel on the
  card).  In f64, the exact operator, it runs on the card through the f64
  CUDA kernel of the same module, which contracts only the excitations that
  stay in the subspace; on the CPU through the dense
  :meth:`SCIHamiltonian._matvec_dense`, or past ``sqd_tpu``'s size budget
  through the column-blocked :meth:`SCIHamiltonian._matvec_blocked`, as
  ``sqd_tpu`` sends f64 to XLA's dense route and only f32 to its Pallas
  kernel.  Every route contracts the exact ``eri_t``.
* ``H_aa`` / ``H_bb`` (same spin): padded Slater-Condon neighbour lists
  applied as row/column gathers.

The tables come from the native host build (``tables_backend="native"``, and
``"auto"`` on the CPU), from its CUDA port on the card (``"auto"`` on a CUDA
device, a cache given or not: :mod:`sqd_tpu_torch.ops.card_tables`, the same
tables bit for bit), from a :class:`sqd_tpu_torch.ops.table_cache.TableCache`
where one is given to a host route (the same tables again), or are built on
the device from the packed strings as torch ops (``"device"``:
:func:`sqd_tpu_torch.ops.linktab.build_gather_tables` and
:func:`build_samespin_tables`).

The optional spin penalty ``shift * (S^2 - target)`` is exact in the product
basis too.  Padded determinants have zero couplings and a 1e30 diagonal, so
they stay exactly zero through the Krylov iteration.

Index tables are stored as int64 — the dtype torch's gathers take — once at
build time, never converted per matvec.

An operator carries only what its route reads: :func:`padded_layout` gives a
column block only where the CPU's blocked f64 route runs, and the pair
factor ``eri_chol`` is read only by :mod:`sqd_tpu_torch.ops.dense_df` and
:mod:`sqd_tpu_torch.parallel.df_sharded`.

The blocking thresholds below are ``sqd_tpu``'s, sized for a TPU's memory,
and kept so that the port takes ``sqd_tpu``'s path for every shape on the
CPU (the card's kernels make no dense intermediates to bound).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..utils.device import checked_device
from ..utils.tracing import span
from . import bitpack, card_tables, cross_spin, linktab
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
# Device bytes one row chunk of the device same-spin build may hold: per
# candidate, its string and the three partial strings of the double parity,
# the binary search's state and the values, about (12 + 6 W) 8-byte values.
SAMESPIN_BUILD_BYTES = 1024**3


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
    # V[pq, rs] = (pq|rs) = (L^T L)[pq, rs]: read only by ops/dense_df and
    # parallel/df_sharded; every matvec here contracts the exact eri_t
    eri_chol: torch.Tensor | None = None
    spin_shift: float = 0.0  # penalty shift * (S^2 - spin_target); 0 disables
    spin_target: float = 0.0
    col_block: int = 0  # beta-column block of the f64 cross-spin channel; 0 = unblocked

    def astype(self, dtype: torch.dtype) -> "SCIHamiltonian":
        """Cast the floating-point payload once (so matvecs avoid per-call casts).

        An operator whose payload is all in ``dtype`` already is returned
        itself, with its cached cross-spin operands; a cast copy shares this
        operator's compacted cross-spin tables (:meth:`cross_spin_operands`).
        """
        payload = (self.eri_t, self.nbr_val_a, self.nbr_val_b, self.hdiag, self.eri_chol)
        if all(t is None or t.dtype == dtype for t in payload):
            return self
        out = dataclasses.replace(
            self,
            eri_t=self.eri_t.to(dtype),
            nbr_val_a=self.nbr_val_a.to(dtype),
            nbr_val_b=self.nbr_val_b.to(dtype),
            hdiag=self.hdiag.to(dtype),
            eri_chol=None if self.eri_chol is None else self.eri_chol.to(dtype),
        )
        return _sharing_tables(out, self)

    def cross_spin_operands(self, dtype: torch.dtype = torch.float32
                            ) -> cross_spin.CrossSpinOperands:
        """The cross-spin operands in ``dtype`` (f32 for the f32 kernel, f64
        for the f64 one) with the penalty folded into ``eri``.

        Built on first use and cached on this operator, one set a dtype.  The
        compacted tables do not depend on the dtype: they are built once and
        shared by every set, and with the copies :meth:`astype` makes.  The
        spin penalty's mixed term ``-shift * sum_pq E^a_pq E^b_qp`` has the
        same (coefficient x alpha gather x beta gather) shape as the
        cross-spin contraction, so ``-shift`` goes into ``eri[qp, pq]``.
        """
        cache = self.__dict__.setdefault("_cross_spin_operands", {})
        ops = cache.get(dtype)
        if ops is None:
            eri = self.penalty_folded_eri(dtype)
            tables = self.__dict__.setdefault("_cross_spin_tables", [])
            if tables:
                ops = cross_spin.with_eri(tables[0], eri)
            else:
                ops = cross_spin.prepare(self.src_a, self.sign_a, self.src_b, self.sign_b, eri)
                tables.append(ops)
            cache[dtype] = ops
        return ops

    def penalty_folded_eri(self, dtype: torch.dtype) -> torch.Tensor:
        """``eri_t`` in ``dtype`` (a copy) with the spin penalty's mixed term
        ``-shift * sum_pq E^a_pq E^b_qp`` folded in as ``-shift`` at
        ``[qp, pq]``; the cross-spin contraction with it applies both, and
        ``shift * (const - target) * c`` is what the penalty leaves."""
        eri = self.eri_t.to(dtype, copy=True)
        if self.spin_shift != 0.0:
            npair = self.norb * self.norb
            perm = torch.as_tensor(self._qp_perm(), device=eri.device)
            eri[perm, torch.arange(npair, device=eri.device)] -= self.spin_shift
        return eri

    def apply_samespin_alpha(self, c: torch.Tensor) -> torch.Tensor:
        """``(H_aa (x) I) c`` via the neighbour list (row gathers), in column
        chunks when the gathered ``(M, La, N)`` tensor would be too large.

        The output has one row per row of the list, which may index more rows
        of ``c`` than it has (a row shard's list reads the whole ``c``)."""
        vals = self.nbr_val_a.to(c.dtype)
        m, n = self.nbr_idx_a.shape[0], c.shape[1]
        step = _chunk(n, m * self.nbr_idx_a.shape[1] * c.element_size())
        if step == n:
            return torch.einsum("jl,jln->jn", vals, c[self.nbr_idx_a])
        out = c.new_empty((m, n))
        for j0 in range(0, n, step):
            picked = c[:, j0 : j0 + step][self.nbr_idx_a]  # (M, La, step)
            out[:, j0 : j0 + step] = torch.einsum("jl,jln->jn", vals, picked)
        return out

    def apply_samespin_beta(self, c: torch.Tensor) -> torch.Tensor:
        """``(I (x) H_bb) c`` via the neighbour list (column gathers), in row
        chunks when the gathered ``(M, N, Lb)`` tensor would be too large.

        The output has one column per row of the list, which may index more
        columns of ``c`` than it has (a column shard's list)."""
        vals = self.nbr_val_b.to(c.dtype)
        m, n = c.shape[0], self.nbr_idx_b.shape[0]
        step = _chunk(m, n * self.nbr_idx_b.shape[1] * c.element_size())
        if step == m:
            return torch.einsum("kl,mkl->mk", vals, c[:, self.nbr_idx_b])
        out = c.new_empty((m, n))
        for i0 in range(0, m, step):
            picked = c[i0 : i0 + step][:, self.nbr_idx_b]  # (step, N, Lb)
            out[i0 : i0 + step] = torch.einsum("kl,mkl->mk", vals, picked)
        return out

    def matvec(self, c: torch.Tensor) -> torch.Tensor:
        """``sigma = (P H P) c`` (+ the spin penalty if configured).

        f32 goes through the f32 cross-spin kernel's wrapper (the Pallas
        dispatch of ``sqd_tpu``, which also takes only f32; the kernel covers
        every shape).  Every other dtype is the exact operator,
        :meth:`_matvec_full`: on a CUDA tensor in f64 the f64 cross-spin
        kernel, at any shape; else, as in ``sqd_tpu``, the dense route, which
        is column-blocked (:meth:`_matvec_blocked`) when the operator is.
        """
        with highest_precision():
            if c.dtype == torch.float32:
                with span("matvec.kernel"):
                    return self._matvec_kernel(c)
            if self.col_block and c.shape[1] > self.col_block and not _f64_kernel_takes(c):
                with span("matvec.blocked"):
                    return self._matvec_blocked(c)
            with span("matvec.full"):
                return self._matvec_full(c)

    def apply_cross_spin(self, c: torch.Tensor) -> torch.Tensor:
        """The cross-spin channel (with the penalty's mixed term) by the kernel
        of ``c``'s dtype: :func:`cross_spin.cross_spin_matvec` in f32,
        :func:`cross_spin.cross_spin_matvec_f64` in f64, each
        :func:`cross_spin.cross_spin_plain` on a CPU tensor.  One output row
        per column of the alpha tables, whose sources may index more rows of
        ``c`` (a row shard's tables read the whole ``c``)."""
        ops = self.cross_spin_operands(c.dtype)
        if c.dtype == torch.float32:
            return cross_spin.cross_spin_matvec(c, ops)
        # the exact operator takes any layout, as the dense route did
        return cross_spin.cross_spin_matvec_f64(c.contiguous(), ops)

    def _matvec_kernel(self, c: torch.Tensor) -> torch.Tensor:
        """:meth:`apply_cross_spin` + same-spin + the penalty's diagonal."""
        sigma = self.apply_cross_spin(c)
        with span("matvec.samespin"):
            sigma = sigma + self.apply_samespin_alpha(c) + self.apply_samespin_beta(c)
        if self.spin_shift != 0.0:
            sigma = sigma + self.spin_shift * (self._s2_const() - self.spin_target) * c
        return sigma

    def _matvec_full(self, c: torch.Tensor) -> torch.Tensor:
        """The whole operator at once: on a CUDA tensor in f64 the f64 kernel
        route (:meth:`_matvec_kernel`), which makes no dense intermediates;
        else :meth:`_matvec_dense`."""
        if _f64_kernel_takes(c):
            return self._matvec_kernel(c)
        return self._matvec_dense(c)

    def _matvec_dense(self, c: torch.Tensor) -> torch.Tensor:
        """``sqd_tpu``'s unblocked route: every pair gathered into an
        ``(npair, M, N)`` tensor, one matmul over the pair axis, gathers
        back."""
        m, n = c.shape
        npair = self.norb * self.norb
        d_a = self.gather_alpha(c)  # (npair, M, N)
        # cross-spin: sigma_ab = sum_rs E^b_rs [ sum_pq (pq|rs) E^a_pq c ]
        flat = d_a.reshape(npair, m * n)
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
            g2 = eri_m @ flat
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
            g_blk = flat @ eri_m
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


def _sharing_tables(ham: SCIHamiltonian, source: SCIHamiltonian) -> SCIHamiltonian:
    """``ham``, a copy of ``source`` with the same gather tables, made to
    share ``source``'s compacted cross-spin tables; returns ``ham``."""
    ham.__dict__["_cross_spin_tables"] = source.__dict__.setdefault("_cross_spin_tables", [])
    return ham


def _kernel_routes(device) -> bool:
    """Whether operators on ``device`` apply through the cross-spin kernels in
    every dtype (a CUDA device), so that no dense route runs there."""
    return torch.device(device).type == "cuda"


def _f64_kernel_takes(c: torch.Tensor) -> bool:
    """Whether the exact operator applies to ``c`` through the f64 kernel:
    f64 amplitudes on a device where the kernels route."""
    return c.dtype == torch.float64 and _kernel_routes(c.device)


def sci_matvec_flat(ham: SCIHamiltonian, x: torch.Tensor) -> torch.Tensor:
    """Flat-vector matvec adapter for the Davidson driver."""
    m, n = ham.shape
    return ham.matvec(x.reshape(m, n)).reshape(-1)


def expectation_value(
    ham: SCIHamiltonian, c: torch.Tensor, *, spin_penalty: bool = True
) -> float:
    """``<c|H|c> / <c|c>`` as a plain f64 Rayleigh quotient.

    The card computes in true f64 (on the f64 kernel route of
    :meth:`SCIHamiltonian.matvec`), so ``sqd_tpu``'s chunk-accumulated TPU
    scheme is not needed; this is its CPU branch.  An f64 operator is used
    as it is, with its cached operands.
    """
    m, n = ham.shape
    with span("energy"):
        ham_e = ham.astype(torch.float64)
        if not spin_penalty and ham.spin_shift != 0.0:
            ham_e = _sharing_tables(dataclasses.replace(ham_e, spin_shift=0.0), ham_e)
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


def padded_layout(npair: int, m: int, n: int, pad_to, col_block, device
                  ) -> tuple[int, int, int]:
    """``(m_pad, n_pad, col_block)`` of an operator over ``m x n`` strings on
    ``device``, from ``pad_to`` (``None``: ``(m, n)``).  ``"auto"`` aligns
    rows to 8 and columns to 128 past 32 M ``npair * m_pad * n_pad`` elements
    and takes :func:`_auto_col_block` only where the kernels do not route
    (:func:`_kernel_routes`), else no block; an int is taken as given.
    ``n_pad`` is a multiple of the block."""
    m_pad, n_pad = pad_to if pad_to is not None else (m, n)
    if m_pad < m or n_pad < n:
        raise ValueError(f"pad_to {pad_to} smaller than subspace ({m}, {n})")
    if col_block == "auto":
        col_block = 0 if _kernel_routes(device) else _auto_col_block(npair, m_pad, n_pad)
        if npair * m_pad * n_pad > 32 * 1024 * 1024:
            m_pad = -(-m_pad // 8) * 8
            n_pad = -(-n_pad // 128) * 128
    col_block = int(col_block)
    if col_block:
        n_pad = -(-n_pad // col_block) * col_block
    return m_pad, n_pad, col_block


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


def _candidate_index_arrays(n_occ: int, n_virt: int):
    """Static candidate enumeration: singles (i, k) and doubles (i<j, k<l)."""
    si, sk = np.meshgrid(np.arange(n_occ), np.arange(n_virt), indexing="ij")
    si, sk = si.ravel(), sk.ravel()
    if n_occ >= 2 and n_virt >= 2:
        oi, oj = np.triu_indices(n_occ, k=1)
        vk, vl = np.triu_indices(n_virt, k=1)
        di = np.repeat(oi, len(vk))
        dj = np.repeat(oj, len(vk))
        dk = np.tile(vk, len(oi))
        dl = np.tile(vl, len(oi))
    else:
        di = dj = dk = dl = np.zeros(0, dtype=np.int64)
    return (si, sk), (di, dj, dk, dl)


def _samespin_candidates(strs, rows, h1e, eri, norb: int, nelec_spin: int):
    """Every candidate (neighbour index, Slater-Condon value, valid) of the
    strings ``strs[rows]``, in the order [diagonal, singles, doubles].

    ``strs`` is the whole sorted set as an int64 word tensor, ``rows`` a
    slice of it; values are computed in ``eri``'s dtype.  Returns
    ``(idx, val, valid)``, each ``(len(rows), C)`` with
    ``C = 1 + singles + doubles``, invalid entries clamped to index 0 and
    value 0.
    """
    device, dt = strs.device, eri.dtype
    j_str = strs[rows]  # (R, W)
    r, w = j_str.shape
    occ = linktab.occupancy_matrix(j_str, norb)  # (R, norb) 0/1
    # occupied positions ascending, then virtual positions ascending
    sort_key = (1 - occ) * norb + torch.arange(norb, device=device)
    pos = torch.argsort(sort_key, dim=1)
    occ_pos, virt_pos = pos[:, :nelec_spin], pos[:, nelec_spin:]
    bits = bitpack.to_device_words(bitpack.bit_masks(norb), device)  # (norb, W)
    prefix = bitpack.to_device_words(bitpack.prefix_masks(norb), device)  # (norb+1, W)
    # mean-field weights of the singles, Wx[pq, k] = (pq|kk) - (pk|kq), and
    # the one-spin diagonal occ.h_diag + 1/2 occ (J - K) occ, with no TF32
    with highest_precision():
        wx = (torch.einsum("pqkk->pqk", eri) - torch.einsum("pkkq->pqk", eri)).reshape(
            norb * norb, norb)
        od = occ.to(dt)
        mf = od @ wx.T  # (R, npair)
        jm = torch.einsum("ppqq->pq", eri)
        km = torch.einsum("pqqp->pq", eri)
        diag = od @ torch.diagonal(h1e) + 0.5 * torch.einsum("ip,pq,iq->i", od, jm - km, od)

    def parity(x, t):
        return bitpack.torch_popcount_rows(x & prefix[t])

    def sign_of(par):
        return (1 - 2 * (par & 1)).to(dt)

    def positions(table, cols):
        return table[:, torch.as_tensor(cols, device=device)]  # (R, len(cols))

    (si, sk), (di, dj, dk, dl) = _candidate_index_arrays(nelec_spin, norb - nelec_spin)
    # singles: I = J - p + q, p occupied in J, q virtual in J; the sign of
    # <J|a+_p a_q|I> on I: remove q, then add p
    p, q = positions(occ_pos, si), positions(virt_pos, sk)
    i1 = j_str[:, None, :] ^ bits[p] ^ bits[q]  # (R, ns, W)
    sgn = sign_of(parity(i1, q) + parity(i1, p) - (q < p).to(torch.int32))
    pq = p * norb + q
    val1 = sgn * (h1e[p, q] + torch.gather(mf, 1, pq) - wx.reshape(-1)[pq * norb + p])
    idx1 = bitpack.torch_find_packed(strs, i1.reshape(-1, w)).reshape(pq.shape)
    del i1, sgn, pq
    idx_parts = [torch.arange(rows.start, rows.start + r, device=device)[:, None], idx1]
    val_parts = [diag[:, None], val1]
    if len(di):
        # doubles: I = J - p - r + q + s; g is the sign of a+_p a+_r a_s a_q
        # applied to I (sequential parities)
        dp, dr = positions(occ_pos, di), positions(occ_pos, dj)  # (R, nd)
        dq, ds = positions(virt_pos, dk), positions(virt_pos, dl)
        i2 = j_str[:, None, :] ^ bits[dp] ^ bits[dr] ^ bits[dq] ^ bits[ds]  # (R, nd, W)
        par = parity(i2, dq)
        x = i2 ^ bits[dq]
        par += parity(x, ds)
        x ^= bits[ds]
        par += parity(x, dr)
        x ^= bits[dr]
        par += parity(x, dp)
        del x
        g = sign_of(par)
        eri_flat = eri.reshape(-1)

        def e4(a, b, c, d):
            return eri_flat[((a * norb + b) * norb + c) * norb + d]

        val2 = 0.5 * g * (e4(dp, dq, dr, ds) + e4(dr, ds, dp, dq)
                          - e4(dp, ds, dr, dq) - e4(dr, dq, dp, ds))
        idx2 = bitpack.torch_find_packed(strs, i2.reshape(-1, w)).reshape(dp.shape)
        del i2, g
        idx_parts.append(idx2)
        val_parts.append(val2)
    idx = torch.cat(idx_parts, dim=1)
    val = torch.cat(val_parts, dim=1)
    valid = idx >= 0
    return torch.where(valid, idx, 0), torch.where(valid, val, 0.0), valid


def _compact_candidates(idx, val, valid):
    """Valid candidates first in each row, in their order (a stable sort of
    an int8 key: a bool sort on CUDA is not guaranteed stable), cut to the
    largest valid count."""
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    width = int(valid.sum(dim=1).max()) if valid.shape[0] else 0
    order = order[:, :width]
    return torch.gather(idx, 1, order), torch.gather(val, 1, order)


def build_samespin_tables(strs_packed, h1e, eri, norb: int, nelec_spin: int, *,
                          bucket: int = 8, device="cuda"):
    """Padded Slater-Condon neighbour lists of one spin sector's ``H_ss``
    (diagonal, singles, doubles), built on ``device``.

    The port of ``sqd_tpu.ops.hamiltonian.build_samespin_tables``.  Values are
    computed in the dtype of ``eri`` (a NumPy array or a tensor); rows go in
    chunks within ``SAMESPIN_BUILD_BYTES``, each compacted as it is built.

    Returns ``(idx, val)``: ``(n, L) int64`` and ``(n, L)``, with index 0 and
    value 0 in unused slots.  ``L`` is the largest per-row neighbour count
    rounded up to ``bucket`` (one host sync per chunk).
    """
    device = checked_device(device)
    strs = bitpack.to_device_words(strs_packed, device)
    eri = torch.as_tensor(eri, device=device)
    h1e = torch.as_tensor(h1e, device=device).to(eri.dtype)
    n, w = strs.shape
    nelec_spin = int(nelec_spin)
    n_cand = native.samespin_width(norb, nelec_spin)
    step = max(1, SAMESPIN_BUILD_BYTES // (n_cand * (12 + 6 * w) * 8))
    starts = range(0, n, step)
    chunks = [_compact_candidates(*_samespin_candidates(
        strs, slice(r0, min(r0 + step, n)), h1e, eri, norb, nelec_spin)) for r0 in starts]
    most = max((ci.shape[1] for ci, _ in chunks), default=0)
    width = min(n_cand, max(bucket, -(-most // bucket) * bucket))
    idx = torch.zeros((n, width), dtype=torch.int64, device=device)
    val = torch.zeros((n, width), dtype=eri.dtype, device=device)
    for r0, (ci, cv) in zip(starts, chunks):
        idx[r0 : r0 + ci.shape[0], : ci.shape[1]] = ci
        val[r0 : r0 + cv.shape[0], : cv.shape[1]] = cv
    return idx, val


def _tables_route(device, table_cache, strs_packed, norb: int, nelec,
                  tables_backend: str = "auto") -> str:
    """Where ``tables_backend`` builds an operator's tables: ``"card"``,
    ``"cache"``, ``"native"`` (the host build) or ``"device"`` (torch ops).
    ``"auto"`` takes the card on a CUDA device whose kernels take the
    strings (:func:`card_tables.takes`), with or without a cache; elsewhere
    it and ``"native"`` take ``"cache"`` where a usable ``table_cache`` is
    given (packed width <= 2 words and at most 4096 same-spin candidates a
    string on both spins, as ``sqd_tpu`` uses it), else ``"native"``; any
    other backend takes ``"device"``.  The tables are the same on every
    route.  ``strs_packed`` is either spin's packed matrix (both have one
    width)."""
    if tables_backend not in ("auto", "native"):
        return "device"
    strs_packed = np.asarray(strs_packed)
    if (tables_backend == "auto" and torch.device(device).type == "cuda"
            and card_tables.takes(strs_packed)):
        return "card"
    # the cache stores per-string rows at the full candidate width: at high
    # filling that width explodes and the direct build is the cheaper one
    if (table_cache is not None and table_cache.usable(strs_packed)
            and max(native.samespin_width(norb, int(ne)) for ne in nelec) <= 4096):
        return "cache"
    return "native"


def build_sci_basis(
    strs_a_packed: np.ndarray,
    strs_b_packed: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    device,
    tables_backend: str = "auto",
) -> SCIBasis:
    """Gather-table-only basis view (for RDM/S^2 queries), on ``device``.

    ``tables_backend`` as in ``sqd_tpu``: ``"native"`` builds the tables on
    the host, ``"auto"`` too, except on a CUDA device where
    :func:`card_tables.takes` the strings: there the card builds them
    (:func:`card_tables.gather_tables`, the host's tables bit for bit); any
    other value builds them on the device as torch ops.  (``sqd_tpu``'s
    ``"auto"`` falls back to the device only where the library is missing,
    which in the port it never is: a failed build raises.)
    """
    tables = []
    for strs in (strs_a_packed, strs_b_packed):
        route = _tables_route(device, None, strs, norb, nelec, tables_backend)
        if route == "card":
            tables += card_tables.gather_tables(strs, norb, device=device)
            continue
        if route == "native":
            src, sign = native.gather_tables(np.asarray(strs), norb)
            src = torch.as_tensor(src, dtype=torch.int64, device=device)
            sign = torch.as_tensor(sign, device=device)
        else:
            src, sign = linktab.build_gather_tables(strs, norb, device=device)
        tables += [src, sign]
    src_a, sign_a, src_b, sign_b = tables
    return SCIBasis(
        src_a=src_a,
        sign_a=sign_a,
        src_b=src_b,
        sign_b=sign_b,
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
    tables_backend: str = "auto",
) -> SCIHamiltonian:
    """Assemble the projected Hamiltonian on ``device``.

    The port of ``sqd_tpu.ops.hamiltonian.build_sci_hamiltonian``, with its
    ``tables_backend``, routed by :func:`_tables_route`: ``"native"`` builds
    the tables on the host (the native library, or ``table_cache``);
    ``"auto"`` on the host on the CPU, on the card on a CUDA device, a
    ``table_cache`` given or not (:func:`card_tables.build_tables`, the
    native build's tables bit for bit, counted in
    ``card_tables.build_tables.launches``); ``"device"``
    builds them on ``device`` from the packed strings as torch ops
    (:func:`linktab.build_gather_tables`, :func:`build_samespin_tables`; its
    same-spin values computed in ``dtype``, its lists keeping valid zero
    values, and ``table_cache`` ignored); any other value raises
    ``ValueError``.  All backends share the rest: the same padding and
    ``col_block`` (:func:`padded_layout`; clamped tables extended with zero
    weights, padded diagonal entries at 1e30; under ``"auto"`` no block on a
    CUDA device) and the same ``eri_factor``
    (``"auto"``: :func:`pivoted_cholesky_pairs` with rank at most
    ``npair // 3`` when ``npair > 256``, kept if it succeeds; ``None``: no
    factor; an ``(X, npair)`` array: used as given; only the dense
    density-fitted routes read it).  The f64 diagonal is
    computed on the host, or from ``DEVICE_DIAG_MIN_ELEMS`` padded
    determinants on, assembled on ``device`` from its rank-structured parts.
    A ``table_cache`` (:class:`sqd_tpu_torch.ops.table_cache.TableCache`)
    supplies the host's tables (``"native"``; ``"auto"`` off the card) where
    ``sqd_tpu`` would use it: packed width <= 2 words and at most 4096
    same-spin candidates per string on both spins; the tables are the same
    either way.
    """
    with span("tables"):
        m, n = np.asarray(strs_a_packed).shape[0], np.asarray(strs_b_packed).shape[0]
        n_a, n_b = (int(x) for x in nelec)
        _check_weights(strs_a_packed, strs_b_packed, (n_a, n_b))
        npair = norb * norb
        m_pad, n_pad, col_block = padded_layout(npair, m, n, pad_to, col_block, device)
        pad_m, pad_n = m_pad - m, n_pad - n

        h1_np = np.asarray(h1e, np.float64)
        eri_np = np.asarray(eri, np.float64)
        eri_chol = None
        with span("tables.eri_factor"):
            if isinstance(eri_factor, np.ndarray):
                eri_chol = np.ascontiguousarray(eri_factor, np.float64)
                if eri_chol.ndim != 2 or eri_chol.shape[1] != npair:
                    raise ValueError(f"eri_factor must be (X, {npair}), got {eri_chol.shape}")
            elif eri_factor == "auto" and npair > 256:
                eri_chol = pivoted_cholesky_pairs(eri_np, norb, max_rank=npair // 3)
            elif eri_factor not in (None, "auto"):
                raise ValueError(f"unknown eri_factor {eri_factor!r}")
        if tables_backend not in ("auto", "native", "device"):
            raise ValueError(
                f"unknown tables_backend {tables_backend!r} (expected 'auto', 'native' or 'device')"
            )
        route = _tables_route(device, table_cache, strs_a_packed, norb, (n_a, n_b),
                              tables_backend)
        host = None
        if route == "card":
            with span("tables.card"):
                src_a, sign_a, src_b, sign_b, ia, va, ib, vb = card_tables.build_tables(
                    strs_a_packed, strs_b_packed, h1_np, eri_np, norb, (n_a, n_b), device=device)
                va, vb = va.to(dtype), vb.to(dtype)
        elif route in ("cache", "native"):
            tables = table_cache if route == "cache" else native
            with span("tables.host"):
                host = (*tables.gather_tables(strs_a_packed, norb),
                        *tables.gather_tables(strs_b_packed, norb),
                        *tables.samespin_tables(strs_a_packed, h1_np, eri_np, norb, n_a),
                        *tables.samespin_tables(strs_b_packed, h1_np, eri_np, norb, n_b))
        else:
            h1_d = torch.as_tensor(h1_np, device=device).to(dtype)
            eri_d = torch.as_tensor(eri_np, device=device).to(dtype)
            src_a, sign_a = linktab.build_gather_tables(strs_a_packed, norb, device=device)
            src_b, sign_b = linktab.build_gather_tables(strs_b_packed, norb, device=device)
            ia, va = build_samespin_tables(strs_a_packed, h1_d, eri_d, norb, n_a, device=device)
            ib, vb = build_samespin_tables(strs_b_packed, h1_d, eri_d, norb, n_b, device=device)

        def val(x):
            return torch.as_tensor(x, device=device).to(dtype)

        with span("tables.upload"):
            if host is not None:
                src_a, sign_a, src_b, sign_b, ia, va, ib, vb = (
                    torch.as_tensor(t, device=device) for t in host)
                src_a, src_b, ia, ib = (t.to(torch.int64) for t in (src_a, src_b, ia, ib))
                va, vb = va.to(dtype), vb.to(dtype)
            # the tables are clamped (invalid -> index 0 with zero weight), so
            # padding extends them with zero-weight entries
            pad = torch.nn.functional.pad
            src_a, sign_a = pad(src_a, (0, pad_m)), pad(sign_a, (0, pad_m))
            src_b, sign_b = pad(src_b, (0, pad_n)), pad(sign_b, (0, pad_n))
            ia, va = pad(ia, (0, 0, 0, pad_m)), pad(va, (0, 0, 0, pad_m))
            ib, vb = pad(ib, (0, 0, 0, pad_n)), pad(vb, (0, 0, 0, pad_n))
            eri_t = val(np.ascontiguousarray(eri_np.reshape(npair, npair).T))
            if eri_chol is not None:
                eri_chol = torch.as_tensor(eri_chol, device=device)
        with span("tables.hdiag"):
            occ_a = _occupancy_np(strs_a_packed, norb)
            occ_b = _occupancy_np(strs_b_packed, norb)
            if m_pad * n_pad >= DEVICE_DIAG_MIN_ELEMS:
                # only the O((M + N) * norb) parts cross to the device
                a_part, b_part, w = _hdiag_parts_np(occ_a, occ_b, h1_np, eri_np)
                hd = _hdiag_device(
                    torch.as_tensor(np.pad(a_part, (0, pad_m), constant_values=1e30),
                                    device=device),
                    torch.as_tensor(np.pad(b_part, (0, pad_n), constant_values=1e30),
                                    device=device),
                    torch.as_tensor(np.pad(occ_a, ((0, pad_m), (0, 0))), device=device),
                    torch.as_tensor(np.pad(w, ((0, pad_n), (0, 0))), device=device),
                    dtype=dtype,
                )
            else:
                hd = val(np.pad(_hdiag_np(occ_a, occ_b, h1_np, eri_np),
                                ((0, pad_m), (0, pad_n)), constant_values=1e30))

        return SCIHamiltonian(
            src_a=src_a,
            sign_a=sign_a,
            src_b=src_b,
            sign_b=sign_b,
            nbr_idx_a=ia,
            nbr_val_a=va,
            nbr_idx_b=ib,
            nbr_val_b=vb,
            eri_t=eri_t,
            hdiag=hd,
            eri_chol=eri_chol,
            norb=int(norb),
            nelec=(n_a, n_b),
            spin_shift=float(spin_shift),
            spin_target=float(spin_target),
            col_block=col_block,
        )
