# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fully dense density-fitted matvec for large active spaces (port of
``sqd_tpu.ops.dense_df``).

With the ERI pair matrix factored as ``V = L^T L`` (``L`` of shape
``(X, npair)``), the cross-spin channel is exactly

    sigma_ab = sum_x  Wa_x @ c @ Wb_x^T,
    Wa_x = sum_pq L[x, pq] * A_pq   (M, M) dense,
    Wb_x = sum_rs L[x, rs] * B_rs   (N, N) dense,

where ``A_pq[j, j'] = <j| E^a_pq |j'>`` restricted to the selected alpha set
(exact: the alpha and beta operators act on different spins, so no
out-of-space intermediate appears; it is the gather matvec's decomposition,
re-associated).  The same-spin channels densify to single matrices
``H_aa (M, M)`` and ``H_bb (N, N)`` built from the neighbour lists.

The matvec is then matrix products only, no gathers: ``4 X M^2 N`` FLOPs
(``M = N``) and ``4 X M^2`` bytes of factors read per application, against
about ``2 M N ka kb`` FLOPs for the cross-spin kernel of the gather route
(``ka``, ``kb`` valid pairs per string).  Which route is the faster depends
on the card and the shape (``PERF.md``), so it is opt-in through
:func:`densify` or ``solve_sci(matvec_strategy="dense_df")``.

Memory: ``wa`` and ``wb`` hold ``X (M^2 + N^2)`` values, except for
identical alpha and beta string sets (every ``S_z = 0`` problem), where
:func:`densify` detects set equality modulo padding, builds one stack at the
common padded width and aliases ``wb`` and ``hbb`` to it: ``X max(M, N)^2``.

Spin-penalty operators (``spin_shift != 0``) are not supported: the mixed
``S^2`` term's pair matrix is an involution (eigenvalues +-1, not PSD), so it
has no Cholesky factor, and :func:`densify` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .hamiltonian import SCIHamiltonian
from .precision import highest_precision

__all__ = ["DenseDFOperator", "densify", "dense_df_matvec_flat"]

_BUILD_PAIR_CHUNK = 32  # pairs per one-hot tile of the W build
_BUILD_COL_BLOCK = 512  # table strings (rows of W) per tile of the W build
_APPLY_X_CHUNK = 8  # factors per tile of the matvec: a (chunk, M, N) intermediate


@dataclass(frozen=True)
class DenseDFOperator:
    """Dense density-fitted projected Hamiltonian (see the module docstring);
    all tensors on one device."""

    wa: torch.Tensor  # (X, M, M)
    wb: torch.Tensor  # (X, N, N)
    haa: torch.Tensor  # (M, M) same-spin alpha (includes its diagonal channel)
    hbb: torch.Tensor  # (N, N) same-spin beta
    hdiag: torch.Tensor  # (M, N): Davidson preconditioner (padded slots huge)
    # x-axis tile of the matvec; 0 = the whole stack in one contraction
    x_chunk: int = _APPLY_X_CHUNK

    @property
    def shape(self) -> tuple[int, int]:
        # hdiag carries the operator's true (M, N); wa/wb may be built at a
        # common square width >= max(M, N) (identical-set aliasing)
        return tuple(self.hdiag.shape)

    def matvec(self, c: torch.Tensor) -> torch.Tensor:
        """``sigma = (P H P) c``: matrix products only, x-chunked.

        ``wa``/``wb`` may be built at a common padded width larger than
        ``c``'s sides (the identical-set aliasing in :func:`densify` when the
        row and column pads differ): the extra rows and columns of every
        dense factor are exactly zero (clamped tables), so zero-padding ``c``
        up and slicing the result back is exact.

        Per chunk, ``t = Wa @ c`` is one product of the stacked factors with
        ``c`` and ``torch.bmm(t, Wb^T)`` one batched product, summed over x:
        the sum costs a second ``(cx, M, N)`` intermediate, and is still the
        fastest of the three forms timed on an H100 at the (54e,36o) shape
        (``probes/torch_dense_df_variants.py``, ``PERF.md``), ahead of
        ``sqd_tpu``'s two einsums and of one in-place ``addmm_`` per factor.
        """
        dt = c.dtype
        m_in, n_in = c.shape
        m, n = self.wa.shape[1], self.wb.shape[1]
        if (m, n) != (m_in, n_in):
            c = torch.nn.functional.pad(c, (0, n - n_in, 0, m - m_in))
        x_tot = self.wa.shape[0]
        cx = x_tot if self.x_chunk == 0 else min(self.x_chunk, x_tot)
        with highest_precision():
            sigma = self.haa.to(dt) @ c
            sigma.addmm_(c, self.hbb.to(dt).T)
            for x0 in range(0, x_tot, cx):
                wa_c = self.wa[x0 : x0 + cx].to(dt)
                wb_c = self.wb[x0 : x0 + cx].to(dt)
                t = torch.matmul(wa_c, c)  # (cx, M, N)
                sigma += torch.bmm(t, wb_c.transpose(1, 2)).sum(dim=0)
        if (m, n) != (m_in, n_in):
            sigma = sigma[:m_in, :n_in]
        return sigma


def dense_df_matvec_flat(op: DenseDFOperator, x: torch.Tensor) -> torch.Tensor:
    """Flat-vector matvec adapter for the Davidson solver."""
    m, n = op.shape
    return op.matvec(x.reshape(m, n)).reshape(-1)


def _w_stack(src: torch.Tensor, sign: torch.Tensor, ell: torch.Tensor, dtype) -> torch.Tensor:
    """``W[x] = sum_pq L[x, pq] * A_pq`` by pair- and row-tiled matrix products.

    ``A_pq[j, :] = sign[pq, j] * e_{src[pq, j]}`` (clamped tables: invalid
    entries carry sign 0, so padded and absent excitations add nothing).  A
    tile of ``_BUILD_PAIR_CHUNK`` pairs by ``_BUILD_COL_BLOCK`` table strings
    is written out as signed one-hot rows (one ``scatter_`` entry per row, no
    two alike) and contracted with its columns of ``L``: ``2 X npair M^2``
    FLOPs in all.  A scatter-add of ``L[x, pq] * sign`` straight into ``W``
    would go through atomic adds where the ``norb`` diagonal pairs of a string
    meet at ``W[x, j, j]``, in an order that changes from run to run; the
    products add in a fixed order, so two builds give the same bits.
    """
    npair, m = src.shape
    x_tot = ell.shape[0]
    ell = ell.to(dtype)
    w = torch.empty((x_tot, m, m), dtype=dtype, device=src.device)
    with highest_precision():
        for j0 in range(0, m, _BUILD_COL_BLOCK):
            count = min(_BUILD_COL_BLOCK, m - j0)
            acc = torch.zeros((x_tot, count * m), dtype=dtype, device=src.device)
            for p0 in range(0, npair, _BUILD_PAIR_CHUNK):
                pairs = slice(p0, p0 + _BUILD_PAIR_CHUNK)
                src_c = src[pairs, j0 : j0 + count]  # (cp, count)
                a_c = torch.zeros((*src_c.shape, m), dtype=dtype, device=src.device)
                a_c.scatter_(2, src_c[:, :, None], sign[pairs, j0 : j0 + count, None].to(dtype))
                acc.addmm_(ell[:, pairs], a_c.reshape(src_c.shape[0], count * m))
            w[:, j0 : j0 + count] = acc.reshape(x_tot, count, m)
    return w


def _dense_samespin(idx: torch.Tensor, val: torch.Tensor, dtype) -> torch.Tensor:
    """Dense ``(M, M)`` same-spin matrix from the compacted neighbour lists.

    A list's padding is value 0 at index 0, which adds nothing; its real
    entries are one per target, so the accumulation order cannot matter.
    """
    m = idx.shape[0]
    rows = torch.arange(m, device=idx.device)[:, None].expand(idx.shape)
    out = torch.zeros((m, m), dtype=dtype, device=idx.device)
    return out.index_put_((rows, idx), val.to(dtype), accumulate=True)


def densify(
    ham: SCIHamiltonian, dtype=torch.float32, *, x_chunk: int = _APPLY_X_CHUNK
) -> DenseDFOperator:
    """Build the dense density-fitted operator from a factored Hamiltonian.

    Requires ``ham.eri_chol`` (see ``build_sci_hamiltonian(eri_factor=...)``)
    and no fused spin penalty.  The build runs on the Hamiltonian's device
    (``2 X npair (M^2 + N^2)`` FLOPs, once per subspace).
    """
    if ham.eri_chol is None:
        raise ValueError(
            "densify requires an ERI factor: build the Hamiltonian with "
            "eri_factor='auto' (PSD integrals) or pass an explicit factor"
        )
    if ham.spin_shift != 0.0:
        raise ValueError(
            "densify does not support the fused spin penalty (the S^2 mixed "
            "term's pair matrix is not PSD); solve with spin_shift=0"
        )
    ell = ham.eri_chol
    m, n = ham.shape
    p = max(m, n)

    def pad_cols(a):
        # zero columns = clamped inert entries (slot 0, sign 0)
        return a if a.shape[1] == p else torch.nn.functional.pad(a, (0, p - a.shape[1]))

    # Identical alpha and beta string sets make Wb == Wa and H_bb == H_aa:
    # alias them and halve the dominant memory cost.  ``build_sci_hamiltonian`` pads the
    # row axis to x8 but the column axis to x128, so identical sets arrive
    # with different padded widths: compare modulo the zero padding and build
    # once at the common width; the matvec pads and slices c around the
    # square factors (exact: padded factor rows and columns are all zero).
    src_a, sign_a = pad_cols(ham.src_a), pad_cols(ham.sign_a)
    same_sets = torch.equal(src_a, pad_cols(ham.src_b)) and torch.equal(
        sign_a, pad_cols(ham.sign_b)
    )
    if same_sets:
        pad_r = (0, 0, 0, p - ham.nbr_idx_a.shape[0])
        haa = hbb = _dense_samespin(
            torch.nn.functional.pad(ham.nbr_idx_a, pad_r),
            torch.nn.functional.pad(ham.nbr_val_a, pad_r),
            dtype,
        )
        # the W stack dominates the memory: allocate it last
        wa = wb = _w_stack(src_a, sign_a, ell, dtype)
    else:
        haa = _dense_samespin(ham.nbr_idx_a, ham.nbr_val_a, dtype)
        hbb = _dense_samespin(ham.nbr_idx_b, ham.nbr_val_b, dtype)
        wa = _w_stack(ham.src_a, ham.sign_a, ell, dtype)
        wb = _w_stack(ham.src_b, ham.sign_b, ell, dtype)
    return DenseDFOperator(
        wa=wa, wb=wb, haa=haa, hbb=hbb, hdiag=ham.hdiag.to(dtype), x_chunk=x_chunk
    )
