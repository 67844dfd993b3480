# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Reduced density matrices and energies from SCI wavefunctions.

The port of ``sqd_tpu.ops.rdm``:

* 1-RDMs: both endpoints live in the subspace, so the per-pair single
  excitation gathers are exact, evaluated through row/column Gram matrices.
* opposite-spin 2-RDM block ``<E^a_pq E^b_rs>``: an exact Gram of alpha and
  beta gathers, accumulated over alpha-row blocks when the product-space
  intermediate would exceed ``block_bytes``.
* same-spin blocks ``<a+_p a+_r a_s a_q>``: the Gram of two-hole (des-des)
  gathers, whose intermediate set is closed by construction, accumulated over
  column blocks past ``block_bytes``.

``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import linktab
from .hamiltonian import SCIBasis

__all__ = [
    "energy_from_rdms",
    "make_rdms",
    "rdm1",
    "rdm1s",
    "rdm2_spin_summed",
    "rdm2s",
]


def _qp_perm(norb: int) -> np.ndarray:
    p, q = np.divmod(np.arange(norb * norb), norb)
    return q * norb + p


def _dm1s(ham: SCIBasis, c: torch.Tensor):
    """1-RDMs via row/column Gram matrices — O(M^2 N) flops, O(M^2) memory.

    ``dm1a[p,q] = sum_J sign_a[pq,J] * (c c^T)[src_a[pq,J], J]``.
    """
    norb = ham.norb
    m, n = c.shape
    gram_rows = (c @ c.T).reshape(-1)
    gram_cols = (c.T @ c).reshape(-1)
    row_ids = torch.arange(m, device=c.device)[None, :]
    col_ids = torch.arange(n, device=c.device)[None, :]
    picked_a = gram_rows[ham.src_a * m + row_ids]
    picked_b = gram_cols[ham.src_b * n + col_ids]
    dm1a = (ham.sign_a.to(c.dtype) * picked_a).sum(dim=1).reshape(norb, norb)
    dm1b = (ham.sign_b.to(c.dtype) * picked_b).sum(dim=1).reshape(norb, norb)
    return dm1a, dm1b


def _samespin_dm2_from_holes(src, sign, c_rows):
    """Gram of two-hole intermediates: ``c_rows`` is (n, X) for one spin axis.

    Returns (npair, npair) with entry [(p, r), (q, s)] = <a+p a+r a_s a_q>.
    """
    f = sign.to(c_rows.dtype)[:, :, None] * c_rows[src]  # (npair, K, X)
    f_flat = f.reshape(f.shape[0], -1)
    return f_flat @ f_flat.T


def _samespin_dm2_from_holes_blocked(src, sign, c_rows, col_block: int):
    """Column-blocked :func:`_samespin_dm2_from_holes`: the (npair, K, X)
    intermediate never exists whole (X a ``col_block`` multiple, zero-padded)."""
    npair = src.shape[0]
    sgn = sign.to(c_rows.dtype)[:, :, None]
    gram = torch.zeros((npair, npair), dtype=c_rows.dtype, device=c_rows.device)
    for b0 in range(0, c_rows.shape[1], col_block):
        f = (sgn * c_rows[:, b0 : b0 + col_block][src]).reshape(npair, -1)
        gram += f @ f.T
    return gram


def _dm2ab_pair_gram_blocked(src_a, sign_a, src_b, sign_b, c, row_block: int):
    """``pab[pq, rs] = sum_ij (E^a_pq c)[i,j] (E^b_rs c)[i,j]`` accumulated over
    alpha-row blocks (tables padded along alpha to a ``row_block`` multiple
    with sign 0), so no (npair, M, N) product-space buffer exists."""
    npair = src_a.shape[0]
    sgn_b = sign_b.to(c.dtype)[:, None, :]
    pab = torch.zeros((npair, npair), dtype=c.dtype, device=c.device)
    for i0 in range(0, src_a.shape[1], row_block):
        src_blk = src_a[:, i0 : i0 + row_block]
        sgn_blk = sign_a[:, i0 : i0 + row_block].to(c.dtype)
        d_a = sgn_blk[:, :, None] * c[src_blk]  # (npair, rb, n)
        d_b = c[i0 : i0 + row_block][:, src_b].transpose(0, 1) * sgn_b
        pab += d_a.reshape(npair, -1) @ d_b.reshape(npair, -1).T
    return pab


def make_rdms(
    ham: SCIBasis,
    c: torch.Tensor,
    strs_a_packed: np.ndarray | None = None,
    strs_b_packed: np.ndarray | None = None,
    *,
    spin_resolved: bool = False,
    with_dm2: bool = True,
    block_bytes: int = 128 * 1024**2,
):
    """1-RDMs (and optionally 2-RDMs) of the state ``c`` (normalized here).

    ``strs_*_packed`` (host arrays) are required for 2-RDMs.  When a per-pair
    intermediate ((npair, M, N) for the opposite-spin Gram, (npair, K, N) for
    the same-spin two-hole Grams) would exceed ``block_bytes``, its Gram
    accumulates over blocks of at most ``block_bytes``; ``block_bytes=0``
    forces blocking with the smallest tile.

    Returns a dict with keys ``dm1a``, ``dm1b`` and, if ``with_dm2``:
    ``dm2`` (spin-summed) or ``dm2aa/dm2ab/dm2bb`` (``spin_resolved=True``).
    """
    norb = ham.norb
    npair = norb * norb
    c = c / torch.linalg.norm(c)
    dm1a, dm1b = _dm1s(ham, c)
    out = {"dm1a": dm1a, "dm1b": dm1b}
    if not with_dm2:
        return out
    if strs_a_packed is None or strs_b_packed is None:
        raise ValueError("strs_a_packed/strs_b_packed are required for 2-RDMs.")

    m, n = ham.shape
    itemsize = c.element_size()

    def pick_block(total_rows: int, per_row_bytes: int) -> int:
        """Largest multiple-of-8 block with per-block buffer <= block_bytes
        (0 -> unblocked)."""
        if total_rows * per_row_bytes <= block_bytes:
            return 0
        blk = max(block_bytes, 1) // per_row_bytes
        return int(max(8, min(total_rows, (blk // 8) * 8 or 8)))

    row_block = pick_block(m, npair * n * itemsize)
    if row_block == 0:
        d_a = ham.gather_alpha(c).reshape(npair, -1)
        d_b = ham.gather_beta(c).reshape(npair, -1)
        pab = d_a @ d_b.T
        del d_a, d_b
    else:
        m_pad = -(-m // row_block) * row_block
        pad = (0, m_pad - m)
        pab = _dm2ab_pair_gram_blocked(
            torch.nn.functional.pad(ham.src_a, pad),
            torch.nn.functional.pad(ham.sign_a, pad),
            ham.src_b,
            ham.sign_b,
            torch.nn.functional.pad(c, (0, 0, 0, m_pad - m)),
            row_block,
        )
    perm = torch.as_tensor(_qp_perm(norb), device=c.device)
    dm2ab = pab[perm].reshape(norb, norb, norb, norb)

    n_a, n_b = ham.nelec
    _, src_ha, sign_ha = linktab.build_desdes_tables(strs_a_packed, norb, n_a, device=c.device)
    _, src_hb, sign_hb = linktab.build_desdes_tables(strs_b_packed, norb, n_b, device=c.device)

    def samespin_gram(src, sign, c_rows):
        k = src.shape[1]
        x = c_rows.shape[1]
        blk = pick_block(x, src.shape[0] * k * itemsize)
        if blk == 0:
            return _samespin_dm2_from_holes(src, sign, c_rows)
        x_pad = -(-x // blk) * blk
        c_p = torch.nn.functional.pad(c_rows, (0, x_pad - x))
        return _samespin_dm2_from_holes_blocked(src, sign, c_p, blk)

    gram_a = samespin_gram(src_ha, sign_ha, c)
    gram_b = samespin_gram(src_hb, sign_hb, c.T)
    # gram[(p, r), (q, s)] -> dm2ss[p, q, r, s]
    dm2aa = gram_a.reshape(norb, norb, norb, norb).permute(0, 2, 1, 3)
    dm2bb = gram_b.reshape(norb, norb, norb, norb).permute(0, 2, 1, 3)

    if spin_resolved:
        out["dm2aa"], out["dm2ab"], out["dm2bb"] = dm2aa, dm2ab, dm2bb
    else:
        out["dm2"] = dm2aa + dm2bb + dm2ab + dm2ab.permute(2, 3, 0, 1)
    return out


def rdm1s(ham: SCIBasis, c: torch.Tensor):
    r = make_rdms(ham, c, with_dm2=False)
    return r["dm1a"], r["dm1b"]


def rdm1(ham: SCIBasis, c: torch.Tensor):
    a, b = rdm1s(ham, c)
    return a + b


def rdm2_spin_summed(ham: SCIBasis, c: torch.Tensor, strs_a_packed, strs_b_packed):
    return make_rdms(ham, c, strs_a_packed, strs_b_packed)["dm2"]


def rdm2s(ham: SCIBasis, c: torch.Tensor, strs_a_packed, strs_b_packed):
    r = make_rdms(ham, c, strs_a_packed, strs_b_packed, spin_resolved=True)
    return r["dm2aa"], r["dm2ab"], r["dm2bb"]


def energy_from_rdms(h1e, eri, dm1: torch.Tensor, dm2: torch.Tensor) -> torch.Tensor:
    """``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]``."""
    h1 = torch.as_tensor(h1e, dtype=dm1.dtype, device=dm1.device)
    eri = torch.as_tensor(eri, dtype=dm2.dtype, device=dm2.device)
    return torch.sum(h1 * dm1) + 0.5 * torch.sum(eri * dm2)
