# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Reduced density matrices and energies from SCI wavefunctions.

The port of ``sqd_tpu.ops.rdm``:

* 1-RDMs: both endpoints live in the subspace, so the per-pair single
  excitation gathers are exact, evaluated through row/column Gram matrices.
* opposite-spin 2-RDM block ``<E^a_pq E^b_rs>``: an exact Gram of alpha and
  beta gathers, accumulated over alpha-row blocks when the product-space
  intermediate would exceed ``block_bytes``.
* same-spin blocks ``<a+_p a+_r a_s a_q>``: the Gram of two-hole (des-des)
  gathers, whose intermediate set is closed by construction.  It is summed
  over the two-hole entries that share an intermediate, through the
  transition matrix ``C C^T`` of the spin's strings, in chunks of
  intermediates whose entry pairs stay within ``block_bytes``: the work grows
  with the pairs of strings at most a double excitation apart, not with
  ``npair**2`` times the intermediates (``sqd_tpu`` forms the dense Gram).

``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracing import span
from . import bitpack, linktab
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


def _two_hole_entries(strs_packed, norb: int, dtype, device):
    """The two-hole entries of one spin's strings, grouped by intermediate.

    Every string ``I`` and ordered pair ``u != w`` of its occupied orbitals
    gives the entry ``(K = I - u - w, pair u*norb + w, I, <K|a_w a_u|I>)``:
    ``linktab.build_desdes_tables``'s valid table entries, enumerated from the
    strings instead of looked up from the intermediates.  Returns ``(src,
    pair, sign, group, counts)``: the entries sorted by intermediate (``group``
    ascending), and each intermediate's number of entries."""
    words = bitpack.to_device_words(strs_packed, device)  # (M, W)
    occ = linktab.occupancy_matrix(words, norb)
    held = occ.bool()
    off_diag = ~torch.eye(norb, dtype=torch.bool, device=device)
    rows, u, w = torch.nonzero(held[:, :, None] & held[:, None, :] & off_diag, as_tuple=True)
    # the sign of <K|a_w a_u|I>: remove u (parity below u in I), then w
    # (parity below w in I, less u where u < w)
    below = torch.cumsum(occ, 1) - occ
    parity = below[rows, u] + below[rows, w] - (u < w).to(below.dtype)
    sign = (1 - 2 * (parity & 1)).to(dtype)
    orbitals = torch.arange(norb, device=device)
    bit = torch.zeros((norb, words.shape[1]), dtype=torch.int64, device=device)
    bit[orbitals, orbitals // bitpack.WORD_BITS] = 1 << (orbitals % bitpack.WORD_BITS)
    key = words[rows] - bit[u] - bit[w]  # the intermediate's words
    _, group, counts = torch.unique(key, dim=0, return_inverse=True, return_counts=True)
    group, order = torch.sort(group, stable=True)
    return rows[order], (u * norb + w)[order], sign[order], group, counts


def _samespin_gram(strs_packed, norb: int, nelec_spin: int, c_rows, block_bytes: int):
    """``(npair, npair)`` Gram of one spin's two-hole gathers: entry
    ``[(p, r), (q, s)] = <a+p a+r a_s a_q>`` for amplitudes ``c_rows`` (its
    rows the spin's strings, zero-padded rows past them).

    ``sum_K sum_x F[(p,r),K,x] F[(q,s),K,x]`` with ``F[(u,w),K,x] = sign
    c[I,x]``: each pair of entries ``a, b`` that share an intermediate adds
    ``sign_a sign_b T[I_a, I_b]`` at ``[pair_a, pair_b]``, ``T = C C^T``.  The
    pairs are made and added in chunks of whole intermediates within
    ``block_bytes`` (40 bytes a pair; one intermediate at least)."""
    npair = norb * norb
    gram = c_rows.new_zeros((npair, npair))
    m = len(strs_packed)
    if nelec_spin < 2 or m == 0:
        return gram
    with span("rdm.holes"):
        src, pair, sign, group, counts = _two_hole_entries(strs_packed, norb, c_rows.dtype,
                                                           c_rows.device)
        starts = torch.cumsum(counts, 0) - counts
        # entries and entry pairs before each intermediate, on the host
        per_group = counts.cpu().numpy()
        ends = np.concatenate([[0], np.cumsum(per_group)])
        pairs = np.concatenate([[0], np.cumsum(per_group**2)])
    with span("rdm.samespin"):
        c_set = c_rows[:m]
        t = c_set @ c_set.T
        budget = max(block_bytes // 40, 1)
        flat = gram.view(-1)
        g0 = 0
        while g0 < len(per_group):
            g1 = max(g0 + 1, int(np.searchsorted(pairs, pairs[g0] + budget, side="right")) - 1)
            e0, e1, n_pairs = int(ends[g0]), int(ends[g1]), int(pairs[g1] - pairs[g0])
            rep = counts[group[e0:e1]]
            a = torch.repeat_interleave(torch.arange(e0, e1, device=c_rows.device), rep,
                                        output_size=n_pairs)
            first = torch.cumsum(rep, 0) - rep  # each entry's first pair in the chunk
            b = starts[group[a]] + torch.arange(n_pairs, device=c_rows.device) - first[a - e0]
            vals = sign[a] * sign[b] * t[src[a], src[b]]
            flat.index_put_((pair[a] * npair + pair[b],), vals, accumulate=True)
            g0 = g1
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

    ``strs_*_packed`` (host arrays) are required for 2-RDMs.  When the
    opposite-spin Gram's (npair, M, N) intermediate would exceed
    ``block_bytes``, it accumulates over blocks of at most ``block_bytes``;
    the same-spin Grams add their entry pairs in chunks within it;
    ``block_bytes=0`` forces both with the smallest tile.

    Returns a dict with keys ``dm1a``, ``dm1b`` and, if ``with_dm2``:
    ``dm2`` (spin-summed) or ``dm2aa/dm2ab/dm2bb`` (``spin_resolved=True``).
    """
    with span("rdm"):
        return _make_rdms(ham, c, strs_a_packed, strs_b_packed, spin_resolved, with_dm2,
                          block_bytes)


def _make_rdms(ham, c, strs_a_packed, strs_b_packed, spin_resolved, with_dm2, block_bytes):
    norb = ham.norb
    npair = norb * norb
    c = c / torch.linalg.norm(c)
    with span("rdm.dm1"):
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

    with span("rdm.ab"):
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
    gram_a = _samespin_gram(strs_a_packed, norb, n_a, c, block_bytes)
    gram_b = _samespin_gram(strs_b_packed, norb, n_b, c.T, block_bytes)
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
