# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Excitation tables for the same-spin 2-RDMs (port of ``sqd_tpu.ops.linktab``).

For a fixed orbital pair the map ``|I> -> a_w a_u |I>`` is injective on a
string set, so the two-hole operator ``F[(u,w)] = a_w a_u c`` is a dense
per-pair gather table over the set of reachable (nelec-2)-electron strings.
The single-excitation tables come from :mod:`sqd_tpu_torch.native`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from . import bitpack

__all__ = ["build_desdes_tables", "build_gather_tables", "occupancy_matrix", "pair_index_arrays"]


def pair_index_arrays(norb: int):
    """Static per-``norb`` constants describing all (p, q) operator pairs.

    Returns a dict of numpy arrays with leading dimension ``norb**2`` in
    ``pq = p * norb + q`` order (operator ``a+_p a_q``).
    """
    w = bitpack.num_words(norb)
    bits = bitpack.bit_masks(norb)  # (norb, W)
    prefix = bitpack.prefix_masks(norb)  # (norb+1, W)
    p_idx, q_idx = np.divmod(np.arange(norb * norb), norb)
    return {
        "bit_p": bits[p_idx],  # (npair, W)
        "bit_q": bits[q_idx],
        "below_p": prefix[p_idx],  # bits < p
        "below_q": prefix[q_idx],
        "q_lt_p": (q_idx < p_idx).astype(np.int32),
        "is_diag": (p_idx == q_idx),
        "num_words": w,
    }


def build_gather_tables(*args, **kwargs):
    """The device build of the gather tables (``sqd_tpu.ops.linktab.build_gather_tables``):
    not ported yet; the tables come from :func:`sqd_tpu_torch.native.gather_tables`."""
    raise NotImplementedError("build_gather_tables is not ported yet; see ROADMAP.md")


def occupancy_matrix(strs: torch.Tensor, norb: int) -> torch.Tensor:
    """``(n, norb)`` occupation-number matrix (0/1 int32) from packed strings
    (an int64 word tensor, see :func:`bitpack.to_device_words`)."""
    orbitals = torch.arange(norb, device=strs.device)
    words = strs[:, orbitals // bitpack.WORD_BITS]  # (n, norb)
    return ((words >> (orbitals % bitpack.WORD_BITS)) & 1).to(torch.int32)


# Device bytes one pair batch of the two-hole build may hold: the binary
# search keeps lo, hi, mid, the gathered row and the query alive per query,
# about (5 + 2 W) int64 values.
DESDES_BATCH_BYTES = 1 << 30


def build_desdes_tables(strs_packed: np.ndarray, norb: int, nelec_spin: int, *, device):
    """Two-hole (annihilation-pair) gather tables for exact same-spin 2-RDMs.

    The intermediates are the (nelec-2)-electron strings reachable from the
    set — a closed set, so ``<a+_p a+_r a_s a_q> = <F[(p,r)], F[(q,s)]>`` is
    exact.  Enumeration runs in the native library on the host; the tables
    are built on ``device``, a batch of pairs at a time within
    ``DESDES_BATCH_BYTES`` (``sqd_tpu`` maps one jitted function over the
    pairs).

    Returns ``(inter_packed (K, W) numpy, src (norb^2, K) int64, sign
    (norb^2, K) int8)``, the last two on ``device``, with ``src[(u*norb+w), k]``
    the index I such that ``I = K_k + u + w`` (clamped to 0 with sign 0 where
    absent), and ``sign = <K|a_w a_u|I>``.
    """
    strs_packed = np.asarray(strs_packed, dtype=np.uint32)
    n, w_words = strs_packed.shape
    npair = norb * norb
    if nelec_spin < 2 or n == 0:
        inter = np.zeros((0, w_words), dtype=np.uint32)
        return (
            inter,
            torch.zeros((npair, 0), dtype=torch.int64, device=device),
            torch.zeros((npair, 0), dtype=torch.int8, device=device),
        )
    inter = native.desdes_unique(strs_packed, nelec_spin)
    consts = pair_index_arrays(norb)
    strs_d = bitpack.to_device_words(strs_packed, device)
    inter_d = bitpack.to_device_words(inter, device)  # (K, W)
    bit_u = bitpack.to_device_words(consts["bit_p"], device)[:, None, :]  # (npair, 1, W)
    bit_w = bitpack.to_device_words(consts["bit_q"], device)[:, None, :]
    below_u = bitpack.to_device_words(consts["below_p"], device)[:, None, :]
    below_w = bitpack.to_device_words(consts["below_q"], device)[:, None, :]
    is_diag = torch.as_tensor(consts["is_diag"], device=device)[:, None]  # (npair, 1)
    u_lt_w = torch.as_tensor(consts["q_lt_p"] == 0, device=device)[:, None] & ~is_diag

    k = inter.shape[0]
    src = torch.empty((npair, k), dtype=torch.int64, device=device)
    sign = torch.empty((npair, k), dtype=torch.int8, device=device)
    batch = max(1, DESDES_BATCH_BYTES // (k * (5 + 2 * w_words) * 8))
    for lo in range(0, npair, batch):
        sl = slice(lo, min(lo + batch, npair))
        bu, bw = bit_u[sl], bit_w[sl]
        free = (bitpack.torch_popcount_rows(inter_d & bu) == 0) & (
            bitpack.torch_popcount_rows(inter_d & bw) == 0
        )  # (P, K)
        i_cand = inter_d | bu | bw  # (P, K, W)
        found = bitpack.torch_find_packed(strs_d, i_cand.reshape(-1, w_words)).reshape(free.shape)
        # sign of <K|a_w a_u|I>: remove u from I (parity below u in I), then
        # remove w from I-u (parity below w in I, minus 1 if u < w)
        s1 = bitpack.torch_popcount_rows(i_cand & below_u[sl])
        s2 = bitpack.torch_popcount_rows(i_cand & below_w[sl]) - u_lt_w[sl].to(torch.int32)
        ok = free & (found >= 0) & ~is_diag[sl]
        src[sl] = torch.where(ok, found, 0)
        sign[sl] = torch.where(ok, 1 - 2 * ((s1 + s2) & 1), 0).to(torch.int8)
    return inter, src, sign
