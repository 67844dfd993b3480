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

__all__ = ["build_desdes_tables", "pair_index_arrays"]


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


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).sum(axis=-1).astype(np.int32)


def build_desdes_tables(strs_packed: np.ndarray, norb: int, nelec_spin: int, *, device):
    """Two-hole (annihilation-pair) gather tables for exact same-spin 2-RDMs.

    The intermediates are the (nelec-2)-electron strings reachable from the
    set — a closed set, so ``<a+_p a+_r a_s a_q> = <F[(p,r)], F[(q,s)]>`` is
    exact.  Enumeration runs in the native library, the tables on the host in
    NumPy (once per solve).

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
    u_lt_w = (consts["q_lt_p"] == 0) & ~consts["is_diag"]
    k = inter.shape[0]
    src = np.zeros((npair, k), dtype=np.int64)
    sign = np.zeros((npair, k), dtype=np.int8)
    for pair in range(npair):
        if consts["is_diag"][pair]:
            continue
        bu, bw = consts["bit_p"][pair], consts["bit_q"][pair]
        free = ~np.any(inter & bu, axis=1) & ~np.any(inter & bw, axis=1)
        i_cand = inter | bu | bw
        found = bitpack.find_packed(strs_packed, i_cand)
        # sign of <K|a_w a_u|I>: remove u from I (parity below u in I), then
        # remove w from I-u (parity below w in I, minus 1 if u < w)
        s1 = _popcount_rows(i_cand & consts["below_p"][pair])
        s2 = _popcount_rows(i_cand & consts["below_q"][pair]) - int(u_lt_w[pair])
        ok = free & (found >= 0)
        src[pair] = np.where(ok, found, 0)
        sign[pair] = np.where(ok, np.where((s1 + s2) % 2 == 0, 1, -1), 0)
    return (
        inter,
        torch.as_tensor(src, device=device),
        torch.as_tensor(sign, device=device),
    )
