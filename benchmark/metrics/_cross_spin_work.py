"""The work of the opposite-spin channel, counted from the subspace.

``sigma[I, Ib] += (pq|rs) s_a s_b c[J, Jb]`` for every couple of an alpha
single excitation ``<I|E_pq|J>`` and a beta one ``<Ib|E_rs|Jb>`` that stay in
the subspace (``p == q`` and ``r == s`` included): one multiply-add, two
FLOPs, per couple.  Bytes: the amplitudes read once and sigma written once
(f32), the integrals once (f32, ``norb**4``), and one table entry per valid
excitation of either spin at ``ENTRY_BYTES`` (a 4-byte source index and a
4-byte signed pair code).  Counted from the strings, never from the
kernel's operands or tiles, so that it reads the same work whatever
implements the channel.  The least time is the larger of FLOPs over the
peak f32 rate and bytes over the peak bandwidth (NVIDIA's H100 SXM data
sheet, dense, at the 700 W limit).
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12  # FLOP/s, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes/s
F32_BYTES = 4
ENTRY_BYTES = 8


def in_set_singles(strs, norb: int) -> int:
    """Pairs ``(J, p <- q)`` with ``q`` occupied in ``J``, ``p`` empty or
    ``q`` itself, and the excited string in the set."""
    strs = np.sort(np.asarray(strs, dtype=np.int64))
    occ = ((strs[:, None] >> np.arange(norb)) & 1).astype(bool)
    ket, q, p = np.nonzero(occ[:, :, None] & (~occ[:, None, :] | np.eye(norb, dtype=bool)))
    target = strs[ket] ^ (np.int64(1) << q) ^ (np.int64(1) << p)
    pos = np.searchsorted(strs, target).clip(max=len(strs) - 1)
    return int(np.count_nonzero(strs[pos] == target))


def work(strs_a, strs_b, norb: int) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of one application of the channel."""
    ka, kb = in_set_singles(strs_a, norb), in_set_singles(strs_b, norb)
    m, n = len(strs_a), len(strs_b)
    flops = 2.0 * ka * kb
    nbytes = F32_BYTES * (2 * m * n + norb**4) + ENTRY_BYTES * (ka + kb)
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
