# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Packed-word bitstring arrays: the host (NumPy) half of ``sqd_tpu.ops.bitpack``.

A copy, not an import: ``sqd_tpu``'s package import pulls in JAX.

* A *packed matrix* is ``(num_strings, num_words) uint32`` where word ``w``
  holds bits ``[32*w, 32*w + 32)`` — word 0 is least significant.  Bit ``j`` of
  the integer is the occupation of orbital ``j``.
* Integer (CI-string) form: ``int64`` below 63 bits, Python unbounded
  integers (``object`` dtype) at >= 63 bits.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
_WORD_MASK = 0xFFFFFFFF


def num_words(nbits: int) -> int:
    """Number of 32-bit words required to hold ``nbits`` bits."""
    return max(1, -(-int(nbits) // WORD_BITS))


def pack_bool_matrix(bool_mat: np.ndarray) -> np.ndarray:
    """Pack a bitstring matrix (column 0 = MSB) into ``(S, W) uint32`` words.

    Packing the original columns MSB-first gives the little-endian bytes of
    the words in reverse order, so one ``np.packbits`` pass and a per-row
    byte reversal do it.
    """
    bool_mat = np.asarray(bool_mat, dtype=bool)
    if bool_mat.ndim != 2:
        raise ValueError(f"Expected a 2D bool matrix. Got shape {bool_mat.shape}.")
    n_rows, nbits = bool_mat.shape
    w = num_words(nbits)
    pad_cols = w * WORD_BITS - nbits
    if pad_cols:
        padded = np.zeros((n_rows, w * WORD_BITS), dtype=bool)
        padded[:, pad_cols:] = bool_mat  # left pad = high bits
        bool_mat = padded
    as_bytes = np.packbits(np.ascontiguousarray(bool_mat), axis=1, bitorder="big")
    rev = np.ascontiguousarray(as_bytes[:, ::-1])
    return rev.view("<u4").reshape(n_rows, w)


def unpack_to_bool_matrix(packed: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of :func:`pack_bool_matrix`."""
    packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    n_rows, w = packed.shape
    as_bytes = packed.astype("<u4", copy=False).view(np.uint8).reshape(n_rows, w * 4)
    rev = np.ascontiguousarray(as_bytes[:, ::-1])
    bits = np.unpackbits(rev, axis=1, bitorder="big")
    pad_cols = w * WORD_BITS - nbits
    out = bits[:, pad_cols:] if pad_cols else bits
    return out.astype(bool, copy=False)


def _lex_order(packed: np.ndarray) -> np.ndarray:
    """Indices that sort rows ascending by integer value (the last word is primary)."""
    return np.lexsort(tuple(packed[:, j] for j in range(packed.shape[1])))


def unique_packed(packed: np.ndarray, return_counts: bool = False):
    """Sorted unique rows of a packed matrix (and, optionally, their counts)."""
    packed = np.asarray(packed, dtype=np.uint32)
    order = _lex_order(packed)
    s = packed[order]
    keep = np.ones(len(s), dtype=bool)
    if len(s):
        keep[1:] = np.any(s[1:] != s[:-1], axis=1)
    if not return_counts:
        return s[keep]
    return s[keep], np.diff(np.append(np.flatnonzero(keep), len(s)))


def pack_ints(ints: np.ndarray, nbits: int) -> np.ndarray:
    """Pack an array of (possibly unbounded Python) integers into uint32 words."""
    ints = np.asarray(ints)
    w = num_words(nbits)
    out = np.zeros((len(ints), w), dtype=np.uint32)
    if ints.dtype == object:
        for i, v in enumerate(ints):
            v = int(v)
            for j in range(w):
                out[i, j] = (v >> (WORD_BITS * j)) & _WORD_MASK
    else:
        vals = ints.astype(np.uint64)
        for j in range(w):
            out[:, j] = ((vals >> np.uint64(WORD_BITS * j)) & np.uint64(_WORD_MASK)).astype(
                np.uint32
            )
    return out


def unpack_to_ints(packed: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Packed words -> integer array (``int64`` below 63 bits, else ``object``)."""
    packed = np.asarray(packed, dtype=np.uint32)
    n_rows, w = packed.shape
    if nbits is None:
        nbits = w * WORD_BITS
    if nbits < 64:
        result = np.zeros(n_rows, dtype=np.int64)
        for j in range(w):
            result |= packed[:, j].astype(np.int64) << (WORD_BITS * j)
        return result
    result = np.zeros(n_rows, dtype=object)
    for j in range(w):
        result += np.array([int(v) << (WORD_BITS * j) for v in packed[:, j]], dtype=object)
    return result


def searchsorted_packed(sorted_packed: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """``np.searchsorted`` over packed multi-word keys (left insertion point)."""
    sorted_packed = np.asarray(sorted_packed, dtype=np.uint32)
    queries = np.asarray(queries, dtype=np.uint32)
    # Big-endian byte view compares lexicographically == integer comparison
    # when the most-significant word comes first.
    keys = _void_view(sorted_packed[:, ::-1])
    q = _void_view(queries[:, ::-1])
    return np.searchsorted(keys.ravel(), q.ravel())


def find_packed(sorted_packed: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in ``sorted_packed`` or -1 if absent."""
    n = len(sorted_packed)
    pos = np.minimum(searchsorted_packed(sorted_packed, queries), max(n - 1, 0))
    if n == 0:
        return np.full(len(queries), -1, dtype=np.int64)
    hit = np.all(sorted_packed[pos] == queries, axis=1)
    return np.where(hit, pos, -1)


def _void_view(arr: np.ndarray) -> np.ndarray:
    """Rows as big-endian fixed-width byte blobs for lexicographic compare."""
    be = np.ascontiguousarray(arr.astype(">u4"))
    return be.view([("", f"V{be.shape[1] * 4}")]).ravel()


def prefix_masks(nbits: int) -> np.ndarray:
    """Static table ``prefix[k]`` = packed word mask of bits ``< k``."""
    w = num_words(nbits)
    out = np.zeros((nbits + 1, w), dtype=np.uint32)
    for k in range(nbits + 1):
        full, rem = divmod(k, WORD_BITS)
        out[k, :full] = _WORD_MASK
        if rem:
            out[k, full] = (1 << rem) - 1
    return out


def bit_masks(nbits: int) -> np.ndarray:
    """Static table ``bit[p]`` = packed words with only bit ``p`` set."""
    w = num_words(nbits)
    out = np.zeros((nbits, w), dtype=np.uint32)
    for p in range(nbits):
        out[p, p // WORD_BITS] = np.uint32(1) << np.uint32(p % WORD_BITS)
    return out
