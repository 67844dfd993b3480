# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Packed-word bitstring arrays: ``sqd_tpu.ops.bitpack`` in NumPy and torch.

A copy, not an import: ``sqd_tpu``'s package import pulls in JAX.  The host
functions are NumPy; the device functions (``torch_*``, ``sqd_tpu``'s
``jnp_*``) take torch tensors.

* A *packed matrix* is ``(num_strings, num_words) uint32`` where word ``w``
  holds bits ``[32*w, 32*w + 32)`` — word 0 is least significant.  Bit ``j`` of
  the integer is the occupation of orbital ``j``.
* Integer (CI-string) form: ``int64`` below 63 bits, Python unbounded
  integers (``object`` dtype) at >= 63 bits.
* On the device a packed matrix is an ``int64`` tensor holding the same
  word values (``0 <= word < 2**32``): torch's ``uint32`` lacks shifts,
  bitwise ops and reductions on some backends, and in ``int64`` bit 31 of a
  word survives every shift, sum and comparison.
"""

from __future__ import annotations

import numpy as np
import torch

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


def popcount(packed: np.ndarray) -> np.ndarray:
    """Per-row population count of a packed matrix."""
    packed = np.asarray(packed, dtype=np.uint32)
    return np.bitwise_count(packed).sum(axis=-1).astype(np.int64)


def _lex_order(packed: np.ndarray) -> np.ndarray:
    """Indices that sort rows ascending by integer value (the last word is primary)."""
    return np.lexsort(tuple(packed[:, j] for j in range(packed.shape[1])))


def sort_packed(packed: np.ndarray) -> np.ndarray:
    """Rows sorted ascending by integer value."""
    return packed[_lex_order(packed)]


def unique_packed(packed: np.ndarray, return_index: bool = False, return_counts: bool = False):
    """Sorted unique rows of a packed matrix and, optionally, the index of each
    one's first occurrence in ``packed`` (as ``np.unique``'s) and its count,
    in that order."""
    packed = np.asarray(packed, dtype=np.uint32)
    order = _lex_order(packed)
    s = packed[order]
    keep = np.ones(len(s), dtype=bool)
    if len(s):
        keep[1:] = np.any(s[1:] != s[:-1], axis=1)
    starts = np.flatnonzero(keep)
    results = [s[keep]]
    if return_index:
        results.append(np.minimum.reduceat(order, starts) if len(s) else np.zeros(0, np.int64))
    if return_counts:
        results.append(np.diff(np.append(starts, len(s))))
    return results[0] if len(results) == 1 else tuple(results)


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


def ints_to_packed(ints, nbits: int) -> np.ndarray:
    """:func:`pack_ints` of a list or array of integers."""
    return pack_ints(np.asarray(ints, dtype=object if nbits >= 63 else np.int64), nbits)


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


# ---------------------------------------------------------------------------
# device (torch) packed-key functions: int64 tensors of 32-bit word values
# ---------------------------------------------------------------------------


def to_device_words(packed, device) -> torch.Tensor:
    """A packed ``(n, W)`` matrix (uint32 NumPy, or a tensor of word values)
    as an ``int64`` tensor on ``device``."""
    if isinstance(packed, torch.Tensor):
        return packed.to(device=device, dtype=torch.int64)
    arr = np.asarray(packed, dtype=np.uint32)
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def to_host_words(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`to_device_words`: a uint32 NumPy matrix."""
    return words.cpu().numpy().astype(np.uint32)


def torch_popcount(words: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit word values held in ``int64`` (SWAR)."""
    x = words.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # in 64 bits the product keeps its upper bytes: take byte 3 alone
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def torch_popcount_rows(packed: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of a packed ``(..., W)`` tensor."""
    return torch_popcount(packed).sum(dim=-1, dtype=torch.int32)


def torch_lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the trailing word axis (word 0 least significant)."""
    w = a.shape[-1]
    lt = a[..., w - 1] < b[..., w - 1]
    eq = a[..., w - 1] == b[..., w - 1]
    for j in range(w - 2, -1, -1):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


def torch_lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def torch_lex_order(packed: torch.Tensor, *extra_keys: torch.Tensor) -> torch.Tensor:
    """Indices that sort rows ascending by ``(words, *extra_keys)``, stably.

    ``packed`` is ``(..., n, W)``; the sort runs over ``n`` for each leading
    index.  The words compare as one unsigned integer (the last word most
    significant); ``extra_keys`` (``(..., n)`` non-negative integers, the last
    least significant) break ties.  One ``torch.sort`` of a single int64 key
    when all of it fits 63 bits (up to 62 qubits with a 0/1 key); otherwise
    one stable pass per key from the least significant (``sqd_tpu`` sorts all
    keys in one multi-key ``lax.sort``, which torch lacks).
    """
    n, w = packed.shape[-2:]
    keys = [packed[..., j] for j in range(w - 1, -1, -1)] + list(extra_keys)  # msb first
    if n == 0:
        return torch.zeros(packed.shape[:-1], dtype=torch.int64, device=packed.device)
    widths = [32] * (w - 1) + [int(k.max()).bit_length() for k in extra_keys]
    if int(keys[0].max()).bit_length() + sum(widths) <= 63:
        key = keys[0]
        for k, width in zip(keys[1:], widths):
            key = (key << width) | k
        return torch.sort(key, dim=-1, stable=True).indices
    order = torch.arange(n, device=packed.device).expand(keys[0].shape).contiguous()
    for k in reversed(keys):
        step = torch.sort(torch.gather(k, -1, order), dim=-1, stable=True).indices
        order = torch.gather(order, -1, step)
    return order


def torch_sort_packed(packed: torch.Tensor, *payloads: torch.Tensor):
    """Sort rows of a packed tensor ascending; reorder payloads identically."""
    order = torch_lex_order(packed)
    sorted_packed = packed[order]
    return (sorted_packed, *(p[order] for p in payloads)) if payloads else sorted_packed


def _int64_keys(packed: torch.Tensor) -> torch.Tensor:
    """Rows of one or two words as one int64 each, ordered as the rows'
    unsigned values: ``(hi - 2**31) * 2**32 + lo`` stays inside int64."""
    if packed.shape[-1] == 1:
        return packed[..., 0].contiguous()
    return (packed[..., 1] - 2**31) * 2**32 + packed[..., 0]


def torch_searchsorted_packed(sorted_packed: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The left insertion point of each query among the sorted packed rows.

    Rows of at most two words (up to 64 bits) go through one
    ``torch.searchsorted`` over int64 keys, wider rows through
    :func:`_searchsorted_words` (which takes ~180 times as long over the
    5.6 M two-word queries of a config-5 same-spin chunk on an H100,
    ``probes/torch_table_builds.py``).  A query above every row gets ``n``
    (``sqd_tpu.ops.bitpack.jnp_searchsorted_packed`` runs one more step than
    it needs and then reports ``n + 1``, through its clamped gather; the
    ``find`` functions agree either way).
    """
    if sorted_packed.shape[-1] <= 2:
        return torch.searchsorted(_int64_keys(sorted_packed), _int64_keys(queries))
    return _searchsorted_words(sorted_packed, queries)


def _searchsorted_words(sorted_packed: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Branchless binary search on the words: one gather of whole rows and a
    lexicographic compare per step."""
    n = sorted_packed.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n, 1)))) + 1)
    q = queries.shape[0]
    lo = torch.zeros(q, dtype=torch.int64, device=queries.device)
    hi = torch.full((q,), n, dtype=torch.int64, device=queries.device)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        row = sorted_packed[torch.clamp(mid, max=max(n - 1, 0))]
        go_right = torch_lex_less(row, queries) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def torch_find_packed(sorted_packed: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index of each query in the sorted rows, or -1 if absent."""
    n = sorted_packed.shape[0]
    if n == 0:
        return torch.full((queries.shape[0],), -1, dtype=torch.int64, device=queries.device)
    pos = torch.clamp(torch_searchsorted_packed(sorted_packed, queries), max=n - 1)
    hit = torch_lex_eq(sorted_packed[pos], queries)
    return torch.where(hit, pos, -1)


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
