# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Incremental gather and neighbour table builds across SQD iterations.

A NumPy copy of ``sqd_tpu.ops.table_cache``.  The loop rebuilds the projected
Hamiltonian for every batch, but its string sets overlap heavily (carryover
and resampled strings), so each table build is split in two:

* **per-string half (cached)**: candidate excited and neighbour strings,
  fermionic signs and Slater-Condon matrix elements.  They depend only on the
  string and the integrals, never on the rest of the set, and are computed
  once per string by the native value kernels (``native.gather_values``,
  ``native.samespin_values``) into growing arrays keyed by the row's bytes;
* **per-set half (redone every build)**: membership of each candidate in the
  build's sorted set, one ``np.searchsorted`` over uint64 keys.

The tables equal the direct build (``native.gather_tables``,
``native.samespin_tables``) bit for bit.  Scope: packed width W <= 2
(<= 64 orbitals); :func:`sqd_tpu_torch.ops.hamiltonian.build_sci_hamiltonian`
takes the direct build otherwise.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["TableCache"]


def _u64_keys(packed: np.ndarray) -> np.ndarray:
    """uint64 sort keys of (n, W<=2) packed rows (most-significant word last)."""
    n, w = packed.shape
    key = packed[:, 0].astype(np.uint64)
    if w == 2:
        key |= packed[:, 1].astype(np.uint64) << np.uint64(32)
    return key


class _Store:
    """Append-only per-string row store with bytes-key lookup."""

    def __init__(self, row_shapes, dtypes):
        self._slots: dict[bytes, int] = {}
        self._arrays = [
            np.empty((0,) + shape, dt) for shape, dt in zip(row_shapes, dtypes)
        ]
        self.native_rows = 0  # rows computed by the native kernels

    def lookup(self, packed: np.ndarray, compute_new):
        """Rows for ``packed``, computing and appending missing ones via ``compute_new``."""
        rows = [r.tobytes() for r in packed]
        missing = [i for i, r in enumerate(rows) if r not in self._slots]
        TableCache.rows_requested += len(rows)
        if missing:
            new_arrays = compute_new(packed[missing])
            self.native_rows += len(missing)
            TableCache.rows_computed += len(missing)
            base = len(self._slots)
            for j, i in enumerate(missing):
                self._slots[rows[i]] = base + j
            self._arrays = [
                np.concatenate([a, n]) for a, n in zip(self._arrays, new_arrays)
            ]
        slots = np.fromiter((self._slots[r] for r in rows), np.int64, len(rows))
        return [a[slots] for a in self._arrays]


class TableCache:
    """Reusable per-string halves of the Hamiltonian table builds.

    One instance per (integrals, run): the same-spin matrix elements bake in
    ``h1e``/``eri``, so the cache fingerprints the integrals on first use and
    raises on a mismatch.  Not thread-safe; the loop uses it serially.

    ``TableCache.rows_requested`` and ``TableCache.rows_computed`` count, over
    every cache of the process, the per-string rows asked of the caches and
    those the native kernels computed; the rest were reused.
    """

    rows_requested = 0
    rows_computed = 0

    def __init__(self):
        self._gather: dict[int, _Store] = {}  # norb -> store
        self._samespin: dict[tuple, _Store] = {}  # (norb, nelec) -> store
        self._fingerprint = None

    @property
    def native_rows_computed(self) -> int:
        """Rows the native kernels have computed for this cache."""
        stores = list(self._gather.values()) + list(self._samespin.values())
        return sum(s.native_rows for s in stores)

    def _check_integrals(self, h1e, eri):
        fp = (
            hash(np.asarray(h1e, np.float64).tobytes()),
            hash(np.asarray(eri, np.float64).tobytes()),
        )
        if self._fingerprint is None:
            self._fingerprint = fp
        elif self._fingerprint != fp:
            raise ValueError(
                "TableCache was built for different integrals; create a new "
                "cache per (h1e, eri) pair"
            )

    @staticmethod
    def usable(strs_packed: np.ndarray) -> bool:
        return strs_packed.shape[1] <= 2

    def gather_tables(self, strs_packed: np.ndarray, norb: int):
        """(src, sign) tables equal to ``native.gather_tables``'."""
        strs_packed = np.ascontiguousarray(strs_packed, np.uint32)
        m, w = strs_packed.shape
        npair = norb * norb
        store = self._gather.setdefault(
            norb, _Store([(npair, w), (npair,)], [np.uint32, np.int8])
        )

        def compute(new_rows):
            vals, sign = native.gather_values(new_rows, norb)
            # native layout (npair, n, W) -> per-row (n, npair, W)
            return [np.ascontiguousarray(vals.transpose(1, 0, 2)), sign.T.copy()]

        gval, gsign = store.lookup(strs_packed, compute)  # (m, npair, W), (m, npair)
        set_keys = _u64_keys(strs_packed)
        cand = _u64_keys(gval.reshape(m * npair, w))
        pos = np.searchsorted(set_keys, cand)
        pos_c = np.minimum(pos, m - 1)
        found = (set_keys[pos_c] == cand) & (gsign.reshape(-1) != 0)
        src = np.where(found, pos_c, 0).astype(np.int32).reshape(m, npair).T
        sign = np.where(found, gsign.reshape(-1), 0).astype(np.int8).reshape(m, npair).T
        return np.ascontiguousarray(src), np.ascontiguousarray(sign)

    def samespin_tables(
        self, strs_packed, h1e, eri, norb: int, nelec: int, *, bucket: int = 8
    ):
        """(idx, val) neighbour lists equal to ``native.samespin_tables``'."""
        self._check_integrals(h1e, eri)
        strs_packed = np.ascontiguousarray(strs_packed, np.uint32)
        m, w = strs_packed.shape
        width_full = native.samespin_width(norb, nelec)
        store = self._samespin.setdefault(
            (norb, nelec),
            _Store([(width_full, w), (width_full,)], [np.uint32, np.float64]),
        )

        def compute(new_rows):
            return list(native.samespin_values(new_rows, h1e, eri, norb, nelec))

        nbr, val = store.lookup(strs_packed, compute)  # (m, width, W), (m, width)
        set_keys = _u64_keys(strs_packed)
        cand = _u64_keys(nbr.reshape(m * width_full, w))
        pos = np.searchsorted(set_keys, cand)
        pos_c = np.minimum(pos, m - 1)
        found = (set_keys[pos_c] == cand) & (val.reshape(-1) != 0.0)
        idx = np.where(found, pos_c, 0).astype(np.int32).reshape(m, width_full)
        vv = np.where(found, val.reshape(-1), 0.0).reshape(m, width_full)
        return native.compact_neighbours(idx, vv, bucket)
