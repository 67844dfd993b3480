# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Native (C++) host table kernels, bound with ctypes.

The source is the package's own ``csrc/sqdcore.cpp``, a copy of the functions
of ``sqd_tpu/native/sqdcore.cpp`` that are bound here, compiled with ``g++``
into this package's build directory at first use (see
:mod:`sqd_tpu_torch.build`).  Unlike ``sqd_tpu.native`` there is no NumPy
fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .build import load_library

__all__ = ["desdes_unique", "gather_tables", "popcount_rows", "samespin_tables", "load"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "sqdcore.cpp")
COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]

_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64, _int = ctypes.c_int64, ctypes.c_int


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once) and load ``sqdcore``; declare the four bound functions."""
    lib = load_library("sqdcore", SOURCE, COMMAND)
    lib.popcount_rows.argtypes = [_u32p, _i64, _int, _i64p]
    lib.popcount_rows.restype = None
    lib.desdes_unique.argtypes = [_u32p, _i64, _int, _int, _u32p, _u32p]
    lib.desdes_unique.restype = ctypes.c_int64
    lib.gather_tables.argtypes = [_u32p, _i64, _int, _int, _i32p, _i8p]
    lib.gather_tables.restype = None
    lib.samespin_candidates.argtypes = [
        _u32p, _i64, _int, _int, _int, _f64p, _f64p, _i32p, _f64p, _i64,
    ]
    lib.samespin_candidates.restype = None
    return lib


def popcount_rows(packed: np.ndarray) -> np.ndarray:
    """Per-row popcount of a packed ``(n, W)`` uint32 matrix."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    out = np.empty(packed.shape[0], dtype=np.int64)
    load().popcount_rows(packed, packed.shape[0], packed.shape[1], out)
    return out


def desdes_unique(strs_packed: np.ndarray, nelec: int) -> np.ndarray:
    """Sorted unique two-hole intermediates ``{I - u - v}`` of a string set."""
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    if n == 0 or nelec < 2:
        return np.zeros((0, w), dtype=np.uint32)
    pairs = nelec * (nelec - 1) // 2
    scratch = np.empty((n * pairs, w), dtype=np.uint32)
    out = np.empty((n * pairs, w), dtype=np.uint32)
    n_out = load().desdes_unique(strs_packed, n, w, nelec, scratch, out)
    return out[:n_out].copy()


def gather_tables(strs_packed: np.ndarray, norb: int):
    """``(src (norb^2, n) int32, sign (norb^2, n) int8)`` single-excitation tables."""
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    src = np.empty((norb * norb, n), dtype=np.int32)
    sign = np.empty((norb * norb, n), dtype=np.int8)
    load().gather_tables(strs_packed, n, w, norb, src, sign)
    return src, sign


def samespin_tables(strs_packed, h1e, eri, norb: int, nelec: int):
    """Compacted Slater-Condon neighbour lists ``(idx (n, L) int32, val (n, L) f64)``.

    The ``"enum"`` algorithm of ``sqd_tpu.native.samespin_tables``, with its
    compaction to a width bucketed by 8 reproduced bit for bit.  Where
    ``sqd_tpu`` switches to its intersection-driven ``"sparse"`` algorithm
    (``n * width_full`` above 4M probes) the port raises: not ported yet.
    """
    bucket = 8
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    nv = norb - nelec
    n_singles = nelec * nv
    n_doubles = (nelec * (nelec - 1) // 2) * (nv * (nv - 1) // 2)
    width_full = 1 + n_singles + n_doubles
    if n * width_full > 4_000_000:
        raise NotImplementedError(
            "the 'sparse' same-spin table algorithm (n * width_full > 4M) is not "
            "ported yet; see ROADMAP.md"
        )
    idx = np.empty((n, width_full), dtype=np.int32)
    val = np.empty((n, width_full), dtype=np.float64)
    load().samespin_candidates(
        strs_packed, n, w, norb, nelec,
        np.ascontiguousarray(h1e, np.float64), np.ascontiguousarray(eri, np.float64),
        idx, val, width_full,
    )
    # compact: entries with val == 0 contribute nothing -> push to the back
    valid = val != 0.0
    order = np.argsort(~valid, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    val = np.take_along_axis(val, order, axis=1)
    max_count = int(valid.sum(axis=1).max()) if n else 0
    width = min(width_full, max(bucket, -(-max_count // bucket) * bucket))
    idx = idx[:, :width].copy()
    val = val[:, :width].copy()
    # zero out anything past each row's valid prefix (stale values)
    keep = np.take_along_axis(valid, order, axis=1)[:, :width]
    idx[~keep] = 0
    val[~keep] = 0.0
    return idx, val
