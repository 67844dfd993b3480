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

__all__ = [
    "ao_integrals_cart",
    "available",
    "compact_neighbours",
    "connected_membership",
    "desdes_unique",
    "gather_tables",
    "gather_values",
    "pauli_diag_elements",
    "popcount_rows",
    "samespin_tables",
    "samespin_values",
    "samespin_width",
    "load",
]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "sqdcore.cpp")
COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]

_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64, _int = ctypes.c_int64, ctypes.c_int


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once) and load ``sqdcore``; declare the bound functions."""
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
    lib.gather_values.argtypes = [_u32p, _i64, _int, _int, _u32p, _i8p]
    lib.gather_values.restype = None
    lib.samespin_values.argtypes = [
        _u32p, _i64, _int, _int, _int, _f64p, _f64p, _u32p, _f64p, _i64,
    ]
    lib.samespin_values.restype = None
    lib.samespin_sparse_count.argtypes = [_u32p, _i64, _int, _int, _int, _f64p, _f64p, _i64p]
    lib.samespin_sparse_count.restype = ctypes.c_int64
    lib.samespin_sparse_fill.argtypes = [
        _u32p, _i64, _int, _int, _int, _f64p, _f64p, _i32p, _f64p, _i64,
    ]
    lib.samespin_sparse_fill.restype = None
    lib.connected_membership64.argtypes = [_u32p, _i64, _u32p, _i64p]
    lib.connected_membership64.restype = None
    lib.pauli_diag_from_bool.argtypes = [
        _u8p, _i64, _int, _u8p, ctypes.c_double, ctypes.c_double, _f64p, _i64p, _i64p,
    ]
    lib.pauli_diag_from_bool.restype = None
    lib.pauli_diag_from_packed.argtypes = [
        _u32p, _i64, _int, _u32p, ctypes.c_double, ctypes.c_double, _f64p, _i64p, _i64p,
    ]
    lib.pauli_diag_from_packed.restype = None
    lib.ao_integrals_cart.argtypes = [
        _int, _i32p, _f64p, _i32p, _f64p, _f64p, _int, _f64p, _f64p, _int,
        _f64p, _f64p, _f64p, _f64p,
    ]
    lib.ao_integrals_cart.restype = _int
    return lib


def available() -> bool:
    """True once the native library is built and loaded.  The port has no
    NumPy fallback: a build or load that fails raises here instead."""
    load()
    return True


def popcount_rows(packed: np.ndarray) -> np.ndarray:
    """Per-row popcount of a packed ``(n, W)`` uint32 matrix."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    out = np.empty(packed.shape[0], dtype=np.int64)
    load().popcount_rows(packed, packed.shape[0], packed.shape[1], out)
    return out


def connected_membership(sorted_packed: np.ndarray, x_words: np.ndarray) -> np.ndarray:
    """Index of ``row XOR x`` within the sorted set, or -1 (radix sort and merge).

    For packed widths ``w <= 2`` (at most 64 qubits); a wider matrix raises
    ``ValueError`` (callers take the device tables there).
    """
    sorted_packed = np.ascontiguousarray(sorted_packed, dtype=np.uint32)
    n, w = sorted_packed.shape
    if w > 2:
        raise ValueError(f"connected_membership takes at most 2 words per row, got {w}")
    x_arr = np.zeros(2, dtype=np.uint32)
    x_arr[:w] = np.asarray(x_words, np.uint32)[:w]
    if w == 1:
        sorted_packed = np.ascontiguousarray(
            np.concatenate([sorted_packed, np.zeros((n, 1), np.uint32)], axis=1))
    out = np.empty(n, dtype=np.int64)
    load().connected_membership64(sorted_packed, n, x_arr, out)
    return out


def pauli_diag_elements(mat: np.ndarray, zmask: np.ndarray, phase: complex):
    """``(amplitudes, rows, cols)`` of a diagonal Pauli term in one pass.

    ``amp_i = phase * (-1)^popcount(row_i AND z)``, ``rows = cols = arange``.

    Args:
        mat: ``(n, nq)`` bool matrix with ``zmask`` the per-COLUMN 0/1 byte
            mask (column order, i.e. qubit order reversed), or ``(n, W)``
            packed uint32 with ``zmask`` the packed z words (length >= W;
            extra words must be zero, as the caller checks).
    """
    n = int(mat.shape[0])
    amps = np.empty(2 * n, dtype=np.float64)
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    ph_re, ph_im = float(np.real(phase)), float(np.imag(phase))
    if mat.dtype == np.uint32:
        packed = np.ascontiguousarray(mat)
        w = packed.shape[1]
        zw = np.zeros(w, dtype=np.uint32)
        zm = np.asarray(zmask, dtype=np.uint32)
        zw[: min(w, len(zm))] = zm[:w]
        load().pauli_diag_from_packed(packed, n, w, zw, ph_re, ph_im, amps, rows, cols)
    elif mat.dtype == np.bool_:
        zsel = np.ascontiguousarray(np.asarray(zmask, dtype=np.uint8))
        if len(zsel) != mat.shape[1]:
            raise ValueError(f"z mask of {len(zsel)} columns for a {mat.shape[1]}-column matrix")
        bm = np.ascontiguousarray(mat).view(np.uint8)
        load().pauli_diag_from_bool(bm, n, mat.shape[1], zsel, ph_re, ph_im, amps, rows, cols)
    else:
        raise TypeError(f"expected a bool or packed uint32 matrix, got {mat.dtype}")
    return amps.view(np.complex128), rows, cols


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


def gather_values(strs_packed: np.ndarray, norb: int):
    """Set-independent single-excitation candidates of each string.

    ``(vals (norb^2, n, W) uint32, sign (norb^2, n) int8)``: the source string
    ``I = J - p + q`` for every pair and target ``J``, and its parity (0 where
    the excitation is invalid on ``J``).  Membership in a string set is
    resolved by :mod:`sqd_tpu_torch.ops.table_cache`.
    """
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    vals = np.empty((norb * norb, n, w), dtype=np.uint32)
    sign = np.empty((norb * norb, n), dtype=np.int8)
    load().gather_values(strs_packed, n, w, norb, vals, sign)
    return vals, sign


def samespin_width(norb: int, nelec: int) -> int:
    """Candidates per string: the diagonal, the singles and the doubles."""
    nv = norb - nelec
    return 1 + nelec * nv + (nelec * (nelec - 1) // 2) * (nv * (nv - 1) // 2)


def samespin_values(strs_packed, h1e, eri, norb: int, nelec: int):
    """Set-independent Slater-Condon neighbour candidates of each string.

    ``(nbr (n, width, W) uint32, val (n, width) f64)``: candidate neighbour
    strings (row layout [diagonal, singles, doubles]) and their signed matrix
    elements, with no membership filtering.
    """
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    width_full = samespin_width(norb, nelec)
    nbr = np.empty((n, width_full, w), dtype=np.uint32)
    val = np.empty((n, width_full), dtype=np.float64)
    load().samespin_values(
        strs_packed, n, w, norb, nelec,
        np.ascontiguousarray(h1e, np.float64), np.ascontiguousarray(eri, np.float64),
        nbr, val, width_full,
    )
    return nbr, val


def samespin_tables(
    strs_packed, h1e, eri, norb: int, nelec: int, *, bucket: int = 8, algo: str = "auto"
):
    """Compacted Slater-Condon neighbour lists ``(idx (n, L) int32, val (n, L) f64)``.

    ``sqd_tpu.native.samespin_tables``, bit for bit, with its two algorithms;
    either way ``L`` is the most neighbours of any string rounded up to a
    multiple of ``bucket`` (at least ``bucket``), capped at ``width_full``:

    * ``"enum"``: every one of the ``width_full`` candidate excitations of
      each string, binary-searched in the set, then compacted;
    * ``"sparse"``: two strings are singly (doubly) connected iff they share
      a one-hole (two-hole) core, so sorting the cores groups exactly the
      connected pairs; the work follows the output, not ``width_full``.

    ``"auto"`` takes ``"sparse"`` once ``n * width_full`` passes 4M probes.
    """
    strs_packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    n, w = strs_packed.shape
    width_full = samespin_width(norb, nelec)
    if algo not in ("auto", "enum", "sparse"):
        raise ValueError(f"unknown samespin algo {algo!r}")
    h1c = np.ascontiguousarray(h1e, np.float64)
    eric = np.ascontiguousarray(eri, np.float64)
    lib = load()
    if algo == "sparse" or (algo == "auto" and n * width_full > 4_000_000):
        counts = np.empty(n, dtype=np.int64)
        most = int(lib.samespin_sparse_count(strs_packed, n, w, norb, nelec, h1c, eric, counts))
        width = min(width_full, max(bucket, -(-most // bucket) * bucket))
        idx = np.zeros((n, width), dtype=np.int32)
        val = np.zeros((n, width), dtype=np.float64)
        lib.samespin_sparse_fill(strs_packed, n, w, norb, nelec, h1c, eric, idx, val, width)
        return idx, val
    idx = np.empty((n, width_full), dtype=np.int32)
    val = np.empty((n, width_full), dtype=np.float64)
    lib.samespin_candidates(strs_packed, n, w, norb, nelec, h1c, eric, idx, val, width_full)
    return compact_neighbours(idx, val, bucket)


def compact_neighbours(idx: np.ndarray, val: np.ndarray, bucket: int = 8):
    """Valid entries (``val != 0``) first in each row, the width cut to a multiple
    of ``bucket``, and everything past a row's valid prefix zeroed."""
    n, width_full = val.shape
    valid = val != 0.0
    order = np.argsort(~valid, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    val = np.take_along_axis(val, order, axis=1)
    max_count = int(valid.sum(axis=1).max()) if n else 0
    width = min(width_full, max(bucket, -(-max_count // bucket) * bucket))
    idx = idx[:, :width].copy()
    val = val[:, :width].copy()
    keep = np.take_along_axis(valid, order, axis=1)[:, :width]
    idx[~keep] = 0
    val[~keep] = 0.0
    return idx, val


def ao_integrals_cart(shells, charges, coords):
    """Cartesian AO integrals ``(S, T, V, eri)`` by the native
    McMurchie-Davidson kernel (eri in chemist ``(pq|rs)``, full 4-index).

    ``shells`` is the :class:`sqd_tpu_torch.chem.integrals.Shell` list of a
    built Molecule (normalized coefficients).  Returns ``None`` when a shell
    has l > 2, the route to the NumPy quartets of
    :func:`sqd_tpu_torch.chem.integrals.ao_integrals`; anything else the
    kernel refuses raises.
    """
    if any(sh.l > 2 for sh in shells):
        return None
    ls = np.ascontiguousarray([sh.l for sh in shells], dtype=np.int32)
    centers = np.ascontiguousarray(
        np.concatenate([np.asarray(sh.center, np.float64) for sh in shells]))
    prim_offs = np.zeros(len(shells) + 1, dtype=np.int32)
    prim_offs[1:] = np.cumsum([len(sh.exps) for sh in shells])
    exps = np.ascontiguousarray(np.concatenate([np.asarray(sh.exps, np.float64) for sh in shells]))
    coefs = np.ascontiguousarray(
        np.concatenate([np.asarray(sh.coefs, np.float64) for sh in shells]))
    charges = np.ascontiguousarray(charges, dtype=np.float64)
    coords = np.ascontiguousarray(coords, dtype=np.float64).reshape(-1)
    nao = int(sum((sh.l + 1) * (sh.l + 2) // 2 for sh in shells))
    s = np.zeros((nao, nao))
    t = np.zeros((nao, nao))
    v = np.zeros((nao, nao))
    eri = np.zeros((nao, nao, nao, nao))
    rc = load().ao_integrals_cart(
        len(shells), ls, centers, prim_offs, exps, coefs,
        len(charges), charges, coords, nao, s, t, v, eri,
    )
    if rc != 0:
        raise RuntimeError(f"ao_integrals_cart refused its input (code {rc})")
    return s, t, v, eri
