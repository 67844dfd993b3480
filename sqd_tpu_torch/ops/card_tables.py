# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The operator's tables built on the card: the native enumeration in CUDA.

``csrc/sci_tables.cu`` computes what :func:`sqd_tpu_torch.native.gather_tables`
and :func:`sqd_tpu_torch.native.samespin_tables` compute on the host, with the
same candidates in the same order and the same f64 arithmetic in the same
order, so the tables are the host's bit for bit, their widths included (the
source's header says how).  It is built with ``nvcc`` for ``sm_90a`` at first
use and bound with ctypes.

* :func:`build_tables` — both spins' gather tables and same-spin neighbour
  lists, the eight tables of an operator, on a CUDA device, in the dtypes
  :class:`sqd_tpu_torch.ops.hamiltonian.SCIHamiltonian` stores (counted in
  ``build_tables.launches``, one per call), with one host synchronisation,
  which reads both spins' widths.
* :func:`gather_tables` — one spin's gather tables alone, as
  :func:`sqd_tpu_torch.ops.hamiltonian.build_sci_basis` wants them (counted
  in ``gather_tables.launches``, one per call).
* :func:`takes` — whether the kernels take a packed string matrix: at most
  ``MAX_WORDS`` words a string (64 orbitals), one 64-bit key each.
* :func:`slot_table` — each candidate's occupied and virtual positions, in
  the host's order, one ``uint32`` each: what a thread decodes.

The plain version, which the tests hold the kernels to, is the native host
build itself; the CPU takes it (``tables_backend="native"``), and these
functions take only a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np
import torch

from .. import native
from ..build import load_library

__all__ = ["build_tables", "gather_tables", "slot_table", "takes"]

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "sci_tables.cu"
)
# --fmad=false: no multiply-add contraction, so every f64 sum rounds as the
# host library's (g++ -O3 for x86-64, no FMA)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
MAX_WORDS = 2


def takes(strs_packed) -> bool:
    """True when the kernels take this packed ``(n, W)`` matrix: ``W <= 2``."""
    return np.asarray(strs_packed).shape[1] <= MAX_WORDS


@functools.cache
def slot_table(norb: int, nelec: int) -> np.ndarray:
    """``(width_full,) uint32``: candidate ``c`` of a row in the host's order,
    ``a | b << 8 | k << 16 | l << 24`` with ``a < b`` positions among the
    occupied orbitals and ``k < l`` among the virtual ones.  Entry 0 is the
    diagonal; singles ``(a, k)`` follow, then doubles ``(a, b, k, l)``."""
    nv = norb - nelec
    a, k = np.divmod(np.arange(nelec * nv, dtype=np.uint32), np.uint32(max(nv, 1)))
    oa, ob = np.triu_indices(nelec, k=1)
    vk, vl = np.triu_indices(nv, k=1)
    doubles = (oa[:, None] | ob[:, None] << 8 | vk[None] << 16 | vl[None] << 24).ravel()
    return np.concatenate([[0], a | k << 16, doubles]).astype(np.uint32)


@functools.cache
def _device_slots(norb: int, nelec: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(slot_table(norb, nelec).view(np.int32)).to(device)


@functools.cache
def _library() -> ctypes.CDLL:
    # nvcc from the PATH, else from the toolkit's default prefix
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = load_library("sci_tables", SOURCE, [nvcc, *NVCC_FLAGS])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sci_gather_tables.argtypes = [vp, i64, i32, vp, vp, vp]
    lib.sci_samespin_count.argtypes = [vp, i64, i32, i32, vp, i32, vp, vp, vp, vp]
    lib.sci_samespin_fill.argtypes = [vp, i64, i32, i32, vp, i32, vp, vp, vp, vp, i32, vp]
    for fn in (lib.sci_gather_tables, lib.sci_samespin_count, lib.sci_samespin_fill):
        fn.restype = ctypes.c_int
    return lib


def _keys(strs_packed) -> np.ndarray:
    """One 64-bit key a string (word 0 low), ordered as the packed rows."""
    packed = np.ascontiguousarray(strs_packed, dtype=np.uint32)
    if packed.ndim != 2 or not takes(packed):
        raise ValueError(f"the card tables take (n, <= {MAX_WORDS}) packed strings, "
                         f"got {packed.shape}")
    keys = packed[:, 0].astype(np.uint64)
    if packed.shape[1] == 2:
        keys |= packed[:, 1].astype(np.uint64) << np.uint64(32)
    return keys.view(np.int64)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _gather(lib, keys: torch.Tensor, norb: int, stream: int):
    n = keys.shape[0]
    src = torch.empty((norb * norb, n), dtype=torch.int64, device=keys.device)
    sign = torch.empty((norb * norb, n), dtype=torch.int8, device=keys.device)
    _check(lib.sci_gather_tables(keys.data_ptr(), n, norb, src.data_ptr(), sign.data_ptr(),
                                 stream), "sci_gather_tables")
    return src, sign


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the card tables take a CUDA device, got {device}")
    return device


def gather_tables(strs_packed, norb: int, *, device):
    """``(src (norb^2, n) int64, sign (norb^2, n) int8)`` on the CUDA ``device``:
    equal to :func:`sqd_tpu_torch.native.gather_tables`' (its ``src`` as int64)."""
    device = _cuda_device(device)
    keys = torch.from_numpy(_keys(strs_packed)).to(device)
    with torch.cuda.device(device):
        tables = _gather(_library(), keys, norb, torch.cuda.current_stream(device).cuda_stream)
    gather_tables.launches += 1
    return tables


def build_tables(strs_a_packed, strs_b_packed, h1e, eri, norb: int, nelec, *, device):
    """``(src_a, sign_a, src_b, sign_b, idx_a, val_a, idx_b, val_b)`` on the CUDA ``device``.

    Equal to the native host build: ``native.gather_tables`` of each spin
    (``src`` as int64) and ``native.samespin_tables`` (``idx`` as int64,
    ``val`` f64, ``(n, L)`` with ``L`` the most kept neighbours of a row
    rounded up to ``native.BUCKET``, capped at the full
    candidate width).  ``eri`` is chemist ``(pq|rs)``, ``norb^4``.  The
    strings are sorted, of weights ``nelec``, at most ``MAX_WORDS`` words.
    """
    device = _cuda_device(device)
    n_a, n_b = (int(x) for x in nelec)
    keys_a, keys_b = _keys(strs_a_packed), _keys(strs_b_packed)
    m = len(keys_a)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        keys = torch.from_numpy(np.concatenate([keys_a, keys_b])).to(device)
        h1 = torch.from_numpy(np.ascontiguousarray(h1e, np.float64)).to(device)
        eri_d = torch.from_numpy(np.ascontiguousarray(eri, np.float64)).to(device)
        spins = ((keys[:m], n_a), (keys[m:], n_b))
        tables = [t for k, _ in spins for t in _gather(lib, k, norb, stream)]
        most = torch.zeros(2, dtype=torch.int32, device=device)
        args = []
        for s, (k, ne) in enumerate(spins):
            slots = _device_slots(norb, ne, device)
            args.append((k.data_ptr(), k.shape[0], norb, ne, slots.data_ptr(), slots.shape[0],
                         h1.data_ptr(), eri_d.data_ptr()))
            _check(lib.sci_samespin_count(*args[-1], most[s:].data_ptr(), stream),
                   "sci_samespin_count")
        bucket = native.BUCKET
        for (k, ne), fill_args, count in zip(spins, args, most.tolist()):  # the one sync
            width_full = native.samespin_width(norb, ne)
            width = min(width_full, max(bucket, -(-count // bucket) * bucket))
            idx = torch.zeros((k.shape[0], width), dtype=torch.int64, device=device)
            val = torch.zeros((k.shape[0], width), dtype=torch.float64, device=device)
            _check(lib.sci_samespin_fill(*fill_args, idx.data_ptr(), val.data_ptr(), width,
                                         stream), "sci_samespin_fill")
            tables += [idx, val]
    build_tables.launches += 1
    return tuple(tables)


build_tables.launches = 0
gather_tables.launches = 0
