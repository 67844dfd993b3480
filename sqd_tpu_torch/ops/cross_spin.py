# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The cross-spin SCI matvec channel: CUDA kernels and their plain PyTorch version.

``sigma = sum_rs E^b_rs [ sum_pq eri[rs, pq] E^a_pq c ]`` — the
opposite-spin channel that holds almost all the FLOPs of the matvec.  In f32
it replaces the Pallas TPU kernel
``sqd_tpu/ops/pallas_matvec.py::cross_spin_matvec``; in f64 (the exact
operator: the refinement, the f64 Davidson and the energy) it replaces the
dense route that ``sqd_tpu`` hands to XLA.  Both kernels are in
``sqd_tpu_torch/csrc/cross_spin_matvec.cu``, whose notes say what bounds
each on Hopper and how its design answers that.

* :func:`cross_spin_matvec` and :func:`cross_spin_matvec_f64` — the
  wrappers.  A CPU tensor goes to the plain version; a CUDA tensor goes to
  the kernel, which is built with ``nvcc`` for ``sm_90a`` at first use.  A
  failed build or launch raises: there is no fallback.
* :func:`cross_spin_plain` — the plain PyTorch version, in the operands'
  dtype: ``gather_alpha``, then ``eri @ d``, then ``scatter_beta``, as in
  the full matvec.
* :func:`prepare` — the operands in the forms both want, built once per
  operator: the valid pairs of every alpha row and of every beta column
  compacted (the TPU kernel re-derived the alpha side inside every call and
  relied on XLA to hoist it), the beta side sorted by source.  The alpha
  tables may cover only some rows of ``c``: a row shard's tables give its
  own output rows and read source rows anywhere in ``c``
  (:mod:`sqd_tpu_torch.parallel.row_sharded`).  :func:`with_eri` gives the
  same tables with another coefficient matrix (the f64 operands of an
  operator whose f32 ones exist).
* :func:`row_stride` and :func:`plan` — a kernel's shared-memory layout for
  4- or 8-byte elements: the row stride, and how many columns of ``c`` and
  pair rows of ``A`` a block stages at once.

The kernel computes, for alpha row ``i`` and beta column ``j``,
``sum_t kb_sgn[j,t] * sum_l A_i[kb_rs[j,t], l] * c[ka_src[i,l], kb_src[j,t]]``
with ``A_i[rs, l] = eri[rs, ka_pq[i,l]] * ka_sgn[i,l]``: only the entries of
``g_i = eri @ (E^a c)_i`` that the beta pick reads.

The spin-penalty mixed term rides through ``eri`` exactly as in
``sqd_tpu``: the caller folds ``-shift`` into ``eri[qp, pq]`` and adds the
elementwise ``shift * (const - target) * c`` itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
from dataclasses import dataclass

import torch

from ..build import load_library
from .precision import highest_precision

__all__ = [
    "CrossSpinOperands", "cross_spin_matvec", "cross_spin_matvec_f64", "cross_spin_plain", "plan",
    "prepare", "row_stride", "with_eri",
]

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "cross_spin_matvec.cu"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
SMEM_BYTES = 232_448  # shared memory one block may use on Hopper (kMaxSmem in the source)
MIN_TILE_COLS = 256  # columns of c staged beside the whole of A before the rs axis is tiled
MIN_TILE_COLS_F64 = 128  # the same in f64, where a row takes twice the bytes
LIST_ROWS = {4: 3, 8: 2}  # shared rows of the alpha row's pair lists (16 bytes a pair), by itemsize
PLAIN_CHUNK_BYTES = 2 * 1024**3  # largest (npair, rows, N) intermediate of the plain version


@dataclass(frozen=True)
class CrossSpinOperands:
    """One operator's cross-spin tables, on one device.

    The floating-point fields share one dtype, f32 or f64, which the
    kernel that takes them computes in; the integer tables do not depend on
    it.  Plain-version fields: ``src_a``/``src_b`` int64 ``(npair, M|N)``,
    ``sign_a``/``sign_b`` and ``eri`` ``(npair, npair)``.  ``M`` is the
    count of output rows; the alpha sources index the rows of an amplitude
    matrix with at least ``src_rows`` rows (``M`` itself for a whole
    operator, more for a row shard).  Kernel fields, zero past each count:

    * ``ka_n (M,)`` int32 valid-pair counts of the alpha rows, and
      ``ka_pq``/``ka_src`` int32 and ``ka_sgn`` ``(M, ka)``: pair index,
      source row and sign, in ascending pair order, C-contiguous;
    * ``kb_n (N,)`` int32 valid-pair counts of the beta columns, and
      ``kb_rs``/``kb_src`` int32 and ``kb_sgn`` ``(N, kb)``: pair index,
      source column and sign, sorted by source (then pair), stored
      entry-major (``kb_rs.T`` is C-contiguous) so the kernel's loads
      coalesce.
    """

    src_a: torch.Tensor
    sign_a: torch.Tensor
    src_b: torch.Tensor
    sign_b: torch.Tensor
    eri: torch.Tensor
    ka_n: torch.Tensor
    ka_pq: torch.Tensor
    ka_src: torch.Tensor
    ka_sgn: torch.Tensor
    kb_n: torch.Tensor
    kb_rs: torch.Tensor
    kb_src: torch.Tensor
    kb_sgn: torch.Tensor
    src_rows: int

    @property
    def shape(self) -> tuple[int, int]:
        """``(output rows, columns)``."""
        return self.src_a.shape[1], self.src_b.shape[1]


def _compact(src, sign, key, dtype):
    """Each determinant's valid pairs, in ``key`` order (valid keys sort first).

    From ``(npair, n)`` clamped tables: counts ``(n,)`` int32 and the pair
    index, source and sign (in ``dtype``), each ``(k, n)`` with ``k`` the
    largest count (at least 1), zero past each count.
    """
    valid = sign != 0
    counts = valid.sum(dim=0)
    width = max(int(counts.max()) if counts.numel() else 0, 1)
    order = torch.argsort(key, dim=0, stable=True)[:width]
    ok = torch.gather(valid, 0, order)
    return (
        counts.to(torch.int32).contiguous(),
        torch.where(ok, order, 0).to(torch.int32),
        torch.where(ok, torch.gather(src, 0, order), 0).to(torch.int32),
        torch.where(ok, torch.gather(sign, 0, order).to(dtype), 0.0),
    )


def prepare(src_a, sign_a, src_b, sign_b, eri) -> CrossSpinOperands:
    """Build the operands from clamped gather tables and the ``(npair, npair)``
    coefficient matrix (penalty already folded in), on their device, in the
    matrix's dtype (f32 or f64).

    ``src_a``/``sign_a`` hold one column per output row; their sources may
    point past those rows (a row shard's tables index the whole ``c``)."""
    dt = eri.dtype
    # alpha: valid pairs first, in ascending pq order (stable sort)
    ka_n, ka_pq, ka_src, ka_sgn = _compact(src_a, sign_a, (sign_a == 0).to(torch.uint8), dt)
    # beta: valid pairs by source, so a tile of sources is a contiguous run
    n = src_b.shape[1]
    kb_n, kb_rs, kb_src, kb_sgn = _compact(
        src_b, sign_b, torch.where(sign_b != 0, src_b.to(torch.int64), n), dt)
    return CrossSpinOperands(
        src_a=src_a.to(torch.int64),
        sign_a=sign_a.to(dt),
        src_b=src_b.to(torch.int64),
        sign_b=sign_b.to(dt),
        eri=eri.contiguous(),
        ka_n=ka_n,
        ka_pq=ka_pq.T.contiguous(),
        ka_src=ka_src.T.contiguous(),
        ka_sgn=ka_sgn.T.contiguous(),
        kb_n=kb_n,
        kb_rs=kb_rs.contiguous().T,
        kb_src=kb_src.contiguous().T,
        kb_sgn=kb_sgn.contiguous().T,
        src_rows=max(int(src_a.max()) + 1 if src_a.numel() else 0, src_a.shape[1]),
    )


def with_eri(ops: CrossSpinOperands, eri: torch.Tensor) -> CrossSpinOperands:
    """``ops``' tables with another ``(npair, npair)`` coefficient matrix, in
    its dtype: the integer tables are shared, the signs (0 and ±1, exact in
    any float type) cast."""
    dt = eri.dtype
    return dataclasses.replace(
        ops, eri=eri.contiguous(), sign_a=ops.sign_a.to(dt), sign_b=ops.sign_b.to(dt),
        ka_sgn=ops.ka_sgn.to(dt), kb_sgn=ops.kb_sgn.T.to(dt).T,  # kb_sgn stays entry-major
    )


def cross_spin_plain(c: torch.Tensor, ops: CrossSpinOperands) -> torch.Tensor:
    """The plain PyTorch version, in the operands' dtype: gather, one
    matmul, gather back.

    Output rows are independent, so the ``(npair, rows, N)`` intermediates
    are built for at most ``PLAIN_CHUNK_BYTES`` at a time.
    """
    npair = ops.eri.shape[0]
    _check_rows(c, ops)
    m, n = ops.shape
    dt = ops.eri.dtype
    c = c.to(dt)
    step = max(1, min(m, PLAIN_CHUNK_BYTES // (c.element_size() * npair * n)))
    out = torch.empty((m, n), dtype=dt, device=c.device)
    for i0 in range(0, m, step):
        rows = slice(i0, i0 + step)
        with highest_precision():
            d = ops.sign_a[:, rows, None] * c[ops.src_a[:, rows]]  # (npair, r, N)
            r = d.shape[1]
            g = (ops.eri @ d.reshape(npair, r * n)).reshape(npair, r, n)
        del d
        picked = torch.gather(g, 2, ops.src_b[:, None, :].expand(npair, r, n))
        out[rows] = (ops.sign_b[:, None, :] * picked).sum(dim=0)
    return out


def _check_rows(c: torch.Tensor, ops: CrossSpinOperands) -> None:
    if c.dim() != 2 or c.shape[1] != ops.shape[1] or c.shape[0] < ops.src_rows:
        raise ValueError(f"amplitudes of shape {tuple(c.shape)} for operator {ops.shape} "
                         f"reading {ops.src_rows} rows")


def row_stride(ka: int, itemsize: int = 4) -> int:
    """Shared row stride, in elements of ``itemsize`` bytes (4 for the f32
    kernel, 8 for the f64 one), for up to ``ka`` alpha pairs per row: a
    whole number of 16-byte groups, and an odd one, so that 16-byte reads of
    random rows spread over the eight bank groups."""
    per = 16 // itemsize  # elements of a 16-byte group
    q = -(-ka // per)
    return per * (q + 1 - q % 2)


def plan(n: int, npair: int, kp: int, smem_bytes: int = SMEM_BYTES,
         itemsize: int = 4) -> tuple[int, int]:
    """``(tile_cols, tile_rs)``: the columns of ``c`` and the pair rows of
    ``A`` a block stages in ``smem_bytes`` of shared memory at once, at row
    stride ``kp`` elements of ``itemsize`` bytes (the alpha row's pair lists
    take 16 bytes a pair more: three f32 rows, or two f64 rows).

    All of ``A`` when it fits beside ``min(n, MIN_TILE_COLS)`` columns in f32
    (the headline: all 256 rows and all 1024 columns) or ``MIN_TILE_COLS_F64``
    in f64 (the CASCI: all 256 rows beside 210 columns), else half the rows
    each.
    """
    min_cols = MIN_TILE_COLS if itemsize == 4 else MIN_TILE_COLS_F64
    rows = smem_bytes // (itemsize * kp) - LIST_ROWS[itemsize]
    if rows < 2:
        raise ValueError(f"a shared row of {kp} elements leaves no room for two rows")
    tile_rs = npair if npair + min(n, min_cols) <= rows else min(npair, rows // 2)
    return min(n, rows - tile_rs), tile_rs


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    # nvcc from the PATH, else from the toolkit's default prefix
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = load_library("cross_spin_matvec", SOURCE, [nvcc, *NVCC_FLAGS])
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.cross_spin_matvec_f32, lib.cross_spin_matvec_f64):
        entry.argtypes = [
            vp, i32, i32, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp, vp,
        ]
        entry.restype = ctypes.c_int
    return lib


def _launch(entry: str, c: torch.Tensor, ops: CrossSpinOperands,
            tiles: tuple[int, int] | None) -> torch.Tensor:
    """Check ``c`` and ``ops`` for the kernel of ``entry`` (``"f32"`` or
    ``"f64"``), launch it on the current stream and return ``sigma``."""
    if c.device.type != "cuda":
        wrapper = "cross_spin_matvec" + ("" if entry == "f32" else "_f64")
        raise ValueError(f"{wrapper} takes CPU or CUDA tensors, got {c.device}")
    dtype = torch.float32 if entry == "f32" else torch.float64
    if c.dtype != dtype:
        raise TypeError(f"the cross-spin kernel computes in {entry}, got {c.dtype}")
    _check_rows(c, ops)
    if not c.is_contiguous():
        raise ValueError("the cross-spin kernel needs C-contiguous amplitudes")
    kb_tables = (ops.kb_rs.T, ops.kb_src.T, ops.kb_sgn.T)  # entry-major
    for t in (ops.ka_n, ops.ka_pq, ops.ka_src, ops.ka_sgn, ops.kb_n, *kb_tables, ops.eri):
        if t.device != c.device or not t.is_contiguous():
            raise ValueError("cross-spin operands must be laid out as prepare() makes them, "
                             "on the amplitudes' device")
    if not ops.eri.dtype == ops.ka_sgn.dtype == ops.kb_sgn.dtype == dtype:
        raise TypeError(f"the {entry} kernel takes {entry} operands, got {ops.eri.dtype}")
    m, n = ops.shape  # the kernel's grid is the output rows
    npair, ka = ops.eri.shape[0], ops.ka_pq.shape[1]
    itemsize = c.element_size()
    kp = row_stride(ka, itemsize)
    tile_cols, tile_rs = plan(n, npair, kp, itemsize=itemsize) if tiles is None else tiles
    if not (1 <= tile_cols and 1 <= tile_rs <= npair
            and itemsize * kp * (tile_cols + tile_rs + LIST_ROWS[itemsize]) <= SMEM_BYTES):
        raise ValueError(f"tiles {(tile_cols, tile_rs)} do not fit in shared memory")
    launch = getattr(_kernel_library(), "cross_spin_matvec_" + entry)
    out = torch.empty((m, n), dtype=dtype, device=c.device)
    with torch.cuda.device(c.device):
        rc = launch(
            c.data_ptr(), m, n,
            ops.ka_n.data_ptr(), ops.ka_pq.data_ptr(), ops.ka_src.data_ptr(),
            ops.ka_sgn.data_ptr(), ka,
            ops.kb_n.data_ptr(), *(t.data_ptr() for t in kb_tables),
            ops.eri.data_ptr(), npair, kp, tile_cols, tile_rs,
            out.data_ptr(), torch.cuda.current_stream(c.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross_spin_matvec_{entry} kernel launch failed: CUDA error {rc}")
    return out


def cross_spin_matvec(
    c: torch.Tensor, ops: CrossSpinOperands, *, tiles: tuple[int, int] | None = None
) -> torch.Tensor:
    """``sigma (M, N) f32`` of the cross-spin channel for amplitudes ``c``.

    ``M`` is the operands' output rows; ``c`` has their ``N`` columns and at
    least ``ops.src_rows`` rows (``M`` for a whole operator).  CPU tensors
    take :func:`cross_spin_plain`; CUDA tensors the hand-written f32 kernel
    (counted in ``cross_spin_matvec.launches``), with f32 operands.
    ``tiles`` overrides the kernel's ``(tile_cols, tile_rs)`` of
    :func:`plan`; the result is the same function for any tiles that fit.
    """
    if c.device.type == "cpu":
        return cross_spin_plain(c, ops)
    out = _launch("f32", c, ops, tiles)
    cross_spin_matvec.launches += 1
    return out


cross_spin_matvec.launches = 0


def cross_spin_matvec_f64(
    c: torch.Tensor, ops: CrossSpinOperands, *, tiles: tuple[int, int] | None = None
) -> torch.Tensor:
    """``sigma (M, N) f64`` of the cross-spin channel for amplitudes ``c``:
    :func:`cross_spin_matvec` in f64, for the exact operator.

    CPU tensors take :func:`cross_spin_plain`; CUDA tensors the hand-written
    f64 kernel, with f64 operands (:func:`with_eri` or :func:`prepare` with
    an f64 matrix), counted in ``cross_spin_matvec_f64.launches`` and not in
    the f32 kernel's count.  ``tiles`` as in :func:`cross_spin_matvec`, at
    :func:`plan`'s 8-byte rows.
    """
    if c.device.type == "cpu":
        return cross_spin_plain(c, ops)
    out = _launch("f64", c, ops, tiles)
    cross_spin_matvec_f64.launches += 1
    return out


cross_spin_matvec_f64.launches = 0
