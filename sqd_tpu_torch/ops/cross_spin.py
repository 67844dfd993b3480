# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The cross-spin SCI matvec channel: a CUDA kernel and its plain PyTorch version.

``sigma = sum_rs E^b_rs [ sum_pq eri[rs, pq] E^a_pq c ]`` in f32 — the
opposite-spin channel that holds almost all the FLOPs of the f32 Davidson
matvec.  It replaces the Pallas TPU kernel
``sqd_tpu/ops/pallas_matvec.py::cross_spin_matvec``; the CUDA source is
``sqd_tpu_torch/csrc/cross_spin_matvec.cu``, whose header says what bounds it
on Hopper and how its design answers that.

* :func:`cross_spin_matvec` — the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor goes to the kernel, which is built with ``nvcc`` for
  ``sm_90a`` at first use.  A failed build or launch raises: there is no
  fallback.
* :func:`cross_spin_plain` — the plain PyTorch version: ``gather_alpha``,
  then ``eri @ d``, then ``scatter_beta``, as in the full matvec.
* :func:`prepare` — the operands in the forms both want, built once per
  operator: the valid alpha pairs compacted per row (the TPU kernel re-derived
  them inside every call and relied on XLA to hoist them), int32 beta tables.

The spin-penalty mixed term rides through ``eri`` exactly as in
``sqd_tpu``: the caller folds ``-shift`` into ``eri[qp, pq]`` and adds the
elementwise ``shift * (const - target) * c`` itself.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from dataclasses import dataclass

import torch

from ..build import load_library
from .precision import highest_precision

__all__ = ["CrossSpinOperands", "cross_spin_matvec", "cross_spin_plain", "prepare"]

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "cross_spin_matvec.cu"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


@dataclass(frozen=True)
class CrossSpinOperands:
    """One operator's cross-spin tables, on one device.

    Plain-version fields: ``src_a``/``src_b`` int64 ``(npair, M|N)``,
    ``sign_a``/``sign_b`` f32, ``eri`` f32 ``(npair, npair)``.  Kernel fields:
    ``ka_n (M,)`` valid-pair counts and ``ka_pq``/``ka_src``/``ka_sgn`` ``(M, ka)``
    per-row compacted pair index, source row and sign (zero past ``ka_n``);
    ``src_b32`` int32 and ``sign_b8`` int8 beta tables.
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
    src_b32: torch.Tensor
    sign_b8: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return self.src_a.shape[1], self.src_b.shape[1]


def prepare(src_a, sign_a, src_b, sign_b, eri) -> CrossSpinOperands:
    """Build the operands from clamped gather tables and the ``(npair, npair)``
    coefficient matrix (penalty already folded in), on their device."""
    valid = sign_a != 0  # (npair, M)
    counts = valid.sum(dim=0)
    ka = max(int(counts.max()) if counts.numel() else 0, 1)
    # stable: valid pairs first, in ascending pq order
    order = torch.argsort((~valid).to(torch.uint8), dim=0, stable=True)[:ka]  # (ka, M)
    ok = torch.gather(valid, 0, order)
    ka_pq = torch.where(ok, order, 0)
    ka_src = torch.where(ok, torch.gather(src_a, 0, order), 0)
    ka_sgn = torch.where(ok, torch.gather(sign_a, 0, order).to(torch.float32), 0.0)
    return CrossSpinOperands(
        src_a=src_a.to(torch.int64),
        sign_a=sign_a.to(torch.float32),
        src_b=src_b.to(torch.int64),
        sign_b=sign_b.to(torch.float32),
        eri=eri.to(torch.float32).contiguous(),
        ka_n=counts.to(torch.int32).contiguous(),
        ka_pq=ka_pq.T.to(torch.int32).contiguous(),
        ka_src=ka_src.T.to(torch.int32).contiguous(),
        ka_sgn=ka_sgn.T.contiguous(),
        src_b32=src_b.to(torch.int32).contiguous(),
        sign_b8=sign_b.to(torch.int8).contiguous(),
    )


def cross_spin_plain(c: torch.Tensor, ops: CrossSpinOperands) -> torch.Tensor:
    """The plain PyTorch version, in f32: gather, one matmul, gather back."""
    npair = ops.eri.shape[0]
    m, n = c.shape
    c = c.to(torch.float32)
    with highest_precision():
        d = ops.sign_a[:, :, None] * c[ops.src_a]  # (npair, M, N)
        g = (ops.eri @ d.reshape(npair, m * n)).reshape(npair, m, n)
    picked = torch.gather(g, 2, ops.src_b[:, None, :].expand(npair, m, n))
    return (ops.sign_b[:, None, :] * picked).sum(dim=0)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    # nvcc from the PATH, else from the toolkit's default prefix
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = load_library("cross_spin_matvec", SOURCE, [nvcc, *NVCC_FLAGS])
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cross_spin_matvec_f32.argtypes = [
        vp, i32, i32, vp, vp, vp, vp, i32, vp, vp, vp, i32, vp, vp,
    ]
    lib.cross_spin_matvec_f32.restype = ctypes.c_int
    return lib


def cross_spin_matvec(c: torch.Tensor, ops: CrossSpinOperands) -> torch.Tensor:
    """``sigma (M, N) f32`` of the cross-spin channel for amplitudes ``c (M, N)``.

    CPU tensors take :func:`cross_spin_plain`; CUDA tensors the hand-written
    kernel (counted in ``cross_spin_matvec.launches``).
    """
    if c.device.type == "cpu":
        return cross_spin_plain(c, ops)
    if c.device.type != "cuda":
        raise ValueError(f"cross_spin_matvec takes CPU or CUDA tensors, got {c.device}")
    if c.dtype != torch.float32:
        raise TypeError(f"the cross-spin kernel computes in f32, got {c.dtype}")
    if tuple(c.shape) != ops.shape:
        raise ValueError(f"amplitudes of shape {tuple(c.shape)} for operator {ops.shape}")
    if not c.is_contiguous():
        raise ValueError("the cross-spin kernel needs C-contiguous amplitudes")
    kernel_args = (ops.ka_n, ops.ka_pq, ops.ka_src, ops.ka_sgn, ops.src_b32, ops.sign_b8, ops.eri)
    for t in kernel_args:
        if t.device != c.device or not t.is_contiguous():
            raise ValueError("cross-spin operands must be contiguous on the amplitudes' device")
    lib = _kernel_library()
    m, n = c.shape
    out = torch.empty_like(c)
    with torch.cuda.device(c.device):
        rc = lib.cross_spin_matvec_f32(
            c.data_ptr(), m, n,
            ops.ka_n.data_ptr(), ops.ka_pq.data_ptr(), ops.ka_src.data_ptr(),
            ops.ka_sgn.data_ptr(), ops.ka_pq.shape[1],
            ops.src_b32.data_ptr(), ops.sign_b8.data_ptr(), ops.eri.data_ptr(),
            ops.eri.shape[0], out.data_ptr(), torch.cuda.current_stream(c.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross_spin_matvec kernel launch failed: CUDA error {rc}")
    cross_spin_matvec.launches += 1
    return out


cross_spin_matvec.launches = 0
