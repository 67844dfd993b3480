# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Full-f32 matmuls for the Krylov path (no TF32), and the real/complex
dtype pairs of the Hermitian solvers.

The CUDA form of ``sqd_tpu``'s ``jax.default_matmul_precision("highest")``:
TF32 keeps about three decimal digits, which breaks f32 Gram-Schmidt and the
Rayleigh-Ritz Gram matrix the way bf16 passes do on a TPU.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Run the body with TF32 off for CUDA matmuls; restore the flags after."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_precision)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_REAL_OF = {c: r for r, c in _COMPLEX_OF.items()}


def real_dtype(dt: torch.dtype) -> torch.dtype:
    """The real dtype of a complex one (a real dtype is its own)."""
    return _REAL_OF.get(dt, dt)


def complex_dtype(dt: torch.dtype) -> torch.dtype:
    """The complex dtype of a real one (a complex dtype is its own)."""
    return _COMPLEX_OF.get(dt, dt)
