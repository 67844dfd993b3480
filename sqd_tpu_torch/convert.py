# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Carry an ``sqd_tpu`` operator's state across as the port's operator.

The fields arrive as numpy arrays, so nothing here imports ``sqd_tpu``::

    fields = {k: np.asarray(getattr(ham_jax, k)) for k in FIELDS}
    if ham_jax.eri_chol is not None:
        fields["eri_chol"] = np.asarray(ham_jax.eri_chol)
    ham = hamiltonian_from_numpy(fields, norb=..., nelec=...,
                                 col_block=ham_jax.col_block, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hamiltonian import SCIHamiltonian

__all__ = ["FIELDS", "OPTIONAL_FIELDS", "hamiltonian_from_numpy"]

FIELDS = (
    "src_a", "sign_a", "src_b", "sign_b",
    "nbr_idx_a", "nbr_val_a", "nbr_idx_b", "nbr_val_b",
    "eri_t", "hdiag",
)
OPTIONAL_FIELDS = ("eri_chol",)
_INDEX_FIELDS = ("src_a", "src_b", "nbr_idx_a", "nbr_idx_b")
_SIGN_FIELDS = ("sign_a", "sign_b")


def hamiltonian_from_numpy(
    fields: dict,
    *,
    norb: int,
    nelec: tuple[int, int],
    spin_shift: float = 0.0,
    spin_target: float = 0.0,
    col_block: int = 0,
    device,
) -> SCIHamiltonian:
    """The port's :class:`SCIHamiltonian` from ``sqd_tpu`` operator fields.

    Index tables become int64 and signs int8; the float payload keeps its
    dtype.  ``FIELDS`` are required and ``OPTIONAL_FIELDS`` may be given;
    missing or unknown fields raise ``KeyError``.
    """
    if not set(FIELDS) <= set(fields) <= set(FIELDS + OPTIONAL_FIELDS):
        raise KeyError(f"expected fields {sorted(FIELDS)} and optionally "
                       f"{sorted(OPTIONAL_FIELDS)}, got {sorted(fields)}")
    tensors = {}
    for name in fields:
        arr = np.asarray(fields[name])
        if name in _INDEX_FIELDS:
            arr = arr.astype(np.int64)
        elif name in _SIGN_FIELDS:
            arr = arr.astype(np.int8)
        else:
            arr = np.array(arr)  # a writable copy: arrays from JAX are read-only
        tensors[name] = torch.as_tensor(arr, device=device)
    return SCIHamiltonian(
        **tensors,
        norb=int(norb),
        nelec=tuple(int(x) for x in nelec),
        spin_shift=float(spin_shift),
        spin_target=float(spin_target),
        col_block=int(col_block),
    )
