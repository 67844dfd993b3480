# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Carry an ``sqd_tpu`` operator's state across as the port's operator.

The fields arrive as numpy arrays, so nothing here imports ``sqd_tpu``::

    fields = {k: np.asarray(getattr(ham_jax, k)) for k in FIELDS}
    if ham_jax.eri_chol is not None:
        fields["eri_chol"] = np.asarray(ham_jax.eri_chol)
    ham = hamiltonian_from_numpy(fields, norb=..., nelec=...,
                                 col_block=ham_jax.col_block, device="cuda")

    fields = {k: np.asarray(getattr(op_jax, k)) for k in PAULI_FIELDS}
    op = pauli_operator_from_numpy(fields, is_complex=op_jax.is_complex,
                                   has_diag=op_jax.has_diag,
                                   packed_weights=op_jax.packed_weights,
                                   scan_matvec=op_jax.scan_matvec, device="cuda")

    fields = {k: np.asarray(getattr(dense_jax, k)) for k in DENSE_DF_FIELDS}
    dense = dense_df_operator_from_numpy(
        fields, x_chunk=dense_jax.x_chunk, aliased=dense_jax.wb is dense_jax.wa,
        device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.dense_df import DenseDFOperator
from .ops.hamiltonian import SCIHamiltonian
from .ops.pauli_proj import ProjectedPauliOperator

__all__ = [
    "DENSE_DF_FIELDS", "FIELDS", "OPTIONAL_FIELDS", "PAULI_FIELDS",
    "dense_df_operator_from_numpy", "hamiltonian_from_numpy", "pauli_operator_from_numpy",
]

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


PAULI_FIELDS = (
    "perm", "weight_re", "weight_im", "hdiag", "hdiag_im", "sign_words", "coeff_re", "coeff_im",
)


def pauli_operator_from_numpy(
    fields: dict,
    *,
    is_complex: bool,
    has_diag: bool,
    packed_weights: bool,
    scan_matvec: bool,
    device,
) -> ProjectedPauliOperator:
    """The port's :class:`ProjectedPauliOperator` from ``sqd_tpu``'s fields.

    ``sqd_tpu`` keeps a complex operator split: ``weight_re + 1j * weight_im``
    becomes the complex weights (complex64 from f32 halves) and ``coeff_re +
    1j * coeff_im`` the complex packed coefficients.  ``perm`` stays int32,
    and the uint32 sign words become int32 tensors with the same bits.
    ``PAULI_FIELDS`` are required; missing or unknown fields raise
    ``KeyError``.
    """
    if set(fields) != set(PAULI_FIELDS):
        raise KeyError(f"expected fields {sorted(PAULI_FIELDS)}, got {sorted(fields)}")
    f = {name: np.asarray(fields[name]) for name in PAULI_FIELDS}
    weight, coeff = f["weight_re"], f["coeff_re"]
    if is_complex:
        if weight.size:
            weight = weight + 1j * f["weight_im"]
        coeff = (coeff + 1j * f["coeff_im"]) if coeff.size else coeff.astype(np.complex128)
        if not weight.size:
            weight = weight.astype(np.complex128)

    def tensor(arr):
        return torch.as_tensor(np.array(arr), device=device)  # a writable copy

    return ProjectedPauliOperator(
        perm=tensor(f["perm"].astype(np.int32)),
        weight=tensor(weight),
        hdiag=tensor(f["hdiag"]),
        hdiag_im=tensor(f["hdiag_im"]),
        sign_words=tensor(f["sign_words"].astype(np.uint32).view(np.int32)),
        coeff=tensor(coeff),
        is_complex=bool(is_complex),
        has_diag=bool(has_diag),
        packed_weights=bool(packed_weights),
        scan_matvec=bool(scan_matvec),
    )


DENSE_DF_FIELDS = ("wa", "wb", "haa", "hbb", "hdiag")


def dense_df_operator_from_numpy(
    fields: dict, *, x_chunk: int, aliased: bool = False, device
) -> DenseDFOperator:
    """The port's :class:`DenseDFOperator` from ``sqd_tpu``'s fields.

    With ``aliased`` (``sqd_tpu``'s ``wb is wa``, the identical-set case) the
    beta factors are the alpha tensors themselves, as :func:`densify` builds
    them.  ``DENSE_DF_FIELDS`` are required; missing or unknown fields raise
    ``KeyError``.
    """
    if set(fields) != set(DENSE_DF_FIELDS):
        raise KeyError(f"expected fields {sorted(DENSE_DF_FIELDS)}, got {sorted(fields)}")
    skip = ("wb", "hbb") if aliased else ()
    t = {
        name: torch.as_tensor(np.array(fields[name]), device=device)  # a writable copy
        for name in DENSE_DF_FIELDS if name not in skip
    }
    if aliased:
        t["wb"], t["hbb"] = t["wa"], t["haa"]
    return DenseDFOperator(**t, x_chunk=int(x_chunk))
