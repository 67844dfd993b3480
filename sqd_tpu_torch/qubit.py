# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Qubit-path SQD: Pauli-operator projection and subspace eigensolve (port of
``sqd_tpu.qubit``).

The public surface of ``sqd_tpu.qubit`` (itself the reference's
``qiskit_addon_sqd/qubit.py``): :func:`solve_qubit`,
:func:`project_operator_to_subspace`, :func:`matrix_elements_from_pauli` and
:func:`sort_and_remove_duplicates`, with no 63-qubit ceiling (packed uint32
words), plus the matrix-free :func:`solve_qubit_device`, which diagonalizes
the grouped projected operator of :mod:`sqd_tpu_torch.ops.pauli_proj` with
the Davidson solvers on the card.  ``solve_qubit`` keeps the reference's
contract: an explicit sparse matrix and ``scipy.sparse.linalg.eigsh`` with
its keyword arguments passed through.

Complex operators are solved in complex128 directly: none of ``sqd_tpu``'s
TPU workarounds (the real embedding and its recovery for ``k > 1``, the
segmented Davidson, the HBM budget for the f64 stage) is ported.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix, spmatrix
from scipy.sparse.linalg import eigsh

from . import native
from .ops import bitpack
from .ops.davidson import (
    davidson_ground_state,
    davidson_initial_block,
    davidson_initial_guess,
    davidson_initial_guess_k,
    davidson_lowest_k,
)
from .ops.pauli_proj import (
    _PAIR_MIN_D,
    build_projected_operator,
    connected_table,
    connected_table_pair,
    pauli_apply_flat,
    pauli_masks_to_packed,
)
from .ops.precision import complex_dtype, real_dtype
from .utils.device import checked_device

__all__ = [
    "solve_qubit",
    "solve_qubit_device",
    "project_operator_to_subspace",
    "build_projected_operator",
    "sort_and_remove_duplicates",
    "matrix_elements_from_pauli",
]

# subspaces up to this size (and at most 2 words wide) resolve a term's
# membership on the host by radix sort and merge; larger ones on the device
HOST_MEMBERSHIP_MAX_D = 2_000_000


def sort_and_remove_duplicates(bitstring_matrix: np.ndarray) -> np.ndarray:
    """Sort rows ascending by unsigned-integer value and drop duplicates."""
    packed = bitpack.pack_bool_matrix(bitstring_matrix)
    uniq = bitpack.unique_packed(packed)
    return bitpack.unpack_to_bool_matrix(uniq, bitstring_matrix.shape[1])


def matrix_elements_from_pauli(
    bitstring_matrix: np.ndarray, pauli, *, device="cuda"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse matrix elements of one Pauli term in the subspace.

    For the (sorted, unique) rows of ``bitstring_matrix`` returns
    ``(amplitudes, rows, cols)`` such that ``A[rows[k], cols[k]] =
    amplitudes[k]``.  The input may also be the packed-word form, a
    ``(d, W)`` uint32 array of sorted unique rows, which skips the
    ``d x nq`` bool matrix (2 GB at d = 5e7 and 40 qubits; packed, 400 MB).

    A diagonal term streams the subspace once on the host (C++).  Otherwise
    membership resolves on the host (C++ radix sort and merge) up to
    ``HOST_MEMBERSHIP_MAX_D`` rows of at most 2 words, and on ``device`` past
    either limit (binary search, or involution pairing from
    ``_PAIR_MIN_D`` rows).  For a table that stays on the device use
    :func:`sqd_tpu_torch.ops.pauli_proj.pauli_term_table`.

    Args:
        bitstring_matrix: 2D bool array, rows sorted ascending by unsigned
            integer value and unique (see :func:`sort_and_remove_duplicates`),
            OR the equivalent packed uint32 word matrix.
        pauli: a :class:`sqd_tpu_torch.primitives.Pauli` (or any object with
            boolean ``z``/``x`` arrays in qubit order).
        device: where large subspaces resolve membership.
    """
    device = checked_device(device)
    is_packed = bitstring_matrix.dtype == np.uint32
    if is_packed:
        packed_h = np.asarray(bitstring_matrix)
        w = packed_h.shape[1]
    else:
        packed_h = None  # packing a d x nq bool matrix costs a multi-GB pass
        w = bitpack.num_words(bitstring_matrix.shape[1])
    z, x = np.asarray(pauli.z), np.asarray(pauli.x)
    zw, xw = pauli_masks_to_packed(z, x)
    d = len(bitstring_matrix)
    phase = 1j ** int(np.sum(z & x))

    if not np.asarray(xw[:w]).any():
        # a DIAGONAL term: every string connects to itself, no membership
        if is_packed:
            return native.pauli_diag_elements(packed_h, zw, phase)
        # bool column c is global bit nq-1-c: the per-column z mask is the
        # qubit-order mask reversed
        zsel = np.asarray(pauli.z, dtype=bool)[::-1].astype(np.uint8)
        return native.pauli_diag_elements(bitstring_matrix, zsel, phase)
    if packed_h is None:
        packed_h = bitpack.pack_bool_matrix(bitstring_matrix)

    if d <= HOST_MEMBERSHIP_MAX_D and w <= 2:
        col = native.connected_membership(packed_h, xw)
        keep = col >= 0
        sign = (1 - 2 * (native.popcount_rows(packed_h & zw[None, :w]) & 1)).astype(np.int8)
    else:
        table_fn = connected_table_pair if d >= _PAIR_MIN_D else connected_table
        col_d, sign_d = table_fn(bitpack.to_device_words(packed_h, device), zw[:w], xw[:w])
        col = col_d.cpu().numpy().astype(np.int64)
        sign = sign_d.cpu().numpy()
        keep = col < d
    rows = np.flatnonzero(keep)
    cols = col[rows]
    amplitudes = phase * sign[rows].astype(np.complex128)
    return amplitudes, rows, cols


def project_operator_to_subspace(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    verbose: bool = False,
    device="cuda",
) -> spmatrix:
    """Project a Pauli sum onto the subspace as a ``scipy.sparse.coo_matrix``
    (rows = input configuration, cols = connected configuration).

    For a matrix-free projected operator use
    :func:`sqd_tpu_torch.ops.pauli_proj.build_projected_operator` instead.
    """
    device = checked_device(device)
    d, _ = bitstring_matrix.shape
    operator = coo_matrix((d, d), dtype="complex128")
    for i, pauli in enumerate(hamiltonian.paulis):
        coefficient = complex(hamiltonian.coeffs[i])
        if verbose:  # pragma: no cover
            print(
                f"Projecting term {i + 1} out of {hamiltonian.size}: "
                f"{coefficient} * {pauli.to_label()} ..."
            )
        amplitudes, rows, cols = matrix_elements_from_pauli(bitstring_matrix, pauli, device=device)
        operator += coefficient * coo_matrix((amplitudes, (rows, cols)), (d, d))
    return operator


def solve_qubit(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    verbose: bool = False,
    device="cuda",
    **scipy_kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Eigenvalues/eigenvectors of the Hamiltonian projected into the subspace.

    The matrix is sorted and deduplicated, projected, and handed to
    ``scipy.sparse.linalg.eigsh`` on the host with ``scipy_kwargs`` passed
    through.  For a matrix-free solve on the card use
    :func:`solve_qubit_device`.
    """
    device = checked_device(device)
    bitstring_matrix = sort_and_remove_duplicates(bitstring_matrix)
    ham_proj = project_operator_to_subspace(
        bitstring_matrix, hamiltonian, verbose=verbose, device=device)
    if verbose:  # pragma: no cover
        print("Diagonalizing Hamiltonian in the subspace...")
    energies, eigenstates = eigsh(ham_proj, **scipy_kwargs)
    return energies, eigenstates


def _vector_dtype(dt: torch.dtype, op) -> torch.dtype:
    """The Davidson vectors' dtype for real precision ``dt`` on ``op``."""
    return complex_dtype(dt) if op.is_complex else dt


def solve_qubit_device(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    k: int = 1,
    tol: float = 1e-8,
    max_subspace: int = 32,
    max_iterations: int = 300,
    dtype=None,
    coarse_dtype=torch.float32,
    device="cuda",
):
    """Lowest eigenpair(s) of the projected operator, on the card.

    Mixed precision as in ``sqd_tpu``: a ``coarse_dtype`` (f32) Davidson runs
    to ``max(tol, 32 eps scale)``, then an f64 Davidson polishes, started
    from its vector, down to ``tol``.  With ``dtype`` given (or
    ``coarse_dtype=None``) a single stage runs in ``dtype``'s precision
    (f64 by default).  A complex operator runs in the complex dtype of each
    precision (complex64, complex128).

    With ``k == 1`` returns ``(energy, eigenvector, operator)``.  With
    ``k > 1`` returns ``(energies, eigenvectors, operator)``: ``energies``
    ascending, ``eigenvectors`` of shape ``(d, k)`` (the column convention of
    ``scipy.sparse.linalg.eigsh``), from the f64 block Davidson
    (:func:`sqd_tpu_torch.ops.davidson.davidson_lowest_k`).  A complex operator
    solves ``2k`` pairs from
    :func:`~sqd_tpu_torch.ops.davidson.davidson_initial_block` and returns
    the lowest ``k``, which reaches a lowest level held by a string that
    nothing connects to the rest; ``max_subspace`` is raised to hold them.

    The subspace may be given as a ``(d, W)`` uint32 packed-word matrix
    instead of a bool matrix.  The operator is built with ``weights="auto"``
    (bit-packed group weights and the group loop at large d); plan memory
    with :func:`sqd_tpu_torch.ops.pauli_proj.estimate_operator_bytes` plus
    ``2 * max_subspace`` Davidson vectors of ``d``.
    """
    device = checked_device(device)
    if np.asarray(bitstring_matrix).dtype == np.uint32:
        packed = bitpack.unique_packed(np.asarray(bitstring_matrix))
    else:
        packed = bitpack.pack_bool_matrix(sort_and_remove_duplicates(bitstring_matrix))
    op = build_projected_operator(packed, hamiltonian.paulis, hamiltonian.coeffs, device=device)
    hd = op.hdiag
    if k > 1:
        vdt = _vector_dtype(torch.float64, op)
        # sqd_tpu's real embedding of a complex operator holds every level
        # twice, and the two copies of a start one-hot cancel their spread
        if op.is_complex:
            pairs = 2 * k
            v0 = davidson_initial_block(hd, pairs, vdt)
        else:
            pairs = k
            v0 = davidson_initial_guess_k(hd, k, vdt)
        res = davidson_lowest_k(
            pauli_apply_flat, op, hd, v0,
            k=pairs, tol=tol, max_subspace=max(max_subspace, 2 * pairs + 4),
            max_iterations=max_iterations,
        )
        return res.thetas[:k].cpu().numpy(), res.vectors[:k].T.cpu().numpy(), op

    work = torch.float64 if dtype is None else real_dtype(dtype)
    if dtype is not None:
        coarse_dtype = None
    v0 = davidson_initial_guess(hd, _vector_dtype(work, op))
    if coarse_dtype is not None and coarse_dtype != work:
        scale = float(hd.abs().max()) if hd.numel() else 1.0
        eps = torch.finfo(coarse_dtype).eps
        coarse = davidson_ground_state(
            pauli_apply_flat, op, hd.to(coarse_dtype), v0.to(_vector_dtype(coarse_dtype, op)),
            tol=max(tol, 32 * eps * max(1.0, scale)),
            max_subspace=max_subspace, max_iterations=max_iterations,
        )
        v0 = coarse.vector.to(v0.dtype)
    res = davidson_ground_state(
        pauli_apply_flat, op, hd.to(work), v0,
        tol=tol, max_subspace=max_subspace, max_iterations=max_iterations,
    )
    return res.theta, res.vector.cpu().numpy(), op
