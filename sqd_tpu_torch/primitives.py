# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The containers of ``sqd_tpu.primitives``: :class:`BitArray`, :class:`Pauli`
and :class:`SparsePauliOp`.

A copy, not an import (``sqd_tpu``'s package import pulls in JAX).  Same
layout as ``qiskit.primitives.BitArray`` (packed uint8 rows, bits
right-aligned), so a Qiskit ``BitArray`` or ``sqd_tpu``'s can be passed
wherever this one is accepted (duck-typed on ``array``/``num_bits``/
``num_shots``); likewise a Qiskit or ``sqd_tpu`` ``Pauli`` (boolean ``z``/``x``
in qubit order) wherever a :class:`Pauli` is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["BitArray", "Pauli", "SparsePauliOp"]


@dataclass(frozen=True)
class BitArray:
    """Packed boolean samples: one row of uint8 per shot, bits right-aligned.

    ``array`` has shape ``(num_shots, ceil(num_bits/8))`` (big-endian bytes).
    """

    array: np.ndarray
    num_bits: int

    def __post_init__(self):
        arr = np.asarray(self.array, dtype=np.uint8)
        if arr.ndim != 2:
            raise ValueError(f"BitArray.array must be 2D. Got shape {arr.shape}.")
        object.__setattr__(self, "array", arr)

    @property
    def num_shots(self) -> int:
        return self.array.shape[0]

    @classmethod
    def from_bool_array(cls, bool_array: np.ndarray) -> "BitArray":
        """Build from a ``(num_shots, num_bits)`` bool array (column 0 = MSB)."""
        bool_array = np.asarray(bool_array, dtype=bool)
        num_shots, num_bits = bool_array.shape
        nbytes = -(-num_bits // 8)
        padded = np.zeros((num_shots, nbytes * 8), dtype=bool)
        padded[:, nbytes * 8 - num_bits :] = bool_array
        return cls(np.packbits(padded, axis=1), num_bits)

    @classmethod
    def from_counts(cls, counts: dict) -> "BitArray":
        """Expand a counts dict into individual shots."""
        rows = []
        for bs, count in counts.items():
            row = np.array([b == "1" for b in bs], dtype=bool)
            rows.extend([row] * int(count))
        return cls.from_bool_array(np.array(rows))

    def to_bool_array(self) -> np.ndarray:
        return np.unpackbits(self.array, axis=-1)[..., -self.num_bits :].astype(bool)


@dataclass(frozen=True)
class Pauli:
    """A single Pauli string over n qubits as (z, x) boolean masks.

    Index convention matches Qiskit: ``z[i]``/``x[i]`` refer to qubit ``i``
    (i.e. the *rightmost* character of the label is qubit 0).  Phase-free:
    a label character maps to (z, x) as I=(0,0), X=(0,1), Z=(1,0), Y=(1,1),
    and a Y contributes the standard factor ``-i`` handled by the projection
    kernels (cf. reference ``qubit.py:213-216``).
    """

    z: np.ndarray
    x: np.ndarray

    def __post_init__(self):
        z = np.asarray(self.z, dtype=bool)
        x = np.asarray(self.x, dtype=bool)
        if z.shape != x.shape or z.ndim != 1:
            raise ValueError("Pauli z and x masks must be equal-length 1D arrays.")
        object.__setattr__(self, "z", z)
        object.__setattr__(self, "x", x)

    @classmethod
    def from_label(cls, label: str) -> "Pauli":
        label = label.upper()
        if any(c not in "IXYZ" for c in label):
            raise ValueError(f"Invalid Pauli label: {label!r}")
        chars = label[::-1]  # qubit 0 = rightmost character
        z = np.array([c in "ZY" for c in chars], dtype=bool)
        x = np.array([c in "XY" for c in chars], dtype=bool)
        return cls(z, x)

    def to_label(self) -> str:
        out = []
        for zi, xi in zip(self.z[::-1], self.x[::-1]):
            out.append("IXZY"[int(zi) * 2 + int(xi)] if not (zi and xi) else "Y")
        return "".join(out)

    @property
    def num_qubits(self) -> int:
        return len(self.z)


class SparsePauliOp:
    """A weighted sum of Pauli strings (minimal SparsePauliOp equivalent)."""

    def __init__(self, paulis, coeffs=None):
        plist = []
        for p in paulis:
            plist.append(Pauli.from_label(p) if isinstance(p, str) else p)
        self.paulis: list[Pauli] = plist
        if coeffs is None:
            coeffs = np.ones(len(plist))
        self.coeffs = np.asarray(coeffs, dtype=complex)
        if len(self.coeffs) != len(self.paulis):
            raise ValueError("Number of coefficients must match number of Pauli terms.")

    @classmethod
    def from_list(cls, terms) -> "SparsePauliOp":
        labels, coeffs = zip(*terms) if terms else ((), ())
        return cls(list(labels), np.asarray(coeffs, dtype=complex))

    @property
    def size(self) -> int:
        return len(self.paulis)

    @property
    def num_qubits(self) -> int:
        return self.paulis[0].num_qubits if self.paulis else 0

    def to_matrix(self) -> np.ndarray:
        """Dense matrix (test oracle only — exponential in qubit count)."""
        n = self.num_qubits
        eye = np.eye(2)
        mats = {
            (False, False): eye,
            (False, True): np.array([[0, 1], [1, 0]], dtype=complex),
            (True, False): np.array([[1, 0], [0, -1]], dtype=complex),
            (True, True): np.array([[0, -1j], [1j, 0]], dtype=complex),
        }
        total = np.zeros((2**n, 2**n), dtype=complex)
        for pauli, coeff in zip(self.paulis, self.coeffs):
            m = np.array([[1.0]], dtype=complex)
            for q in range(n - 1, -1, -1):  # qubit n-1 leftmost
                m = np.kron(m, mats[(bool(pauli.z[q]), bool(pauli.x[q]))])
            total += coeff * m
        return total
