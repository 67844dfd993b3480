# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The sample container of ``sqd_tpu.primitives``: :class:`BitArray`.

A copy, not an import (``sqd_tpu``'s package import pulls in JAX).  Same
layout as ``qiskit.primitives.BitArray`` (packed uint8 rows, bits
right-aligned), so a Qiskit ``BitArray`` or ``sqd_tpu``'s can be passed
wherever this one is accepted (duck-typed on ``array``/``num_bits``/
``num_shots``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["BitArray"]


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
