# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Loop-level checkpoint/resume for the SQD self-consistent iteration.

A copy of ``sqd_tpu.utils.checkpoint`` on the port's own
:mod:`sqd_tpu_torch.ops.bitpack`; the file layout is the same, so a
checkpoint written by either package loads in the other.

The reference only persists a final wavefunction (``SCIState.save``,
``fermion.py:77-98``) and relies on ``initial_occupancies`` /
``include_configurations`` for manual warm restarts (SURVEY.md §5).  Here the
*entire* loop state — iteration counter, NumPy RNG state, current
occupancies, carryover strings, and the best result so far — round-trips
through one ``.npz`` file, so a preempted run resumes bit-for-bit.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["LoopCheckpoint", "save_loop_state", "load_loop_state"]


@dataclass
class LoopCheckpoint:
    """Snapshot of the orchestrator state after a completed iteration."""

    iteration: int
    rng_state: dict[str, Any]
    current_occupancies: tuple[np.ndarray, np.ndarray] | None
    carryover_strings_a: np.ndarray
    carryover_strings_b: np.ndarray
    best_energy: float
    best_state_blob: dict[str, np.ndarray]
    best_occupancies: tuple[np.ndarray, np.ndarray]
    current_energy: float | None
    norb: int


def _strings_to_arrays(strs, norb: int):
    """Integer CI strings -> packed uint32 (object-safe for >= 63 orbitals)."""
    from ..ops import bitpack

    arr = np.asarray(strs, dtype=object if norb >= 63 else np.int64)
    if len(arr) == 0:
        return np.zeros((0, bitpack.num_words(norb)), dtype=np.uint32)
    return bitpack.pack_ints(arr, norb)


def _arrays_to_strings(packed, norb: int):
    from ..ops import bitpack

    if len(packed) == 0:
        return np.array([], dtype=object if norb >= 63 else np.int64)
    return bitpack.unpack_to_ints(np.asarray(packed, np.uint32), norb)


def save_loop_state(path, ckpt: LoopCheckpoint) -> None:
    """Persist a :class:`LoopCheckpoint` to ``path`` (single .npz file)."""
    meta = {
        "iteration": ckpt.iteration,
        "rng_state": ckpt.rng_state,
        "best_energy": ckpt.best_energy,
        "current_energy": ckpt.current_energy,
        "norb": ckpt.norb,
        "has_occupancies": ckpt.current_occupancies is not None,
    }
    arrays = {
        "meta_json": np.frombuffer(json.dumps(meta, default=int).encode(), dtype=np.uint8),
        "carryover_a": _strings_to_arrays(ckpt.carryover_strings_a, ckpt.norb),
        "carryover_b": _strings_to_arrays(ckpt.carryover_strings_b, ckpt.norb),
        "best_occ_a": np.asarray(ckpt.best_occupancies[0]),
        "best_occ_b": np.asarray(ckpt.best_occupancies[1]),
    }
    if ckpt.current_occupancies is not None:
        arrays["occ_a"] = np.asarray(ckpt.current_occupancies[0])
        arrays["occ_b"] = np.asarray(ckpt.current_occupancies[1])
    for key, val in ckpt.best_state_blob.items():
        arrays[f"state_{key}"] = val
    np.savez(path, **arrays)


def load_loop_state(path) -> LoopCheckpoint:
    """Load a :class:`LoopCheckpoint` saved by :func:`save_loop_state`."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"].tobytes()).decode())
        norb = int(meta["norb"])
        current_occ = None
        if meta["has_occupancies"]:
            current_occ = (data["occ_a"], data["occ_b"])
        blob = {
            key[len("state_") :]: data[key] for key in data.files if key.startswith("state_")
        }
        return LoopCheckpoint(
            iteration=int(meta["iteration"]),
            rng_state=meta["rng_state"],
            current_occupancies=current_occ,
            carryover_strings_a=_arrays_to_strings(data["carryover_a"], norb),
            carryover_strings_b=_arrays_to_strings(data["carryover_b"], norb),
            best_energy=float(meta["best_energy"]),
            best_state_blob=blob,
            best_occupancies=(data["best_occ_a"], data["best_occ_b"]),
            current_energy=(
                None if meta["current_energy"] is None else float(meta["current_energy"])
            ),
            norb=norb,
        )
