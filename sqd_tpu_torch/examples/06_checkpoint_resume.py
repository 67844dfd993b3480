# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Checkpoint / resume the SQD loop.

The port of ``examples/06_checkpoint_resume.py``.  The full loop state
(iteration, NumPy generator state, occupancies, carryover strings, best
result) persists to one .npz after every iteration; a preempted run resumes
bit-for-bit, because every random number of the loop comes from its one
NumPy generator.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/06_checkpoint_resume.py

or on the CPU as ``main(device="cpu")``.  The checkpoint goes to a temporary
directory, removed at the end.
"""

import os
import sys
import tempfile

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import BitArray, diagonalize_fermionic_hamiltonian
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.utils.device import checked_device


def make_bit_array(norb, rng):
    rows = []
    for _ in range(3000):
        row = np.zeros(2 * norb, dtype=bool)
        row[rng.choice(norb, 3, replace=False)] = True
        row[norb + rng.choice(norb, 3, replace=False)] = True
        rows.append(row)
    return BitArray.from_bool_array(np.array(rows))


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)
    bit_array = make_bit_array(norb, np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as tmp:  # removed with the checkpoint at the end
        ckpt = os.path.join(tmp, "sqd_loop.npz")
        common = dict(
            samples_per_batch=40, norb=norb, nelec=nelec, num_batches=2, seed=5,
            energy_tol=1e-12, occupancies_tol=1e-12, checkpoint_path=ckpt, device=device,
        )

        print("running 2 of 5 iterations, then 'crashing'...")
        r_partial = diagonalize_fermionic_hamiltonian(h1, eri, bit_array, max_iterations=2,
                                                      **common)
        print(f"  checkpointed at E = {r_partial.energy:.8f}  ({ckpt})")

        print("resuming to 5 total iterations...")
        r_resumed = diagonalize_fermionic_hamiltonian(h1, eri, bit_array, max_iterations=5,
                                                      **common)
        print(f"  resumed final E = {r_resumed.energy:.8f}")

        r_straight = diagonalize_fermionic_hamiltonian(
            h1, eri, bit_array, max_iterations=5,
            **{k: v for k, v in common.items() if k != "checkpoint_path"},
        )
        print(f"  uninterrupted E = {r_straight.energy:.8f}")
        assert r_resumed.energy == r_straight.energy, "resume must be bit-for-bit"
        print("resume is bit-for-bit identical to the uninterrupted run.")


if __name__ == "__main__":
    main()
