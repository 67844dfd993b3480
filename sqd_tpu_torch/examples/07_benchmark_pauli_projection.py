# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Pauli-projection scaling benchmark.

The port of ``examples/07_benchmark_pauli_projection.py`` (the reference's
benchmark notebook docs/guides/benchmark_pauli_projection.ipynb): project one
Z^(x)n term onto subspaces of growing dimension d and report wall-clock,
each line with the device it ran on (a card's name and power limit, as
``nvidia-smi`` gives them).  The reference measures ~4.2 s at n = 40,
d = 5e7 on a CPU host (63-qubit hard limit); the packed-word tables below
have no qubit ceiling.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/07_benchmark_pauli_projection.py

or on the CPU as ``main(device="cpu")`` (``run(40, [20_000], device="cpu")``
at a small size).
"""

import os
import sys
import time

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import qubit
from sqd_tpu_torch.ops import bitpack
from sqd_tpu_torch.primitives import Pauli
from sqd_tpu_torch.utils.device import checked_device, device_label


def run(num_qubits: int, dims, device="cuda"):
    device = checked_device(device)
    label = device_label(device)
    rng = np.random.default_rng(0)
    pauli = Pauli.from_label("Z" * num_qubits)
    for d in dims:
        bits = rng.integers(0, 2, size=(d, num_qubits)).astype(bool)
        packed = bitpack.unique_packed(bitpack.pack_bool_matrix(bits))
        mat = bitpack.unpack_to_bool_matrix(packed, num_qubits)
        # warm-up (first calls: native library, CUDA context)
        qubit.matrix_elements_from_pauli(mat[: min(len(mat), 1024)], pauli, device=device)
        t0 = time.perf_counter()
        amps, rows, cols = qubit.matrix_elements_from_pauli(mat, pauli, device=device)
        dt = time.perf_counter() - t0
        print(
            f"n={num_qubits:3d}  d={len(mat):>10,}  projection: {dt*1e3:9.2f} ms  "
            f"nnz={len(amps):,}  on {label}"
        )


def main(device="cuda"):
    print("40 qubits (reference: ~4.2 s at d = 5e7 on CPU):")
    run(40, [50_000, 500_000, 5_000_000], device=device)
    print("\n60 qubits:")
    run(60, [500_000], device=device)
    print("\n70 qubits (beyond the reference's 63-qubit limit):")
    run(70, [500_000], device=device)


if __name__ == "__main__":
    main()
