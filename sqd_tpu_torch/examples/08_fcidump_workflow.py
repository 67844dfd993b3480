# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Molecular workflow via FCIDUMP interchange.

The port of ``examples/08_fcidump_workflow.py``.  The reference obtains
integrals from PySCF inside its guides; here any chemistry package's FCIDUMP
file drives the same workflow.  This example writes one (from a model
Hamiltonian) into a temporary directory, reads it back, and runs SQD.
Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/08_fcidump_workflow.py

or on the CPU as ``main(device="cpu")``.
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
from sqd_tpu_torch.models.fcidump import read_fcidump, write_fcidump
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)
    with tempfile.TemporaryDirectory() as tmp:  # removed with the file after reading
        path = os.path.join(tmp, "hubbard.fcidump")
        write_fcidump(path, h1, eri, nelec=nelec, ecore=-1.5)
        print(f"wrote {path}")
        mol = read_fcidump(path)
    print(f"read back: norb={mol['norb']} nelec={mol['nelec']} ecore={mol['ecore']}")

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(4000):
        row = np.zeros(2 * norb, dtype=bool)
        row[rng.choice(norb, nelec[1], replace=False)] = True
        row[norb + rng.choice(norb, nelec[0], replace=False)] = True
        rows.append(row)
    bit_array = BitArray.from_bool_array(np.array(rows))

    result = diagonalize_fermionic_hamiltonian(
        mol["h1e"],
        mol["eri"],
        bit_array,
        samples_per_batch=60,
        norb=mol["norb"],
        nelec=mol["nelec"],
        num_batches=2,
        max_iterations=4,
        seed=0,
        device=device,
    )
    print(f"electronic energy: {result.energy:.8f}")
    print(f"total energy (+ core): {result.energy + mol['ecore']:.8f}")


if __name__ == "__main__":
    main()
