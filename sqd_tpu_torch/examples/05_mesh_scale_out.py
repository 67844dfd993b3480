# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Scale SQD batches over the ranks of a process group (the reference's
Dice-solver scenario).

The port of ``examples/05_mesh_scale_out.py``.  It mirrors
docs/guides/integrate_dice_solver.ipynb: the reference swaps in an MPI-based
C++ solver through the ``sci_solver`` seam to parallelize the
embarrassingly-parallel batch diagonalizations.  Here the same seam takes
:func:`sqd_tpu_torch.parallel.solve_sci_batch_sharded`: the batches are
dealt over the ranks of the ``torch.distributed`` process group (one rank
per card, NCCL; gloo on the CPU), each rank solves its share, and every rank
gets every result.  ``num_batches`` defaults to one batch per rank; without
a process group (no ``SQD_TPU_*`` variables) the process is one rank.  Run
on the card from a checkout::

    python3 sqd_tpu_torch/examples/05_mesh_scale_out.py

or on the CPU as ``main(device="cpu")``; on several cards, start one process
per card with ``SQD_TPU_COORDINATOR``, ``SQD_TPU_NUM_PROCESSES`` and
``SQD_TPU_PROCESS_ID`` set (see ``15_multiprocess_cluster.py``).
"""

import functools
import os
import sys

import numpy as np
import torch.distributed as dist

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import BitArray, diagonalize_fermionic_hamiltonian
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.ops import dense_fci
from sqd_tpu_torch.parallel import init_distributed, solve_sci_batch_sharded
from sqd_tpu_torch.utils.device import checked_device, device_label


def main(num_batches=None, device="cuda"):
    device = checked_device(device)
    init_distributed()  # joins the ranks' group when SQD_TPU_* is set; else a no-op
    world = dist.get_world_size() if dist.is_initialized() else 1
    num_batches = world if num_batches is None else num_batches  # one batch per rank
    print(f"devices: {world} rank(s), this one on {device} ({device_label(device)})")
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)

    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    evals, evecs = np.linalg.eigh(h_dense)
    probs = np.abs(evecs[:, 0]) ** 2
    probs /= probs.sum()

    rng = np.random.default_rng(0)
    n = len(strs)
    draws = rng.choice(n * n, size=5000, p=probs)
    rows = []
    for d in draws:
        sa, sb = int(strs[d // n]), int(strs[d % n])
        row = np.zeros(2 * norb, dtype=bool)
        for p in range(norb):
            if (sb >> p) & 1:
                row[norb - 1 - p] = True
            if (sa >> p) & 1:
                row[2 * norb - 1 - p] = True
        rows.append(row)
    bit_array = BitArray.from_bool_array(np.array(rows))

    result = diagonalize_fermionic_hamiltonian(
        h1,
        eri,
        bit_array,
        samples_per_batch=40,
        norb=norb,
        nelec=nelec,
        num_batches=num_batches,
        max_iterations=4,
        seed=7,
        sci_solver=functools.partial(solve_sci_batch_sharded, device=device),  # <- the seam
        device=device,
    )
    print(f"SQD energy (mesh-sharded batches): {result.energy:.8f}")
    print(f"exact:                             {evals[0]:.8f}")


if __name__ == "__main__":
    main()
