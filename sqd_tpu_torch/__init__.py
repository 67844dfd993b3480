# (C) 2026. Licensed under the Apache License, Version 2.0.
"""sqd_tpu_torch — the PyTorch and CUDA port of ``sqd_tpu`` for NVIDIA Hopper.

The JAX package ``sqd_tpu`` stays the reference; this package holds the
ported slices, module for module under the same names:

* :mod:`sqd_tpu_torch.fermion` — the SQD loop
  ``diagonalize_fermionic_hamiltonian``, ``solve_sci``, ``solve_sci_batch``
  and ``solve_fermion``.
* :mod:`sqd_tpu_torch.configuration_recovery` — the repair of sampled rows,
  as torch ops on the device.
* :mod:`sqd_tpu_torch.subsampling` / :mod:`sqd_tpu_torch.ops.sampling` —
  postselection, host ``subsample`` and device Gumbel-top-k sampling.
* :mod:`sqd_tpu_torch.qubit` — the qubit path: Pauli projection
  (``matrix_elements_from_pauli``, ``project_operator_to_subspace``),
  ``solve_qubit`` (host ``eigsh``) and the matrix-free ``solve_qubit_device``
  (k = 1 or k > 1, complex operators in complex128) over
  :mod:`sqd_tpu_torch.ops.pauli_proj`'s grouped operator;
  :mod:`sqd_tpu_torch.models.heisenberg` — Heisenberg and Ising models.
* :mod:`sqd_tpu_torch.counts` / :mod:`sqd_tpu_torch.primitives` — sample
  ingestion (``BitArray``) and Pauli sums (``Pauli``, ``SparsePauliOp``).
* :mod:`sqd_tpu_torch.ops.hamiltonian` — the projected operator and its
  matvec; :mod:`sqd_tpu_torch.ops.table_cache` reuses its per-string table
  rows across the loop's solves.
* :mod:`sqd_tpu_torch.ops.cross_spin` — the opposite-spin channel: a CUDA
  kernel for tensors on the card, its plain PyTorch version for the CPU.
* :mod:`sqd_tpu_torch.ops.davidson` — the Davidson solvers (lowest pair and
  block of k), real symmetric or complex Hermitian.
* :mod:`sqd_tpu_torch.ops.bitpack` — packed bitstrings, on the host (NumPy)
  and on the device (``torch_*``, int64 word tensors).
* :mod:`sqd_tpu_torch.ops.rdm` / :mod:`sqd_tpu_torch.ops.linktab` — RDMs.
* :mod:`sqd_tpu_torch.native` — the C++ host table kernels
  (``csrc/sqdcore.cpp``, copied from ``sqd_tpu``), bound with ctypes.
* :mod:`sqd_tpu_torch.convert` — an ``sqd_tpu`` operator's fields (fermionic
  or Pauli) as the port's operator.

The CPU tests (``python -m pytest tests/test_torch_*.py``) hold each module
against ``sqd_tpu``; ``python3 chip_smoke.py`` checks the port on the card,
its phase 9 the qubit path (``tools/make_qubit_data.py`` writes its
``sqd_tpu`` record).

Nothing here imports JAX or ``sqd_tpu``.  Every public entry point runs on
the card (``device="cuda"``) unless the caller passes another device.
"""

__version__ = "0.1.0"
