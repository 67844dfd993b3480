# (C) 2026. Licensed under the Apache License, Version 2.0.
"""sqd_tpu_torch — the PyTorch and CUDA port of ``sqd_tpu`` for NVIDIA Hopper.

The JAX package ``sqd_tpu`` stays the reference; this package holds the
ported slices, module for module under the same names:

* :mod:`sqd_tpu_torch.fermion` — the SQD loop
  ``diagonalize_fermionic_hamiltonian`` (resumable from a checkpoint file),
  ``solve_sci``, ``solve_sci_batch``, ``solve_fermion``, the k lowest states
  ``solve_sci_excited``, orbital optimization (``rotate_integrals``,
  ``optimize_orbitals``: SGD steps replayed as a CUDA graph on the card),
  excitation augmentation (``apply_excitations``,
  ``enlarge_batch_from_transitions``) and ``SCIState.save``/``load``.
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
* :mod:`sqd_tpu_torch.models.hubbard` / :mod:`sqd_tpu_torch.models.fcidump`
  — Hubbard integrals; FCIDUMP files read and written.
* :mod:`sqd_tpu_torch.utils.checkpoint` — the loop's checkpoint files;
  :mod:`sqd_tpu_torch.utils.tracing` — ``IterationLogger``,
  ``profile_trace`` (``torch.profiler``, a Chrome trace) and ``span``, the
  program's ``sqd.*`` profiler ranges.
* :mod:`sqd_tpu_torch.counts` / :mod:`sqd_tpu_torch.primitives` — sample
  ingestion (``BitArray``) and Pauli sums (``Pauli``, ``SparsePauliOp``).
* :mod:`sqd_tpu_torch.ops.hamiltonian` — the projected operator and its
  matvec; :mod:`sqd_tpu_torch.ops.table_cache` reuses its per-string table
  rows across the loop's solves.
* :mod:`sqd_tpu_torch.ops.cross_spin` — the opposite-spin channel: a CUDA
  kernel for tensors on the card, its plain PyTorch version for the CPU.
* :mod:`sqd_tpu_torch.ops.dense_df` — the dense density-fitted operator
  behind ``solve_sci(matvec_strategy="dense_df")``: batched matrix products
  in place of the gathers.
* :mod:`sqd_tpu_torch.ops.davidson` — the Davidson solvers (lowest pair and
  block of k), real symmetric or complex Hermitian.
* :mod:`sqd_tpu_torch.ops.bitpack` — packed bitstrings, on the host (NumPy)
  and on the device (``torch_*``, int64 word tensors).
* :mod:`sqd_tpu_torch.ops.rdm` / :mod:`sqd_tpu_torch.ops.linktab` — RDMs.
* :mod:`sqd_tpu_torch.native` — the C++ host table kernels
  (``csrc/sqdcore.cpp``, copied from ``sqd_tpu``), bound with ctypes.
* :mod:`sqd_tpu_torch.convert` — an ``sqd_tpu`` operator's fields (fermionic
  or Pauli) as the port's operator.
* :mod:`sqd_tpu_torch.parallel` — the sharded solvers on ``torch.distributed``
  (one process per rank): batches dealt over the ranks, and one solve with
  the pair axis, the alpha rows, the amplitude grid or the density-fitting
  factor sharded; :mod:`sqd_tpu_torch.parallel.dryrun` runs them on several
  ranks.

The CPU tests (``python -m pytest tests/test_torch_*.py``) hold each module
against ``sqd_tpu``; ``python3 chip_smoke.py`` checks the port on the card,
its phase 9 the qubit path (``tools/make_qubit_data.py`` writes its
``sqd_tpu`` record) and its phase 11 orbital optimization, excited states,
augmentation and a resumed loop (``tools/make_oo_data.py`` and
``tools/make_excited_data.py``).

The package re-exports the names ``sqd_tpu`` re-exports, and every name of
``sqd_tpu``'s modules computes here (none raises ``NotImplementedError``).
:mod:`sqd_tpu_torch.ops.dense_fci` is the exact dense oracle;
``sqd_tpu_torch/examples/`` holds the sixteen guide examples, run on the card
as ``python3 sqd_tpu_torch/examples/01_quickstart.py`` (``chip_smoke.py``'s
phase 14 runs them all).  Nothing here imports JAX or
``sqd_tpu``, and importing builds no native code and touches no device.  Every
public entry point runs on the card (``device="cuda"``) unless the caller
passes another device.
"""

__version__ = "0.1.0"

from .counts import (  # noqa: E402,F401
    bit_array_to_arrays,
    bitstring_matrix_to_integers,
    counts_to_arrays,
    generate_bit_array_uniform,
    generate_counts_bipartite_hamming,
    generate_counts_uniform,
    normalize_counts_dict,
)
from .configuration_recovery import recover_configurations  # noqa: E402,F401
from .subsampling import (  # noqa: E402,F401
    postselect_and_subsample,
    postselect_by_hamming_right_and_left,
    subsample,
)
from .fermion import (  # noqa: E402,F401
    SCIResult,
    SCIState,
    bitstring_matrix_to_ci_strs,
    diagonalize_fermionic_hamiltonian,
    enlarge_batch_from_transitions,
    optimize_orbitals,
    rotate_integrals,
    solve_fermion,
    solve_sci,
    solve_sci_batch,
)
from .primitives import BitArray, Pauli, SparsePauliOp  # noqa: E402,F401
from . import qubit  # noqa: E402,F401
