#!/usr/bin/env python3
# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Smoke run of ``sqd_tpu_torch`` on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:

1. device — needs CUDA; prints ``nvidia-smi``'s name and power limit;
2. build — compiles the native host library (g++, ``csrc/sqdcore.cpp``),
   the cross-spin CUDA kernel (nvcc, sm_90a, ``csrc/cross_spin_matvec.cu``)
   and the table kernels (nvcc, sm_90a, ``csrc/sci_tables.cu``) from the
   sources in the checkout, all at once;
3. kernel vs plain — the kernel against its plain PyTorch version on the
   headline operator (M = N = 1024, npair = 256), a ragged small operator, a
   spin-penalty operator, a wide one (N = 4480: several shared-memory k
   tiles), a sparse one (padded far past its strings: most rows and columns
   have no valid pair), the headline with small tiles forced on both the
   k and the rs axis, and a 1000 x 1000 batch of 28-orbital strings on the
   N2/cc-pVDZ integrals (npair 784) with ``plan()``'s tiles and with rs
   tiles forced, within ``1e-5 * max(|plain|, 1)``; median times of both at
   the headline and the 28-orbital shapes from CUDA events, the kernel's
   bound there (the larger of its FLOPs at the f32 rate and its bytes at
   the HBM rate, counted from the operands), one f32 matvec's time, one
   f32 matvec at npair 784 by the kernel route and by the Cholesky-factored
   route, and both column-blocked f64 matvecs against ``_matvec_dense`` on
   the headline operator forced to ``col_block`` 128, bare and with the
   spin penalty, within ``1e-12 * max(|full|, 1)``;
3c. the f64 kernel (:func:`f64_kernel_phase`), the exact operator's
   cross-spin channel — at the headline, the cc-pVDZ batch (npair 784),
   config 5 (3168 x 3200, npair 1296) and the CASCI (4384 x 4480): against
   its plain version in f64 (small k and rs tiles forced at the first two),
   and the f64 ``matvec``, which must launch it, against the dense route the
   CPU takes (``_matvec_dense`` or ``_matvec_blocked``), within
   ``1e-12 * max(|reference|, 1)``; its time beside its bound (its FLOPs at
   the 34 TFLOP/s f64 rate or its bytes at the HBM rate) and the plain
   version's, and one f64 matvec by each route;
3b. table kernels vs the native build — ``card_tables.build_tables`` (the
   gather and both same-spin kernels, what ``"auto"`` takes on the card
   without a usable ``TableCache``) at the headline (16 orbitals, 1000 x
   1000 strings), the cc-pVDZ cell's (10e,26o) and phase 8's (14e,28o)
   shapes (1000 x 1000 strings), the CASCI (4368 strings a spin), config 5
   (3163 two-word strings, 36 orbitals) and all C(17,5) = 6188 strings over
   17 cc-pVDZ orbitals: its eight tables equal to ``native.gather_tables``'
   and ``native.samespin_tables``' with ``torch.equal``, widths included;
   ``card_tables.gather_tables`` equal to the native gather tables; per
   shape the kernels' device time per build (``torch.profiler``), the
   native build's seconds (the plain version) and the kernels' bound (their
   least bytes, inputs read and tables written once, at the HBM rate).
   From phase 5 on, ``build_tables.launches`` and ``gather_tables.launches``
   are recorded by phase: one build in phase 5's solve, none in phase 6's
   loop solves (their ``TableCache``), one in every batch solve of phase 8
   (the cache declines 4558 candidates a string), some in phase 7's CASCI;
4. Davidson — the f32 solver on the headline operator (``bench.py``'s
   settings: tol 1e-3, max_subspace 24, 200 iterations) must converge;
5. slice — ``sqd_tpu_torch.fermion.solve_sci`` on the bench headline problem
   (N2/6-31G CAS(16o,(5,5)e), 1000 x 1000 excitation strings, integrals from
   the committed FCIDUMP); the kernel must be launched during the solve, the
   f64 refinement and energy must take the f64 kernel and no column-blocked
   matvec (its launches, counted from 0 here, are the kernels line's f64
   ``launches``), and the energy must lie within 1e-7 Ha of a host-f64 Rayleigh quotient of the
   returned amplitudes and of the ``sqd_tpu`` energy recorded beside the
   FCIDUMP;
6. SQD loop — ``sqd_tpu_torch.fermion.diagonalize_fermionic_hamiltonian`` on
   the same integrals with 200,000 shots (:func:`loop_shots`) and
   ``LOOP_SETTINGS`` (3 iterations of 3 batches of ~950 x 950 strings, the
   default solver with a fresh ``TableCache``).  Iteration 0 must give the
   strings and, within 1e-7 Ha, the energies that ``sqd_tpu`` recorded
   (``tools/make_sqd_loop_data.py``); the best energy must lie within
   1e-7 Ha of a host-f64 Rayleigh quotient of its amplitudes; every batch
   solve must run in f32 (above 200k determinants) and launch the kernel,
   and its f64 refinement the f64 kernel and no blocked f64 matvec;
   the table cache must have reused rows.  Prints each iteration's seconds
   in recovery, subsampling, table builds and solves;
7. CASCI — ``solve_sci`` with its defaults on all C(16,5) = 4368 strings per
   spin of the same problem (19,079,424 determinants, padded to 4384 x 4480,
   ``col_block`` 128): first the kernel against its plain version, and
   timed, on that operator; then the solve must launch the kernel (f32
   Davidson), take the f64 kernel in the refinement and the energy and no
   column-blocked matvec (the card's f64 route has no dense intermediates to
   bound), and
   give a total energy within 2e-6 Ha of the published -109.046671778080 Ha
   (``bench.py``'s gate).  Prints the seconds of each stage and the peak
   device memory;
8. cc-pVDZ loop — BASELINE config 3: the SQD loop on N2/cc-pVDZ over all 28
   orbitals, (7,7)e (``sqd_tpu_torch/data/n2_ccpvdz_28o_7a7b.fcidump``),
   with 200,000 shots of 56 bits (:func:`ccpvdz_shots`) and
   ``CCPVDZ_SETTINGS`` (2 iterations of 2 batches of 1000 x 1000 strings)
   and an explicit Cholesky factor (``"auto"`` declines these integrals).
   Iteration 0 must give ``sqd_tpu``'s recorded strings
   (``tools/make_ccpvdz_data.py``), a solve of the recorded sub-batch its
   energy within 1e-7 Ha; the best energy must lie within 1e-7 Ha of a
   host-f64 Rayleigh quotient (alpha-row blocks) and below RHF, its
   occupancies sum to (7, 7); every batch solve must build its tables on
   the card (one ``build_tables`` launch), a column-blocked operator with the factor attached,
   launch the kernel and, for the refinement, the f64 kernel and no blocked f64 matvec;
9. qubit path — (a) ``bench.py``'s projection headline: ``pauli_term_table``
   for Z^n over d = 5e7 random unique 40- and 60-qubit strings (seeds 3 and
   4, sorted and deduplicated on the card), best of 3, its signs summing to
   the host ``np.bitwise_count`` parity count; at 40 qubits also X Z^39
   (the involution-pairing membership), its columns equal to the host
   radix merge ``native.connected_membership``; and the public
   ``matrix_elements_from_pauli`` on the packed input and on the bool
   matrix, each printed beside the reference's published CPU seconds;
   (b) ``solve_qubit_device(tol=1e-6)`` with its defaults on
   ``probes/qubit_solve_1e7.py``'s 26-site Heisenberg ring over the d = 1e7
   strings of :func:`solve_strings`: packed weights and the group loop, an
   f32 then an f64 Davidson, each in 25-iteration segments as ``sqd_tpu``'s
   (each stage's iterations and segments printed), the energy within 1e-7
   of a NumPy host-f64 Rayleigh quotient (:func:`pauli_host_energy`) and
   within 1e-6 of the
   ``sqd_tpu`` record ``sqd_tpu_torch/data/qubit_heisenberg26_1e7.json``
   (``tools/make_qubit_data.py``); one f32 and one f64 matvec timed beside
   their byte bound; (c) ``solve_qubit_device(k=3)`` on a 20-site ring with
   a Dzyaloshinskii-Moriya term (complex128) and on the real ring, over 2e5
   strings (seed 8), within 1e-7 of ``solve_qubit(k=3, which="SA")`` with
   orthonormal columns.  This path reaches no Pallas kernel in ``sqd_tpu``,
   so it has no CUDA kernel and no entry in the kernels' record;
10. dense density-fitted solve — BASELINE config 5, ``bench.py``'s (54e,36o)
   problem made from its seed (``bench_torch.config5_problem``: 36 orbitals,
   27 + 27 electrons, synthetic PSD integrals of rank 108, the same 3163
   two-word excitation strings for both spins, 10,004,569 determinants,
   padded 3168 x 3200, npair 1296).  (a) the operator: ``eri_factor="auto"``
   must attach the factor and the card must build the tables;
   the kernel against its plain version at this shape, then timed beside
   its bound; the RDMs' two-hole tables of these strings
   (:func:`two_hole_tables`: int32 sources, as ``sqd_tpu``'s) built, their
   measured bytes and seconds printed, int32 indexing equal to int64; (b)
   ``DenseDFOperator.matvec`` (f32, ``wb`` aliasing ``wa``)
   against the kernel-route f32 matvec and both against the exact f64
   matvec (the kernel route within ``1e-5 * max(|f64|, 1)``, the dense
   route, three f32 products in a row, within ``1e-4`` of it); one matvec of each route timed
   beside its bound (dense: ``4 X P^3`` FLOPs at the f32 rate, P the common
   padded width), with ``x_chunk`` 8 and the whole stack; ``densify``'s
   seconds, the W-stack bytes and the peak memory; (c) ``solve_sci`` with
   ``CONFIG5_SOLVER`` by ``matvec_strategy="gather"`` (must launch the
   kernel) and ``"dense_df"`` (must launch none; its f32 Davidson runs in
   segments, as ``sqd_tpu``'s): each energy within 1e-7 Ha
   of :func:`device_f64_energy` (the host quotient transcribed to torch f64
   on the card, from the tables alone), the two within 1e-3 Ha, both
   Davidsons converged; and both routes on the first 512 strings per spin
   within 1e-7 Ha of the NumPy :func:`host_f64_energy`, which the device
   quotient must also meet there;
11. the rest of the fermion API — (a) BASELINE config 4's path: the headline
   integrals scrambled by ``rotate_integrals`` with :func:`oo_inputs`'s
   random generator (0.1 · normal(120), seed 17), then ``optimize_orbitals``
   from k = 0 over 181 × 181 excitation strings (32,761 determinants, the
   size of the reference's orbital-optimization notebook) with ``OO`` (3
   outer iterations of the default 10 — a cut for the script's time — of
   10,000 SGD steps, rate 0.01,
   momentum 0.9) and f32 solves (the default at this size is f64, which
   never reaches the kernel): each outer iteration's energy within 1e-6 Ha
   of ``sqd_tpu``'s record (``tools/make_oo_data.py``), the final ``k_flat``
   within ``TOL_OO_K``, the last energy below the k = 0 start, the kernel
   launched in every solve; then 100 SGD steps on the last solve's RDMs by
   the CUDA graph and eagerly on the card against the port's CPU steps
   within 1e-10, each form's ms per step printed; (b) ``solve_sci_excited``
   (k = 3, f64) at the headline's 10⁶ determinants: the lowest energy within
   1e-7 Ha of phase 5's, each within 1e-7 Ha of :func:`host_f64_energy` of
   its own vector and of ``tools/make_excited_data.py``'s record, the states
   orthonormal to 1e-8 and ascending; (c) ``enlarge_batch_from_transitions``
   of phase 6's 200,000 shots by all 480 same-spin single excitations
   (:func:`single_excitation_operators`): the legal-row count equal to the
   count from occupancies, the first 2,000 shots' rows equal to the NumPy
   loop :func:`excitation_rows_loop`; (d) phase 6's loop stopped after
   iteration 0 with a ``checkpoint_path`` and resumed to 3 iterations: the
   best energy within 1e-9 Ha of phase 6's, with its strings; its state
   through ``SCIState.save``/``load`` with equal amplitudes, strings and
   1-RDM; and one headline ``solve_sci`` under ``profile_trace``, whose
   Chrome trace must hold the kernel (its device time printed beside phase
   3's CUDA-event time);
12. from geometry — (a) N2/6-31G at ``tools/make_headline_data.py``'s
   geometry through the port's own chemistry: ``chem.Molecule`` ->
   ``ao_integrals`` (the native kernel) -> ``rhf`` ->
   ``active_space_integrals(ncas=16, nelecas=10)``; the RHF energy within
   1e-8 Ha of ``sqd_tpu.chem``'s record (``tools/make_chem_data.py``) and
   ``ecore`` within 1e-8 Ha of the committed FCIDUMP's; then every one of
   the C(16,5) strings per spin on these integrals: the operator built with
   ``tables_backend="native"`` and ``"device"`` (:func:`compare_tables`: each
   warm, twice, on a synchronised host clock; gather tables equal bit for
   bit, same-spin lists equal once the device's valid zero entries are
   dropped, values within 1e-14 * max|val|, one f64 matvec within
   1e-12 * max(|sigma|, 1), one f32 matvec of each timed), and ``solve_sci``
   with its defaults, which must launch the kernel and land within 2e-6 Ha
   of the published -109.046671778080 Ha and 1e-6 Ha of phase 7's energy,
   with each stage's seconds and the peak memory; (b) the same table check at
   phase 5's headline operator and phase 10's config-5 operator (12,880
   same-spin candidates a string: the device build's row chunks and peak
   printed); (c) BASELINE config 4's named systems: triplet CH2/STO-3G ROHF
   and UHF within 1e-8 Ha of the record, [2Fe-2S]/STO-3G integral digests
   (d shells, native) within 1e-10 relative and its ROHF after 80 cycles
   within 1e-6 Ha (it does not converge; the gap is printed), then
   ``solve_sci`` on the card over its whole CAS(6o,(4,2)) sector (225
   determinants) within 1e-7 Ha of :func:`host_f64_energy` of its vector;
13. sharded solvers (``sqd_tpu_torch.parallel``) — first the kernel against
   its plain version on operands restricted to rank 0 of 2's rows at the
   CASCI (2192 output rows of a 4384-row ``c``, sources past the output
   range), timed beside its bound; (a) world size 1 over NCCL, joined by
   ``init_distributed`` from the ``SQD_TPU_*`` variables: phase 6's
   iteration-0 batches through ``solve_sci_batch_sharded`` within 1e-7 Ha of
   phase 6's energies and of the ``sqd_tpu`` record, phase 6's loop with
   ``sci_solver=solve_sci_batch_sharded`` (iteration 0 gives ``sqd_tpu``'s
   strings), the headline by the pair-, row- and grid-sharded solves
   (``HEADLINE_SHARDED``) within 1e-7 Ha of phase 5 with their seconds
   beside a warm ``solve_sci``'s (the kernel launched by the row shards
   only), the full CASCI by ``solve_sci_rowsharded`` (``CASCI_ROWSHARDED``)
   within 2e-6 Ha of the published energy and 1e-7 Ha of phase 7's, with its
   peak memory and launches, and config 5 by ``solve_sci_dfsharded``
   (``CONFIG5_SOLVER``) within 1e-6 Ha of phase 10's dense route; (c)
   ``dryrun_multichip`` on every card (NCCL) prints its line; (b) the same
   dry run on two ranks both on the one card over gloo (every mode: gloo
   serves their collectives for CUDA tensors,
   ``probes/torch_gloo_cuda_collectives.py``), each within 1e-8 Ha of (c)'s;
14. the guide examples — (a) each of the sixteen ``sqd_tpu_torch/examples``
   at its guide size on the card with the port's own recovery noise
   (:func:`examples_phase`), one line each with its seconds, the card's name
   and power limit: the lines no recovery noise touches (exact and
   dense-oracle energies, mean fields, solves on fixed strings, a loop's
   first iteration, ``13``'s route energies, ``15``'s ranks and oracle)
   equal to the ``sqd_tpu`` record ``sqd_tpu_torch/data/example_records.json``
   (``tools/make_example_records.py``) with numbers within 1e-7, each
   example's own asserts, and every printed variational energy no lower than
   the printed exact energy less 1e-8 Ha; (b) example 13's inputs
   (36 orbitals, two-word strings) by ``solve_sci``'s gather route in f32:
   the kernel launched, the energy within 1e-7 Ha of the example's f64
   energy, and the kernel against its plain version on that operator, timed
   beside its bound;
15. ``bench_torch.py``'s two qubit sections at full size, through its own
   section functions (:func:`bench_qubit_phase`): the 88-term L = 22
   Heisenberg ring over 10^6 strings (per-term tables against the grouped
   build, one grouped matvec) and over 49,718 strings (build plus one matvec
   of ones), each section's seconds printed, 23 x-groups, and each grouped
   matvec's ``<v|H|v>/<v|v>`` in f64 on the card within 1e-9 relative of
   :func:`pauli_host_energy` on the same strings and vector; then its
   config-5 section at full size (``bench.py``'s segmented dense-DF f32
   solve, tol 1e-4, max_subspace 12, 200 iterations): converged below tol
   in fewer than 200 iterations, the f64 energy within 5e-3 Ha of the Ritz
   value (``bench.py``'s gate) and within 1e-6 Ha of phase 10's gather
   route; its seconds, iterations, segments and residual printed.  Neither
   path reaches a Pallas kernel in ``sqd_tpu``: the kernel's count must stay
   0.

The last two lines are the kernels' JSON record (the cross-spin kernel, its
f64 build and the table kernels) and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
try:  # bench.py's string walk, config-5 problem and host oracle, as bench_torch.py keeps them
    from bench_torch import config5_problem, excitation_strings, host_f64_energy
except ImportError as exc:
    print(f"chip_smoke: FAIL: bench_torch.py and sqd_tpu_torch are not beside this script "
          f"({exc})", flush=True)
    raise SystemExit(1) from None
DATA_STEM = os.path.join(ROOT, "sqd_tpu_torch", "data", "n2_631g_cas16o_5a5b")
TOL_KERNEL = 1e-5  # relative to max(|plain|, 1): f32 sums in another order
TOL_F64 = 1e-12  # relative to max(|reference|, 1): f64 sums in another order
TOL_ENERGY = 1e-7  # Ha
# phase 6: the SQD loop, and the sqd_tpu record of its iteration 0
LOOP_DATA = os.path.join(ROOT, "sqd_tpu_torch", "data", "sqd_loop_n2_631g.json")
LOOP_SHOTS = 200_000
LOOP_SETTINGS = {
    "samples_per_batch": 3000, "num_batches": 3, "max_iterations": 3, "max_dim": 1000,
    "symmetrize_spin": False, "seed": 11,
}
# phase 7: the full N2/6-31G CASCI, and its published energy (bench.py's gate)
CASCI_ENERGY = -109.046671778080  # Ha
TOL_CASCI = 2e-6  # Ha
# phase 8: BASELINE config 3, the SQD loop on N2/cc-pVDZ over all 28 orbitals,
# and the sqd_tpu record of its iteration 0 (tools/make_ccpvdz_data.py)
CCPVDZ_STEM = os.path.join(ROOT, "sqd_tpu_torch", "data", "n2_ccpvdz_28o_7a7b")
CCPVDZ_SHOTS = 200_000
CCPVDZ_SETTINGS = {
    "samples_per_batch": 3000, "num_batches": 2, "max_iterations": 2, "max_dim": 1000,
    "symmetrize_spin": True, "seed": 13,
}
CCPVDZ_SUB_BATCH = 150  # strings per spin of the recorded sub-batch solve
# phase 9: the qubit path.  (a) bench.py's projection headline: one Pauli term
# over d = 5e7 random unique strings, with the reference's published CPU
# seconds for the Z^n term (BASELINE.md); (b) probes/qubit_solve_1e7.py's
# Heisenberg solve, against the sqd_tpu record of tools/make_qubit_data.py;
# (c) complex operators and k = 3 against scipy's eigsh
PROJ_D = 50_000_000
PROJ_CASES = ((40, 3, 4.17), (60, 4, 5.16))  # (qubits, seed, reference CPU seconds)
QUBIT_DATA = os.path.join(ROOT, "sqd_tpu_torch", "data", "qubit_heisenberg26_1e7.json")
QUBIT_SOLVE = {"sites": 26, "h_z": 0.1, "d": 10_000_000, "seed": 7, "tol": 1e-6}
QUBIT_K = {"sites": 20, "dm": 0.3, "d": 200_000, "seed": 8, "k": 3}
# phase 10: BASELINE config 5, bench.py's (54e,36o) problem, by both solve routes
CONFIG5 = {"norb": 36, "nelec": (27, 27), "strings": 3163}
CONFIG5_SOLVER = {"tol": 1e-4, "max_subspace": 12, "max_cycle": 200,  # bench.py's
                  "with_rdms": False, "refine_iterations": 0}
CONFIG5_SUB = 512  # strings per spin of the sub-shape held against the NumPy quotient
TOL_ROUTES = 1e-3  # Ha between the two routes' energies (both stop at tol 1e-4)
# the dense f32 matvec relative to max(|f64|, 1): three f32 products in a row,
# each entry a sum over X * P = 108 * 3200 terms
TOL_DENSE = 1e-4
# phase 11: the rest of the fermion API.  (a) orbital optimization (BASELINE
# config 4's path) on the headline integrals in a randomly rotated basis over
# 181 x 181 excitation strings (32,761 determinants, as the reference's
# orbital-optimization notebook),
# against the sqd_tpu record of tools/make_oo_data.py; (b) the three lowest
# states at the headline strings, against tools/make_excited_data.py's record
OO_DATA = os.path.join(ROOT, "sqd_tpu_torch", "data", "oo_n2_631g.json")
OO = {"strings": 181, "rotation_seed": 17, "rotation_scale": 0.1,
      "num_iters": 3, "num_steps_grad": 10_000, "learning_rate": 0.01, "momentum": 0.9}
EXCITED_DATA = os.path.join(ROOT, "sqd_tpu_torch", "data", "excited_n2_631g.json")
EXCITED_K = 3
# phase 12: from geometry.  The molecules (sqd_tpu_torch.chem), and the
# sqd_tpu.chem record of tools/make_chem_data.py
CHEM_DATA = os.path.join(ROOT, "sqd_tpu_torch", "data", "chem_records.json")
N2_ATOMS = [("N", (0.0, 0.0, 0.0)), ("N", (1.0, 0.0, 0.0))]  # tools/make_headline_data.py
# triplet CH2 (examples/16_open_shell_rohf.py): r(CH) = 1.0775 A, HCH 134 deg
_CH2_X, _CH2_Z = 1.0775 * math.sin(math.radians(67.0)), 1.0775 * math.cos(math.radians(67.0))
CH2_ATOMS = [("C", (0.0, 0.0, 0.0)), ("H", (_CH2_X, 0.0, _CH2_Z)), ("H", (-_CH2_X, 0.0, _CH2_Z))]
# the [2Fe-2S] rhombus of tests/test_chem_fe2s2.py: Fe-Fe 2.70 A, Fe-S 2.20 A
_FE_X = 2.70 / 2
_S_Y = math.sqrt(2.20**2 - _FE_X**2)
FE2S2_ATOMS = [("Fe", (_FE_X, 0.0, 0.0)), ("Fe", (-_FE_X, 0.0, 0.0)),
               ("S", (0.0, _S_Y, 0.0)), ("S", (0.0, -_S_Y, 0.0))]
FE2S2_ROHF = {"spin": 4, "max_cycle": 80}
TOL_CHEM = 1e-8  # Ha: RHF, ROHF, UHF and ecore against the record
TOL_FE2S2_ROHF = 1e-6  # Ha: an unconverged ROHF after 80 cycles
TOL_DIGEST = 1e-10  # relative, the [2Fe-2S] integral digests
# phase 13: the sharded solvers (sqd_tpu_torch.parallel).  The f32 Davidsons
# of the single-solve modes stop at tol 1e-5 or their iteration cap, near the
# f32 floor at these shapes, so the energy's error (residual^2 / gap) stays
# far below the gates
HEADLINE_SHARDED = {"tol": 1e-5, "max_cycle": 100}
CASCI_ROWSHARDED = {"tol": 1e-5, "max_cycle": 80}
TOL_DF_SHARDED = 1e-6  # Ha, the factor-sharded config 5 against phase 10's dense route
TOL_WORLDS = 1e-8  # Ha, (b)'s two ranks against (c)'s one
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_F64_FLOPS = 34e12  # f64 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes per second
# phase 15: bench_torch.py's qubit sections, held to the host quotient,
TOL_BENCH_QUBIT = 1e-9  # relative
# and its config-5 section (tol 1e-4) against phase 10's gather route (solve_sci's
# scaled tol): each f64 energy within r^2 / gap of the exact one
TOL_BENCH_CONFIG5 = 1e-6  # Ha


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def all_strings(norb, n_elec):
    """Every ``norb``-bit string with ``n_elec`` bits set, ascending."""
    import itertools

    import numpy as np

    return np.array(sorted(sum(1 << p for p in occ)
                           for occ in itertools.combinations(range(norb), n_elec)))


def _shots(strs_a, strs_b, norb, n_shots, seed):
    """``(n_shots, 2 * norb)`` bool rows ``[b_{norb-1}..b_0, a_{norb-1}..a_0]``:
    80 % (alpha, beta) pairs drawn uniformly from the two string sets, 20 %
    uniform random bits that configuration recovery has to repair."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_pairs = n_shots * 4 // 5
    pick_a = strs_a[rng.integers(0, len(strs_a), n_pairs)]
    pick_b = strs_b[rng.integers(0, len(strs_b), n_pairs)]
    shifts = np.arange(norb - 1, -1, -1)
    pairs = np.hstack([(pick_b[:, None] >> shifts) & 1, (pick_a[:, None] >> shifts) & 1])
    noise = rng.integers(0, 2, size=(n_shots - n_pairs, 2 * norb))
    return np.vstack([pairs, noise]).astype(bool)


def loop_shots(n_shots=LOOP_SHOTS, seed=5):
    """Phase 6's samples: an ``(n_shots, 32)`` bool matrix, pairs from the
    headline string sets (samples concentrated near the HF determinant)."""
    return _shots(excitation_strings(1000, 16, 5, 1), excitation_strings(1000, 16, 5, 2),
                  16, n_shots, seed)


def ccpvdz_shots(n_shots=CCPVDZ_SHOTS, seed=6):
    """Phase 8's samples: an ``(n_shots, 56)`` bool matrix, pairs from 1500
    excitation strings per spin of 28 orbitals and 7 electrons."""
    return _shots(excitation_strings(1500, 28, 7, 3), excitation_strings(1500, 28, 7, 4),
                  28, n_shots, seed)


def oo_inputs():
    """Phase 11 (a)'s inputs: the random rotation ``k_rand`` (120 values,
    ``0.1 * normal`` from seed 17) that scrambles the headline orbitals, and
    the 181 + 181 excitation strings (seeds 1 and 2, as the headline's)."""
    import numpy as np

    k_rand = OO["rotation_scale"] * np.random.default_rng(OO["rotation_seed"]).normal(size=120)
    return k_rand, (excitation_strings(OO["strings"], 16, 5, 1),
                    excitation_strings(OO["strings"], 16, 5, 2))


def strings_digest(strs) -> str:
    """sha256 of a CI-string array as int64 bytes (the loop's sorted batch strings)."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(strs, dtype=np.int64).tobytes()).hexdigest()


def solve_strings(sites=QUBIT_SOLVE["sites"], d=QUBIT_SOLVE["d"], seed=QUBIT_SOLVE["seed"]):
    """Phase 9 (b)'s subspace, as ``probes/qubit_solve_1e7.py``: the first
    ``d`` of the sorted unique values of ``1.1 d`` random ``sites``-bit
    integers (int64, ascending)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ints = np.unique(rng.integers(0, 1 << sites, size=int(d * 1.1), dtype=np.int64))[:d]
    if len(ints) != d:
        fail(f"only {len(ints)} unique strings for d = {d}")
    return ints


def dm_ring_terms(n, dm):
    """Phase 9 (c)'s complex Hamiltonian as ``(label, coeff)`` terms: a
    Heisenberg ring (J = 1) plus a Dzyaloshinskii-Moriya term ``dm (XY - YX)``
    on each bond.  The odd-Y terms make the projected operator complex, and
    XY and YX share their x-mask with XX and YY."""
    terms = []
    for i in range(n):
        j = (i + 1) % n
        for a, b, c in (("X", "X", 1.0), ("Y", "Y", 1.0), ("Z", "Z", 1.0),
                        ("X", "Y", dm), ("Y", "X", -dm)):
            chars = ["I"] * n
            chars[n - 1 - i], chars[n - 1 - j] = a, b
            terms.append(("".join(chars), c))
    return terms


def device_f64_energy(ham, vec, row_block=64) -> float:
    """:func:`host_f64_energy` transcribed to torch f64 on the operator's
    device, for shapes where the NumPy pair Gram would take minutes: the
    same quotient from the same tables, independent of
    ``SCIHamiltonian.matvec`` and ``expectation_value``."""
    import torch

    dev = ham.src_a.device
    m, n = ham.shape
    c = torch.as_tensor(vec, dtype=torch.float64, device=dev).reshape(m, n)
    c = c / torch.linalg.norm(c)
    sign_b = ham.sign_b.to(torch.float64)[:, None, :]
    npair = ham.eri_t.shape[0]
    pab = torch.zeros((npair, npair), dtype=torch.float64, device=dev)
    for i0 in range(0, m, row_block):
        rows = slice(i0, i0 + row_block)
        sign_blk = ham.sign_a[:, rows]
        live = torch.nonzero((sign_blk != 0).any(dim=1))[:, 0]
        d_a = sign_blk[live].to(torch.float64)[:, :, None] * c[ham.src_a[live, rows]]
        d_b = c[rows][:, ham.src_b].transpose(0, 1) * sign_b  # (npair, rows, n)
        pab[live] += d_a.reshape(len(live), -1) @ d_b.reshape(npair, -1).T
        del d_a, d_b
    e = torch.sum(ham.eri_t.to(torch.float64) * pab.T)
    gram_r, gram_c = c @ c.T, c.T @ c
    e += torch.sum(ham.nbr_val_a.to(torch.float64)
                   * gram_r[ham.nbr_idx_a, torch.arange(m, device=dev)[:, None]])
    e += torch.sum(ham.nbr_val_b.to(torch.float64)
                   * gram_c[ham.nbr_idx_b, torch.arange(n, device=dev)[:, None]])
    return float(e)


def integral_digests(ints) -> dict:
    """Orbital-independent digests of AO integrals ``(S, T, V, eri)``: the
    trace, Frobenius norm and sum of each (of ``eri`` as its pair matrix)."""
    import numpy as np

    out = {}
    for name, x in zip(("S", "T", "V", "eri"), ints):
        mat = x.reshape(x.shape[0] * x.shape[1], -1) if x.ndim == 4 else x
        out[name] = {"trace": float(np.trace(mat)), "norm": float(np.linalg.norm(mat)),
                     "sum": float(mat.sum())}
    return out


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def event_ms(fn, calls=10) -> float:
    """Per-call device time of ``calls`` back-to-back calls between two events."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def _kernel_of(dtype):
    """``(wrapper, operand itemsize, relative tolerance, peak FLOP/s)`` of the
    cross-spin kernel computing in ``dtype``."""
    import torch

    from sqd_tpu_torch.ops import cross_spin

    if dtype == torch.float64:
        return cross_spin.cross_spin_matvec_f64, 8, TOL_F64, PEAK_F64_FLOPS
    return cross_spin.cross_spin_matvec, 4, TOL_KERNEL, PEAK_F32_FLOPS


def check_kernel(name, ham, rng, tiles=None, c_rows=None, dtype=None) -> float:
    """The kernel of ``dtype`` (f32 by default, or f64) against its plain
    version on random amplitudes (``c_rows`` rows of them for an operator
    restricted to some output rows); returns the largest difference and
    fails past ``TOL_KERNEL`` (f64: ``TOL_F64``) ``* max(|plain|, 1)``."""
    import torch

    from sqd_tpu_torch.ops import cross_spin

    dtype = dtype or torch.float32
    wrapper, itemsize, tol, _ = _kernel_of(dtype)
    ops = ham.cross_spin_operands(dtype)
    m, n = ham.shape
    npair = ops.eri.shape[0]
    if tiles is None:
        tiles = cross_spin.plan(n, npair, cross_spin.row_stride(ops.ka_pq.shape[1], itemsize),
                                itemsize=itemsize)
    c = torch.as_tensor(rng.normal(size=(c_rows or m, n)), dtype=dtype,
                        device=ham.src_a.device)
    out = wrapper(c, ops, tiles=tiles)
    sync()
    ref = cross_spin.cross_spin_plain(c, ops)
    err = float((out - ref).abs().max())
    bound = tol * max(float(ref.abs().max()), 1.0)
    finite = bool(torch.isfinite(out).all())
    empty = (int((ops.ka_n == 0).sum()), int((ops.kb_n == 0).sum()))
    print(f"{'f64 ' if itemsize == 8 else ''}kernel vs plain [{name}] shape {(m, n)} of c "
          f"{tuple(c.shape)} npair {npair} "
          f"ka {ops.ka_pq.shape[1]} "
          f"kb {ops.kb_rs.shape[1]}, empty rows/cols {empty}, tiles (cols, rs) {tiles}: "
          f"{-(-n // tiles[0])} k x {-(-npair // tiles[1])} rs: "
          f"max|diff| {err:.3e} (bound {bound:.3e})", flush=True)
    if not finite or err > bound:
        fail(f"{wrapper.__name__} disagrees with its plain version on {name}")
    return err


def time_kernel(label, ham, rng, smi, rounds=10, calls=10, c_rows=None, dtype=None) -> dict:
    """Median per-call times of the kernel of ``dtype`` (f32 by default, or
    f64) and its plain version (in turns: plain, kernel, kernel, plain) and
    the kernel's bound, at ``ham``'s shape (with ``c_rows`` rows of
    amplitudes for an operator restricted to some output rows)."""
    import numpy as np
    import torch

    from sqd_tpu_torch.ops import cross_spin

    dtype = dtype or torch.float32
    wrapper, itemsize, _, peak = _kernel_of(dtype)
    ops = ham.cross_spin_operands(dtype)
    m, n = ham.shape
    c = torch.as_tensor(rng.normal(size=(c_rows or m, n)), dtype=dtype,
                        device=ham.src_a.device)
    npair = ops.eri.shape[0]

    def run_kernel():
        wrapper(c, ops)

    def run_plain():
        cross_spin.cross_spin_plain(c, ops)

    run_kernel(), run_plain()  # warm
    kernel_ms, plain_ms = [], []
    for _ in range(rounds):
        plain_ms.append(event_ms(run_plain, calls))
        kernel_ms.append(event_ms(run_kernel, calls))
        kernel_ms.append(event_ms(run_kernel, calls))
        plain_ms.append(event_ms(run_plain, calls))
    t_kernel, t_plain = float(np.median(kernel_ms)), float(np.median(plain_ms))
    # the least time for the same work: every valid (alpha pair, beta pair)
    # couple is one FMA; every input is read once and the output written once
    flops = 2.0 * float(ops.ka_n.sum()) * float(ops.kb_n.sum())
    moved = [c, ops.ka_n, ops.ka_pq, ops.ka_src, ops.ka_sgn,
             ops.kb_n, ops.kb_rs, ops.kb_src, ops.kb_sgn, ops.eri]
    nbytes = float(sum(t.numel() * t.element_size() for t in moved)) + itemsize * m * n
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    print(f"timing [{label}] at {(m, n)} (c {tuple(c.shape)}), npair {npair} ({smi}): "
          f"{'f64 ' if itemsize == 8 else ''}kernel {t_kernel:.4f} ms, "
          f"plain {t_plain:.4f} ms (per call: medians of {2 * rounds} rounds of {calls} calls, "
          f"CUDA events)", flush=True)
    print(f"bound [{label}]: {flops / 1e9:.4f} GFLOP at {peak / 1e12:.0f} TFLOP/s = "
          f"{t_ops:.5f} ms, "
          f"{nbytes / 1e6:.3f} MB at 3.35 TB/s = {t_bytes:.5f} ms; bound {bound_ms:.5f} ms "
          f"by {bound_by}; kernel at {bound_ms / t_kernel:.2%} of it "
          f"({flops / t_kernel / 1e9:.3f} TFLOP/s)", flush=True)
    return {"shape": [m, n, npair], "ms": t_kernel, "plain_ms": t_plain,
            "bound_ms": bound_ms, "bound_by": bound_by}


def f64_kernel_phase(dev, smi, rng, headline) -> dict:
    """Phase 3c: the f64 kernel, the exact operator's cross-spin channel, at
    the headline (``headline``, f64), the cc-pVDZ batch (28 orbitals, npair
    784), config 5 (3168 x 3200, npair 1296, two-word strings) and the CASCI
    (4384 x 4480): against its plain version in f64 (with small k and rs
    tiles forced at the first two), the f64 ``matvec`` (the kernel route)
    against the dense route that the CPU takes, within ``TOL_F64``; the
    kernel's time beside its bound and the plain version's, and one f64
    matvec by each route.  Returns the timings by shape."""
    import numpy as np
    import torch

    from sqd_tpu_torch.models.fcidump import read_fcidump
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops import hamiltonian as ham_ops

    def operator(name):
        if name == "headline":
            return headline
        if name == "ccpvdz":
            dump = read_fcidump(CCPVDZ_STEM + ".fcidump")
            return ham_ops.build_sci_hamiltonian(
                bitpack.pack_ints(excitation_strings(1000, 28, 7, 3), 28),
                bitpack.pack_ints(excitation_strings(1000, 28, 7, 4), 28),
                dump["h1e"], dump["eri"], 28, (7, 7), device=dev, pad_to=(1024, 1024),
                eri_factor=None)
        if name == "config5":
            h5, eri5, strs5 = config5_problem()
            p5 = bitpack.pack_ints(strs5, CONFIG5["norb"])
            pad = -(-len(strs5) // 32) * 32
            return ham_ops.build_sci_hamiltonian(p5, p5, h5, eri5, CONFIG5["norb"],
                                                 CONFIG5["nelec"], device=dev,
                                                 pad_to=(pad, pad), eri_factor=None)
        dump = read_fcidump(DATA_STEM + ".fcidump")
        packed = bitpack.pack_ints(all_strings(16, 5), 16)
        return ham_ops.build_sci_hamiltonian(packed, packed, dump["h1e"], dump["eri"], 16,
                                             (5, 5), device=dev, pad_to=(4384, 4384))

    forced = {"headline": (128, 96), "ccpvdz": (64, 40)}
    rounds = {"headline": (10, 10), "ccpvdz": (5, 5), "config5": (1, 1), "casci": (2, 1)}
    out = {}
    for name in ("headline", "ccpvdz", "config5", "casci"):
        ham = operator(name)
        err = check_kernel(name, ham, rng, dtype=torch.float64)
        if name in forced:
            err = max(err, check_kernel(name + "_tiled", ham, rng, forced[name],
                                        dtype=torch.float64))
        timing = time_kernel(name + " f64", ham, rng, smi, *rounds[name], dtype=torch.float64)
        c = torch.as_tensor(rng.normal(size=ham.shape), dtype=torch.float64, device=dev)
        launches = cross_spin.cross_spin_matvec_f64.launches
        route = ham.matvec(c)
        if cross_spin.cross_spin_matvec_f64.launches != launches + 1:
            fail(f"f64 matvec [{name}] did not take the f64 kernel route")
        if ham.col_block and c.shape[1] > ham.col_block:
            dense_name, dense = "_matvec_blocked", ham._matvec_blocked
        else:
            dense_name, dense = "_matvec_dense", ham._matvec_dense
        ref = dense(c)
        diff = float((route - ref).abs().max())
        bound = TOL_F64 * max(float(ref.abs().max()), 1.0)
        del route, ref
        calls = rounds[name][1]
        by_route, by_dense = [], []
        for _ in range(max(1, rounds[name][0] // 2)):  # in turns
            by_dense.append(event_ms(lambda: dense(c), calls))
            by_route.append(event_ms(lambda: ham.matvec(c), calls))
            by_route.append(event_ms(lambda: ham.matvec(c), calls))
            by_dense.append(event_ms(lambda: dense(c), calls))
        timing.update({"max_abs_err": err, "matvec_ms": float(np.median(by_route)),
                       "dense_matvec_ms": float(np.median(by_dense)), "route_vs_dense": diff})
        print(f"f64 matvec [{name}] at {tuple(c.shape)}, col_block {ham.col_block} ({smi}): "
              f"kernel route {timing['matvec_ms']:.3f} ms, dense route ({dense_name}) "
              f"{timing['dense_matvec_ms']:.3f} ms (medians, CUDA events); max|diff| "
              f"{diff:.3e} (bound {bound:.3e})", flush=True)
        if not diff <= bound:
            fail(f"the f64 kernel route disagrees with {dense_name} on {name}")
        out[name] = timing
        del ham, c
        torch.cuda.empty_cache()
    return out


STEPS = ("postselect", "recovery", "recovery on the device", "subsampling",
         "table builds + upload", "solves (tables included)")
SOLVE_STAGES = ("host tables", "densify", "f32 Davidson", "f64 refinement", "RDMs",
                "two-hole entries (in RDMs)", "f64 energy")
BLOCKED_VARIANTS = ("_SCIHamiltonian__matvec_blocked",
                    "_SCIHamiltonian__matvec_blocked_beta_first_rowmajor")


class Probe:
    """Wrappers around functions the port calls, for one phase: seconds per
    step (each wrapper synchronises the card before and after), and per batch
    solve its subspace, kernel launches, blocked-matvec variants, the
    operators it built (``col_block``, an attached factor) and the sparse
    same-spin table fills and card table builds.  Restores everything on exit."""

    def __init__(self):
        self.spans: list[dict] = [{}]
        self.solves: list[dict] = []
        self.builds: list[dict] = []
        self.variants: list[str] = []
        self.sparse_fills = 0
        self.davidson: list[tuple[str, int]] = []  # (stage, iterations) of each call
        self.davidson_runs: list[dict] = []  # converged, kernel launches of each call
        self.segments: list[int] = []  # iterations of each segment of a segmented solve
        self.history: list[list] = []
        self._originals = []

    def wrap(self, owner, name, make):
        fn = getattr(owner, name)
        self._originals.append((owner, name, fn))
        setattr(owner, name, make(fn))

    def timed(self, owner, name, key):
        def make(fn):
            def wrapper(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                self.spans[-1][key] = self.spans[-1].get(key, 0.0) + time.perf_counter() - t0
                return out
            return wrapper
        self.wrap(owner, name, make)

    def __enter__(self):
        from sqd_tpu_torch import fermion, native
        from sqd_tpu_torch.ops import card_tables, cross_spin
        from sqd_tpu_torch.ops.hamiltonian import SCIHamiltonian

        def counted_solve(fn):
            def wrapper(ci_strings, *args, **kwargs):
                launches, builds = cross_spin.cross_spin_matvec.launches, len(self.builds)
                f64_launches = cross_spin.cross_spin_matvec_f64.launches
                card_builds = card_tables.build_tables.launches
                variants, fills = len(self.variants), self.sparse_fills
                davidson = len(self.davidson)
                out = fn(ci_strings, *args, **kwargs)
                self.solves.append({
                    "davidson": self.davidson[davidson:],
                    "shape": (len(ci_strings[0]), len(ci_strings[1])),
                    "launches": cross_spin.cross_spin_matvec.launches - launches,
                    "f64_launches": cross_spin.cross_spin_matvec_f64.launches - f64_launches,
                    "builds": self.builds[builds:],
                    "variants": sorted(set(self.variants[variants:])),
                    "sparse_fills": self.sparse_fills - fills,
                    "card_builds": card_tables.build_tables.launches - card_builds,
                })
                return out
            return wrapper

        def recorded_build(fn):
            def wrapper(*args, **kwargs):
                ham = fn(*args, **kwargs)
                self.builds.append({"col_block": ham.col_block,
                                    "eri_chol": ham.eri_chol is not None, "shape": ham.shape})
                return ham
            return wrapper

        def variant(name):
            def make(fn):
                def wrapper(ham, c):
                    self.variants.append(name.split("__")[-1])
                    return fn(ham, c)
                return wrapper
            return make

        def counted_fill(fn):
            def wrapper(*args):
                self.sparse_fills += 1
                return fn(*args)
            return wrapper

        self.wrap(fermion, "build_sci_hamiltonian", recorded_build)
        self.wrap(fermion, "solve_sci", counted_solve)
        for name in BLOCKED_VARIANTS:
            self.wrap(SCIHamiltonian, name, variant(name))
        self.wrap(native.load(), "samespin_sparse_fill", counted_fill)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._originals):
            setattr(owner, name, fn)

    def loop_steps(self):
        """Time the steps of the SQD loop (phases 6 and 8)."""
        from sqd_tpu_torch import configuration_recovery, fermion

        for owner, name, key in (
            (fermion, "postselect_by_hamming_right_and_left", "postselect"),
            (fermion, "recover_configurations", "recovery"),
            (configuration_recovery, "_gumbel_noise", "recovery on the device"),
            (configuration_recovery, "_recover_kernel", "recovery on the device"),
            (fermion, "subsample", "subsampling"),
            (fermion, "build_sci_hamiltonian", "table builds + upload"),
            (fermion, "solve_sci", "solves (tables included)"),
        ):
            self.timed(owner, name, key)

    def solve_stages(self):
        """Time the stages of each solve (phases 7, 8 and 10): the host
        tables, the dense operator's build, each Davidson run by its dtype,
        the RDMs with their two-hole entries, and the f64 energy."""
        from sqd_tpu_torch import fermion, native
        from sqd_tpu_torch.ops import cross_spin
        from sqd_tpu_torch.ops import rdm as rdm_ops

        self.timed(native, "gather_tables", "host tables")
        self.timed(native, "samespin_tables", "host tables")
        self.timed(rdm_ops, "make_rdms", "RDMs")
        self.timed(rdm_ops, "_two_hole_entries", "two-hole entries (in RDMs)")
        self.timed(fermion, "expectation_value", "f64 energy")
        self.timed(fermion, "densify", "densify")

        def davidson_stage(fn):
            def wrapper(matvec, operator, hdiag, v0, **kwargs):
                stage = "f32 Davidson" if v0.dtype.itemsize == 4 else "f64 refinement"
                launches, segments = cross_spin.cross_spin_matvec.launches, len(self.segments)
                sync()
                t0 = time.perf_counter()
                out = fn(matvec, operator, hdiag, v0, **kwargs)
                sync()
                self.spans[-1][stage] = self.spans[-1].get(stage, 0.0) + time.perf_counter() - t0
                self.davidson.append((stage, out.iterations))
                self.davidson_runs.append({
                    "converged": out.converged, "residual": out.residual_norm,
                    "launches": cross_spin.cross_spin_matvec.launches - launches,
                    "segments": len(self.segments) - segments})
                return out
            return wrapper

        self.wrap(fermion, "davidson_ground_state", davidson_stage)
        # the dense-DF route's f32 solve runs in segments, as sqd_tpu's
        self.wrap(fermion, "davidson_ground_state_segmented", davidson_stage)
        self.count_segments()

    def count_segments(self):
        """Count the segments of every segmented Davidson: the calls of
        ``ops.davidson.davidson_ground_state`` that it makes by name."""
        from sqd_tpu_torch.ops import davidson

        def counted(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.segments.append(out.iterations)
                return out
            return wrapper

        self.wrap(davidson, "davidson_ground_state", counted)

    def callback(self, results):
        self.history.append(results)
        self.spans.append({})


def run_loop(dev, smi, label, h1, eri, ecore, norb, nelec, shots, settings, solver_options,
             recorded, stages=False):
    """Run the SQD loop under a :class:`Probe` (with ``stages``, timing each
    solve's stages too); print each iteration's seconds and check iteration
    0's strings against ``recorded``.  Returns the probe,
    the best result, the loop's seconds, its kernel launches and the checks."""
    import torch

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import cross_spin
    from sqd_tpu_torch.ops.table_cache import TableCache

    cache = TableCache()
    with Probe() as probe:
        probe.loop_steps()
        if stages:
            probe.solve_stages()
        cross_spin.cross_spin_matvec.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        best = fermion.diagonalize_fermionic_hamiltonian(
            h1, eri, shots, norb=norb, nelec=nelec, callback=probe.callback,
            solver_options={"table_cache": cache, **solver_options}, device=dev, **settings,
        )
        sync()
        t_loop = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
    probe.spans.pop()  # opened after the last iteration
    probe.cache = cache
    for i, (results, span) in enumerate(zip(probe.history, probe.spans)):
        steps = ", ".join(f"{k} {span[k]:.4f} s" for k in STEPS + SOLVE_STAGES if k in span)
        print(f"{label} iteration {i}: {steps}; subspaces "
              f"{[r.sci_state.amplitudes.shape for r in results]}; energies "
              f"{[round(r.energy + ecore, 10) for r in results]} Ha", flush=True)
    it0 = probe.history[0]
    it0_strings = [
        (strings_digest(r.sci_state.ci_strs_a), strings_digest(r.sci_state.ci_strs_b))
        == (b["sha256_alpha"], b["sha256_beta"])
        for r, b in zip(it0, recorded["batches"])
    ]
    checks = {
        "iteration 0 gives sqd_tpu's strings": len(it0) == len(recorded["batches"])
        and all(it0_strings),
        "the kernel launched in every batch solve":
            len(probe.solves) == sum(map(len, probe.history))
            and all(s["launches"] >= 1 for s in probe.solves),
        "every batch solve above 200k determinants (f32)": all(
            s["shape"][0] * s["shape"][1] > 200_000 for s in probe.solves),
    }
    print(f"{label}: {len(probe.history)} iterations, {len(probe.solves)} batch solves in "
          f"{t_loop:.3f} s ({smi}); best energy {best.energy + ecore:.12f} Ha; iteration 0 "
          f"vs sqd_tpu: strings {it0_strings}; kernel launches per solve "
          f"{[s['launches'] for s in probe.solves]} ({launches} in all); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return probe, best, t_loop, launches, checks


def sqd_loop_phase(dev, smi, h1, eri, ecore):
    """Phase 6: the SQD loop at full width.  Returns the kernel's launches in
    it, its best result, iteration 0's batch results, its seconds and the f64
    kernel's launches in it."""
    import numpy as np

    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu_torch.primitives import BitArray

    with open(LOOP_DATA) as f:
        recorded = json.load(f)
    norb, nelec = 16, (5, 5)
    probe, best, t_loop, launches, checks = run_loop(
        dev, smi, "sqd loop", h1, eri, ecore, norb, nelec,
        BitArray.from_bool_array(loop_shots()), LOOP_SETTINGS, {}, recorded)
    it0_diff = max(abs(r.energy - b["energy"])
                   for r, b in zip(probe.history[0], recorded["batches"]))
    state = best.sci_state
    ham = build_sci_hamiltonian(bitpack.pack_ints(state.ci_strs_a, norb),
                                bitpack.pack_ints(state.ci_strs_b, norb),
                                h1, eri, norb, nelec, device=dev)
    vec = np.zeros(ham.shape)
    vec[: state.amplitudes.shape[0], : state.amplitudes.shape[1]] = state.amplitudes
    e_host = host_f64_energy(ham, vec)
    occ_a, occ_b = best.orbital_occupancies
    strings_solved = sum(s["shape"][0] + s["shape"][1] for s in probe.solves)
    print(f"sqd loop: |E - host f64| {abs(best.energy - e_host):.3e}; iteration 0 vs sqd_tpu: "
          f"max |dE| {it0_diff:.3e}; table cache: {probe.cache.native_rows_computed} native "
          f"rows for {strings_solved} strings solved (a direct build computes "
          f"{2 * strings_solved})", flush=True)
    checks.update({
        "iteration 0 energies within 1e-7 Ha of sqd_tpu's": it0_diff < TOL_ENERGY,
        "best energy vs host f64": abs(best.energy - e_host) < TOL_ENERGY,
        "best occupancies sum to (5, 5)": abs(occ_a.sum() - 5) < 1e-8
        and abs(occ_b.sum() - 5) < 1e-8,
        "the table cache reused rows": probe.cache.native_rows_computed < strings_solved,
        "no card table build (the table cache serves every solve)": all(
            s["card_builds"] == 0 for s in probe.solves),
        "every batch f64 refinement ran the f64 kernel, no blocked matvec": all(
            s["f64_launches"] > 0 and not s["variants"] for s in probe.solves),
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"sqd loop: {what}")
    return launches, best, probe.history[0], t_loop, sum(s["f64_launches"] for s in probe.solves)


def casci_phase(dev, smi, h1, eri, ecore, rng) -> tuple[int, int, dict, float, float]:
    """Phase 7: the full N2/6-31G CASCI (C(16,5)^2 = 19,079,424 determinants)
    through ``solve_sci`` with its defaults.  Returns the kernel's and the f64
    kernel's launches in the solve, the kernel's times at this shape, its
    largest difference from the plain version and the total energy."""
    import numpy as np
    import torch

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops import hamiltonian as ham_ops

    norb, nelec = 16, (5, 5)
    strs = all_strings(norb, nelec[0])
    packed = bitpack.pack_ints(strs, norb)
    # the kernel at this shape, on the f32 operator the solve builds
    ham32 = ham_ops.build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device=dev,
                                          dtype=torch.float32, pad_to=(4384, 4384))
    err = check_kernel("casci", ham32, rng)
    timing = time_kernel("casci", ham32, rng, smi, rounds=3, calls=3)
    timing["max_abs_err"] = err
    del ham32
    torch.cuda.empty_cache()

    with Probe() as probe:
        probe.timed(fermion, "build_sci_hamiltonian", "table builds + upload")
        probe.solve_stages()
        cross_spin.cross_spin_matvec.launches = 0
        f64_launches = cross_spin.cross_spin_matvec_f64.launches
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        result = fermion.solve_sci((strs, strs), h1, eri, norb, nelec, device=dev)
        sync()
        t_solve = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
        f64_launches = cross_spin.cross_spin_matvec_f64.launches - f64_launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    span = probe.spans[-1]
    build = probe.builds[0]
    e_total = result.energy + ecore
    amps = result.sci_state.amplitudes
    occ_a, occ_b = result.orbital_occupancies
    seconds = ", ".join(f"{k} {span[k]:.3f} s" for k in ("table builds + upload", *SOLVE_STAGES)
                        if k in span)
    print(f"casci: {len(strs)} x {len(strs)} = {len(strs) ** 2} determinants, operator "
          f"{build['shape']}, col_block {build['col_block']}, f64 blocked variants "
          f"{sorted(set(probe.variants))}; {seconds}; Davidson (stage, iterations) "
          f"{probe.davidson}; "
          f"solve_sci {t_solve:.3f} s, kernel launches {launches}, f64 kernel launches "
          f"{f64_launches}, peak device memory "
          f"{peak:.2f} GB ({smi})", flush=True)
    print(f"casci: energy {e_total:.12f} Ha, published {CASCI_ENERGY:.12f} Ha, "
          f"|dE| {abs(e_total - CASCI_ENERGY):.3e} (gate {TOL_CASCI:.0e})", flush=True)
    checks = {
        "the kernel launched in the f32 Davidson": launches > 0,
        "col_block > 0": build["col_block"] > 0,
        "the f64 refinement and energy ran the f64 kernel, no blocked matvec":
            f64_launches > 0 and not probe.variants,
        "amplitudes (4368, 4368) and finite": amps.shape == (4368, 4368)
        and bool(np.isfinite(amps).all()),
        "occupancies sum to (5, 5)": abs(occ_a.sum() - 5) < 1e-8 and abs(occ_b.sum() - 5) < 1e-8,
        "rdm1/rdm2 finite": bool(np.isfinite(result.rdm1).all() and np.isfinite(result.rdm2).all()),
        "energy within 2e-6 Ha of the published CASCI energy":
            abs(e_total - CASCI_ENERGY) < TOL_CASCI,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"casci: {what}")
    return launches, f64_launches, timing, err, e_total


def ccpvdz_phase(dev, smi, factor) -> tuple[int, int]:
    """Phase 8: BASELINE config 3, the SQD loop on N2/cc-pVDZ over all 28
    orbitals.  Returns the kernel's and the f64 kernel's launches in it."""
    import numpy as np

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.models.fcidump import read_fcidump
    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu_torch.primitives import BitArray

    with open(CCPVDZ_STEM + ".json") as f:
        recorded = json.load(f)
    dump = read_fcidump(CCPVDZ_STEM + ".fcidump")
    h1, eri, ecore = dump["h1e"], dump["eri"], dump["ecore"]
    norb, nelec = 28, (7, 7)
    probe, best, _, launches, checks = run_loop(
        dev, smi, "ccpvdz loop", h1, eri, ecore, norb, nelec,
        BitArray.from_bool_array(ccpvdz_shots()), CCPVDZ_SETTINGS, {"eri_factor": factor},
        recorded, stages=True)
    # the recorded sub-batch: the first strings of iteration 0's batch 0
    first = probe.history[0][0].sci_state
    sub = (first.ci_strs_a[:CCPVDZ_SUB_BATCH], first.ci_strs_b[:CCPVDZ_SUB_BATCH])
    sub_energy = fermion.solve_sci(sub, h1, eri, norb, nelec, device=dev).energy
    sub_diff = abs(sub_energy - recorded["sub_batch"]["energy"])
    state = best.sci_state
    ham = build_sci_hamiltonian(bitpack.pack_ints(state.ci_strs_a, norb),
                                bitpack.pack_ints(state.ci_strs_b, norb),
                                h1, eri, norb, nelec, device=dev, eri_factor=None)
    vec = np.zeros(ham.shape)
    vec[: state.amplitudes.shape[0], : state.amplitudes.shape[1]] = state.amplitudes
    sync()
    t0 = time.perf_counter()
    e_host = host_f64_energy(ham, vec)
    t_host = time.perf_counter() - t0
    occ_a, occ_b = best.orbital_occupancies
    print(f"ccpvdz loop: sub-batch {tuple(map(len, sub))} energy vs sqd_tpu |dE| "
          f"{sub_diff:.3e}; best |E - host f64| {abs(best.energy - e_host):.3e} (host quotient "
          f"in 32-row blocks, {t_host:.2f} s); RHF {recorded['rhf_energy']:.12f} Ha; per solve: "
          f"operators {[b for s in probe.solves for b in s['builds']]}, card table builds "
          f"{[s['card_builds'] for s in probe.solves]}, sparse same-spin fills "
          f"{[s['sparse_fills'] for s in probe.solves]}, f64 blocked variants "
          f"{[s['variants'] for s in probe.solves]}, f64 kernel launches "
          f"{[s['f64_launches'] for s in probe.solves]}, Davidson (stage, iterations) "
          f"{[s['davidson'] for s in probe.solves]}", flush=True)
    checks.update({
        "every batch above 877 strings per spin (sparse same-spin tables)": all(
            min(s["shape"]) > 877 for s in probe.solves),
        # 4558 candidates a string: the cache declines them, the card builds
        "every batch solve built its tables on the card": all(
            s["card_builds"] == 1 and s["sparse_fills"] == 0 for s in probe.solves),
        "every batch operator has col_block > 0 and an attached eri_chol": all(
            len(s["builds"]) == 1 and s["builds"][0]["col_block"] > 0
            and s["builds"][0]["eri_chol"] for s in probe.solves),
        "every batch f64 refinement ran the f64 kernel, no blocked matvec": all(
            s["f64_launches"] > 0 and not s["variants"] for s in probe.solves),
        "sub-batch energy within 1e-7 Ha of sqd_tpu's": sub_diff < TOL_ENERGY,
        "best energy vs host f64": abs(best.energy - e_host) < TOL_ENERGY,
        "best occupancies sum to (7, 7)": abs(occ_a.sum() - 7) < 1e-8
        and abs(occ_b.sum() - 7) < 1e-8,
        "best energy below RHF": best.energy + ecore < recorded["rhf_energy"],
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"ccpvdz loop: {what}")
    return launches, sum(s["f64_launches"] for s in probe.solves)


def pauli_host_energy(ints, paulis, coeffs, vec) -> float:
    """<v|H|v> / <v|v> of a Pauli sum over the sorted unique strings ``ints``
    (int64, under 63 qubits) in plain NumPy, independent of the port: per
    unique x-mask one ``np.searchsorted`` of ``ints ^ x``, and each term's
    sign from ``np.bitwise_count`` parity, ``A[row, col] = c i^{#Y}
    (-1)^{popcount(row & z)}`` as the reference projects.  The groups run on
    8 threads (NumPy releases the GIL in these calls)."""
    import numpy as np

    v = np.asarray(vec)
    groups: dict[int, list] = {}
    for pauli, c in zip(paulis, coeffs):
        z = sum(1 << int(q) for q in np.flatnonzero(pauli.z))
        x = sum(1 << int(q) for q in np.flatnonzero(pauli.x))
        n_y = int(np.sum(np.asarray(pauli.z) & np.asarray(pauli.x)))
        groups.setdefault(x, []).append((z, complex(c) * 1j ** n_y))

    def group_term(item):
        x, terms = item
        weight = np.zeros(len(ints), dtype=np.complex128)
        for z, c in terms:
            weight += c * (1 - 2 * (np.bitwise_count(ints & np.int64(z)) & 1).astype(np.float64))
        if x == 0:
            return np.vdot(v, weight * v)
        conn = ints ^ np.int64(x)
        pos = np.minimum(np.searchsorted(ints, conn), len(ints) - 1)
        hit = ints[pos] == conn
        return np.vdot(v[hit], weight[hit] * v[pos[hit]])

    with ThreadPoolExecutor(8) as pool:
        total = sum(pool.map(group_term, groups.items()))
    return float(np.real(total) / np.vdot(v, v).real)


def projection_phase(dev, smi) -> None:
    """Phase 9 (a): ``bench.py``'s projection headline on the card."""
    import numpy as np
    import torch

    from sqd_tpu_torch import native, qubit
    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.pauli_proj import pauli_masks_to_packed, pauli_term_table
    from sqd_tpu_torch.primitives import Pauli

    def time_term(words, pauli):
        """Best of 3 of the device table, each ended by reading a checksum."""
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            col, sign, _ = pauli_term_table(words, pauli, device=dev)
            checksum = int(sign.sum(dtype=torch.int64))
            best = min(best, time.perf_counter() - t0)
        return best, col, sign, checksum

    def best_of(n, fn):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return best, out

    for nq, seed, ref_s in PROJ_CASES:
        t0 = time.perf_counter()
        # bench.py's inputs: sorted unique values of PROJ_D random nq-bit
        # integers; the sort and dedup run on the card, giving the same set
        ints = np.random.default_rng(seed).integers(0, 1 << nq, size=PROJ_D, dtype=np.int64)
        uniq = torch.unique(torch.from_numpy(ints).to(dev))
        words = torch.stack([uniq & 0xFFFFFFFF, uniq >> 32], dim=1)
        packed = bitpack.to_host_words(words)
        d = len(packed)
        del ints, uniq
        parity = np.bitwise_count(packed).sum(axis=1, dtype=np.int64) & 1
        host_checksum = d - 2 * int(parity.sum())
        t_setup = time.perf_counter() - t0
        pz = Pauli.from_label("Z" * nq)
        t_z, _, _, checksum = time_term(words, pz)
        # a table reads the int64 words once and writes int32 columns and int8 signs
        bound_s = (words.numel() * words.element_size() + 5 * d) / PEAK_HBM_BYTES
        checks = {f"Z^{nq} signs sum to the host parity count": checksum == host_checksum}
        line = (f"projection {nq} qubits, d = {d} ({smi}): setup {t_setup:.2f} s; Z^{nq} "
                f"pauli_term_table on the card {t_z:.4f} s (best of 3, a checksum read "
                f"ends each), checksum {checksum} (host {host_checksum}); a table's byte "
                f"bound {bound_s * 1e3:.4f} ms (words read, columns and signs written, "
                f"3.35 TB/s)")
        if nq == 40:
            px = Pauli.from_label("X" + "Z" * (nq - 1))
            t_x, col, sign, _ = time_term(words, px)
            zw, xw = pauli_masks_to_packed(px.z, px.x)
            t0 = time.perf_counter()
            member = native.connected_membership(packed, xw)
            t_host = time.perf_counter() - t0
            zpar = np.bitwise_count(packed & zw[None, :2]).sum(axis=1, dtype=np.int64) & 1
            want_sign = np.where(member >= 0, 1 - 2 * zpar, 0)
            col, sign = col.cpu().numpy(), sign.cpu().numpy()
            cols_ok = bool(np.array_equal(col, np.where(member >= 0, member, d)))
            checks["X Z^39 columns equal the host radix merge's"] = cols_ok
            checks["X Z^39 signs equal the host parity"] = bool(np.array_equal(sign, want_sign))
            line += (f"; X Z^39 (pairing) {t_x:.4f} s, {int((member >= 0).sum())} partners, "
                     f"columns {'equal' if cols_ok else 'UNEQUAL'} to "
                     f"native.connected_membership (host radix merge, {t_host:.2f} s)")
            del col, sign, member, zpar, want_sign
        t_api, (amps, rows, _) = best_of(2, lambda: qubit.matrix_elements_from_pauli(
            packed, pz, device=dev))
        checks["packed API amplitudes"] = len(rows) == d and int(amps.real.sum()) == host_checksum
        del amps, rows
        bool_mat = bitpack.unpack_to_bool_matrix(packed, nq)
        t_bool, (amps, rows, _) = best_of(2, lambda: qubit.matrix_elements_from_pauli(
            bool_mat, pz, device=dev))
        checks["bool API amplitudes"] = len(rows) == d and int(amps.real.sum()) == host_checksum
        del amps, rows, bool_mat
        print(f"{line}; matrix_elements_from_pauli (host C++ for a diagonal term) on the "
              f"packed input {t_api:.4f} s, on the {d * nq / 1e9:.1f} GB bool matrix "
              f"{t_bool:.4f} s (best of 2); the reference's published CPU figure for the "
              f"bool setup: {ref_s} s", flush=True)
        for what, ok in checks.items():
            if not ok:
                fail(f"projection {nq} qubits: {what}")
        del words, packed
        torch.cuda.empty_cache()


def qubit_solve_phase(dev, smi) -> None:
    """Phase 9 (b): ``solve_qubit_device`` with its defaults on the recorded
    Heisenberg subspace, and one f32 and one f64 matvec beside their bound."""
    import numpy as np
    import torch

    from sqd_tpu_torch import qubit
    from sqd_tpu_torch.models.heisenberg import heisenberg_ring
    from sqd_tpu_torch.ops import pauli_proj
    from sqd_tpu_torch.ops.pauli_proj import estimate_operator_bytes, pauli_apply_flat

    with open(QUBIT_DATA) as f:
        recorded = json.load(f)
    sites, seed, tol = QUBIT_SOLVE["sites"], QUBIT_SOLVE["seed"], QUBIT_SOLVE["tol"]
    ints = solve_strings(sites, recorded["d"], seed)
    if strings_digest(ints) != recorded["sha256_strings"]:
        fail("qubit solve: the strings differ from the recorded ones")
    op = heisenberg_ring(sites, h_z=QUBIT_SOLVE["h_z"])
    davidson: list[tuple[str, int, int]] = []
    probe = Probe()
    probe.timed(qubit, "build_projected_operator", "operator build")
    probe.timed(pauli_proj, "_pair_cols", "membership (pairing sorts)")

    def stage(fn):
        def wrapper(matvec, operator, hdiag, v0, **kwargs):
            name = "f32 Davidson" if v0.dtype.itemsize == 4 else "f64 Davidson"
            segments = len(probe.segments)
            sync()
            t0 = time.perf_counter()
            out = fn(matvec, operator, hdiag, v0, **kwargs)
            sync()
            probe.spans[-1][name] = time.perf_counter() - t0
            davidson.append((name, out.iterations, len(probe.segments) - segments))
            return out
        return wrapper

    # both stages run in segments, as sqd_tpu's
    probe.wrap(qubit, "davidson_ground_state_segmented", stage)
    probe.count_segments()
    try:
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        energy, vec, proj = qubit.solve_qubit_device(
            ints.astype(np.uint32)[:, None], op, tol=tol, device=dev)
        t_solve = time.perf_counter() - t0
    finally:
        probe.__exit__()
    peak = torch.cuda.max_memory_allocated() / 1e9
    span = probe.spans[-1]
    t0 = time.perf_counter()
    e_host = pauli_host_energy(ints, op.paulis, op.coeffs, vec)
    t_host = time.perf_counter() - t0
    kmax = proj.coeff.shape[1] if proj.packed_weights else 1
    # the membership build reads the int64 words once per x-mask and writes perm
    member_bound = proj.perm.shape[0] * proj.dim * (8 + 4) / PEAK_HBM_BYTES
    estimate = estimate_operator_bytes(proj.dim, num_nondiag_groups=proj.perm.shape[0],
                                       max_terms_per_group=kmax, weights="packed")
    print(f"qubit solve: L = {sites} ring, {op.size} terms, d = {proj.dim}, {proj.num_groups} "
          f"groups, packed weights {proj.packed_weights}, group loop {proj.scan_matvec}, "
          f"operator {proj.memory_bytes / 1e9:.3f} GB (estimate {estimate / 1e9:.3f} GB); "
          f"solve_qubit_device {t_solve:.3f} s: operator build {span['operator build']:.3f} s "
          f"(membership: {proj.perm.shape[0]} pairing sorts "
          f"{span.get('membership (pairing sorts)', 0.0):.3f} s, byte bound "
          f"{member_bound * 1e3:.3f} ms), "
          + ", ".join(f"{k} {span[k]:.3f} s" for k in ("f32 Davidson", "f64 Davidson")
                      if k in span)
          + f"; Davidson (stage, iterations, segments) {davidson}; peak device memory "
          f"{peak:.2f} GB "
          f"({smi})", flush=True)
    print(f"qubit solve: energy {energy:.12f}, |E - host f64| {abs(energy - e_host):.3e} "
          f"(host quotient {t_host:.2f} s), |E - sqd_tpu| {abs(energy - recorded['energy']):.3e} "
          f"(sqd_tpu {recorded['energy']:.12f})", flush=True)
    checks = {
        "packed weights and the group loop": proj.packed_weights and proj.scan_matvec,
        "membership by the pairing sorts": "membership (pairing sorts)" in span,
        "the recorded group count": proj.num_groups == recorded["num_groups"],
        "operator bytes equal the estimate": proj.memory_bytes == estimate,
        "an f32 stage and an f64 stage ran": [s for s, _, _ in davidson] == ["f32 Davidson",
                                                                             "f64 Davidson"],
        "energy within 1e-7 of the host f64 quotient": abs(energy - e_host) < TOL_ENERGY,
        "energy within 1e-6 of sqd_tpu's": abs(energy - recorded["energy"]) < 1e-6,
        "vector finite and normalized": bool(np.isfinite(vec).all())
        and abs(np.linalg.norm(vec) - 1.0) < 1e-8,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"qubit solve: {what}")

    # one f32 and one f64 matvec, beside the bytes they must move: perm, sign
    # words, coefficients, hdiag, the gathered values, the vector and the result
    d, groups = proj.dim, proj.perm.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float32, torch.float64):
        v = torch.randn(d, dtype=dt, device=dev, generator=gen)
        pauli_apply_flat(proj, v)
        ms = float(np.median([event_ms(lambda: pauli_apply_flat(proj, v), 5) for _ in range(5)]))
        size = v.element_size()
        nbytes = (proj.memory_bytes + groups * d * size + 2 * d * size)
        bound = nbytes / PEAK_HBM_BYTES * 1e3
        print(f"pauli_apply_flat {str(dt).split('.')[-1]} at d = {d}, {groups} groups ({smi}): "
              f"{ms:.4f} ms (median of 5 rounds of 5 calls, CUDA events); bound "
              f"{nbytes / 1e9:.4f} GB at 3.35 TB/s = {bound:.4f} ms, {bound / ms:.2%} of it",
              flush=True)
    del proj
    torch.cuda.empty_cache()


def qubit_k_phase(dev, smi) -> None:
    """Phase 9 (c): complex operators and k = 3 against scipy's ``eigsh``."""
    import numpy as np

    from sqd_tpu_torch import qubit
    from sqd_tpu_torch.models.heisenberg import heisenberg_ring
    from sqd_tpu_torch.primitives import SparsePauliOp

    n, k = QUBIT_K["sites"], QUBIT_K["k"]
    rng = np.random.default_rng(QUBIT_K["seed"])
    ints = np.sort(rng.choice(1 << n, size=QUBIT_K["d"], replace=False))
    mat = ((ints[:, None] >> np.arange(n)[::-1]) & 1).astype(bool)
    for name, op in (("DM ring", SparsePauliOp.from_list(dm_ring_terms(n, QUBIT_K["dm"]))),
                     ("real ring", heisenberg_ring(n, h_z=QUBIT_SOLVE["h_z"]))):
        t0 = time.perf_counter()
        w_ref, _ = qubit.solve_qubit(mat, op, k=k, which="SA", device=dev)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        w, v, proj = qubit.solve_qubit_device(mat, op, k=k, device=dev)
        t_dev = time.perf_counter() - t0
        diff = float(np.abs(np.sort(w_ref) - w).max())
        ortho = float(np.abs(v.conj().T @ v - np.eye(k)).max())
        print(f"qubit k = {k} [{name}], d = {len(ints)}, {op.size} terms, complex "
              f"{proj.is_complex} (vectors {v.dtype}): solve_qubit_device {t_dev:.3f} s, "
              f"solve_qubit (host eigsh) {t_ref:.3f} s; energies {np.round(w, 10).tolist()}, "
              f"max |dE| {diff:.3e}, columns orthonormal to {ortho:.3e} ({smi})", flush=True)
        checks = {
            "complex128 where the operator is complex": proj.is_complex == (name == "DM ring")
            and v.dtype == (np.complex128 if proj.is_complex else np.float64),
            "energies within 1e-7 of eigsh's": diff < TOL_ENERGY,
            "orthonormal columns": ortho < 1e-8,
        }
        for what, ok in checks.items():
            if not ok:
                fail(f"qubit k = {k} [{name}]: {what}")


def two_hole_tables(dev, smi, packed, norb, n_elec) -> None:
    """Phase 10 (a): ``linktab.build_desdes_tables`` on the config-5 strings
    (the RDMs' same-spin tables: int32 sources, as ``sqd_tpu``'s), their
    measured bytes and seconds; indexing with a chunk of the int32 sources
    must equal indexing with its int64 cast."""
    import torch

    from sqd_tpu_torch.ops import linktab

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    _, src, sign = linktab.build_desdes_tables(packed, norb, n_elec, device=dev)
    sync()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    src_bytes, sign_bytes = (t.numel() * t.element_size() for t in (src, sign))
    values = torch.arange(len(packed), dtype=torch.float64, device=dev)
    chunk = src[:, :4096]
    same = torch.equal(values[chunk], values[chunk.long()])
    print(f"config 5 two-hole tables: {src.shape[1]} intermediates per spin, src "
          f"{tuple(src.shape)} {src.dtype} {src_bytes / 1e9:.3f} GB + sign {sign.dtype} "
          f"{sign_bytes / 1e9:.3f} GB = {(src_bytes + sign_bytes) / 1e9:.3f} GB measured (int64 "
          f"sources would take {src_bytes * 2 / 1e9:.3f} GB); built in {secs:.3f} s, peak "
          f"{peak / 1e9:.3f} GB; int32 indexing equals int64 indexing: {same} ({smi})",
          flush=True)
    if src.dtype != torch.int32 or not same:
        fail("config 5: the two-hole sources are not int32, or int32 indexing differs")
    del src, sign, values, chunk
    torch.cuda.empty_cache()


def dense_df_phase(dev, smi, rng) -> tuple[int, dict, float, float, float]:
    """Phase 10: BASELINE config 5 by the gather route and the dense
    density-fitted route.  Returns the kernel's launches in the gather solve,
    its times at this shape, its largest difference from the plain version
    and the dense and the gather route's energies."""
    import dataclasses

    import numpy as np
    import torch

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import bitpack, card_tables, cross_spin
    from sqd_tpu_torch.ops import hamiltonian as ham_ops
    from sqd_tpu_torch.ops.dense_df import densify

    norb, nelec = CONFIG5["norb"], CONFIG5["nelec"]
    h1, eri, strs = config5_problem()
    packed = bitpack.pack_ints(strs, norb)
    pad = -(-len(strs) // 32) * 32  # solve_sci's pad_bucket

    # -- (a) the operator, and the kernel at npair 1296 -----------------------
    card_builds = card_tables.build_tables.launches
    with Probe() as probe:
        sync()
        t0 = time.perf_counter()
        ham64 = ham_ops.build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device=dev,
                                              pad_to=(pad, pad))
        sync()
        t_build = time.perf_counter() - t0
    card_builds = card_tables.build_tables.launches - card_builds
    ham32 = ham64.astype(torch.float32)
    m, n = ham64.shape
    rank = None if ham64.eri_chol is None else ham64.eri_chol.shape[0]
    print(f"config 5: {len(strs)} x {len(strs)} = {len(strs) ** 2} determinants of {norb} "
          f"orbitals, {packed.shape[1]}-word strings, operator {(m, n)}, npair {norb * norb}, "
          f"col_block {ham64.col_block}, eri_factor 'auto' rank {rank}, same-spin lists "
          f"{tuple(ham64.nbr_idx_a.shape)} ({card_builds} card build, {probe.sparse_fills} "
          f"sparse fills); build "
          f"{t_build:.3f} s ({smi})", flush=True)
    checks = {
        "two-word strings": packed.shape[1] == 2,
        "'auto' attached a factor of rank <= npair // 3": rank is not None
        and rank <= norb * norb // 3,
        "the card built the tables": card_builds == 1 and probe.sparse_fills == 0,
        "padded to (3168, 3200) with a column block": (m, n) == (3168, 3200)
        and ham64.col_block > 0,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"config 5: {what}")
    err = check_kernel("config5", ham32, rng)
    timing = time_kernel("config5", ham32, rng, smi, rounds=3, calls=3)
    timing["max_abs_err"] = err
    # the 2-RDMs' two-hole tables at this shape, built and measured; the
    # 2-RDM's Grams over them stay out of (c) (with_rdms=False)
    two_hole_tables(dev, smi, packed, norb, nelec[0])
    # the operator by both table builds (phase 12 (b)): 12,880 same-spin
    # candidates per string, so the device build runs in row chunks; the
    # pair factor, which both backends share, is left out of these builds
    compare_tables("config5", dev, smi, packed, packed, h1, eri, norb, nelec, pad_to=(pad, pad),
                   eri_factor=None)

    # -- (b) one matvec by each route -------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    dense = densify(ham64, dtype=torch.float32)
    sync()
    t_densify = time.perf_counter() - t0
    peak_densify = torch.cuda.max_memory_allocated() - base
    aliased = dense.wb.data_ptr() == dense.wa.data_ptr()
    stack_bytes = dense.wa.numel() * dense.wa.element_size() * (1 if aliased else 2)
    c32 = torch.zeros((m, n), dtype=torch.float32, device=dev)
    c32[: len(strs), : len(strs)] = torch.as_tensor(
        rng.normal(size=(len(strs), len(strs))), dtype=torch.float32, device=dev)
    ref = ham64.matvec(c32.to(torch.float64))
    by_dense, by_kernel = dense.matvec(c32), ham32.matvec(c32)
    scale = max(float(ref.abs().max()), 1.0)
    diffs = {  # what: (largest difference, bound)
        "kernel-route f32 vs exact f64": (float((by_kernel - ref).abs().max()),
                                          TOL_KERNEL * scale),
        "dense f32 vs exact f64": (float((by_dense - ref).abs().max()), TOL_DENSE * scale),
        "dense f32 vs kernel-route f32": (float((by_dense - by_kernel).abs().max()),
                                          TOL_DENSE * scale),
    }
    del ref, by_dense, by_kernel
    whole = dataclasses.replace(dense, x_chunk=0)
    routes = {
        "gather (kernel route)": lambda: ham32.matvec(c32),
        "dense x_chunk 8": lambda: dense.matvec(c32),
        "dense whole stack": lambda: whole.matvec(c32),
    }
    whole.matvec(c32)  # warm; the other two ran above
    rounds = {key: [] for key in routes}
    for _ in range(3):  # in turns
        for key, fn in routes.items():
            rounds[key].append(event_ms(fn, 2))
    ms = {key: float(np.median(times)) for key, times in rounds.items()}
    peak_matvec = torch.cuda.max_memory_allocated() - base
    # the dense route's least time: 4 X P^3 FLOPs of f32 products at the common
    # padded width P (plus the two same-spin products), and the factors, c and
    # sigma moved once
    x_tot, p_w = dense.wa.shape[0], dense.wa.shape[1]
    flops = 4.0 * x_tot * p_w ** 3 + 4.0 * p_w ** 3
    moved = stack_bytes + dense.haa.numel() * 4 * (1 if aliased else 2) + 2 * m * n * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, moved / PEAK_HBM_BYTES * 1e3
    dense_bound = max(t_ops, t_bytes)
    print(f"config 5 matvec ({smi}): densify {t_densify:.3f} s (peak {peak_densify / 1e9:.2f} GB "
          f"over the operator's tables), W stack {tuple(dense.wa.shape)} f32 = "
          f"{stack_bytes / 1e9:.3f} GB, wb aliases wa: {aliased}; one f32 matvec: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (medians of 3 rounds of 2 calls, CUDA events); dense bound {flops / 1e12:.3f} "
          f"TFLOP at 67 TFLOP/s = {t_ops:.2f} ms ({moved / 1e9:.2f} GB at 3.35 TB/s = "
          f"{t_bytes:.2f} ms), x_chunk 8 at {dense_bound / ms['dense x_chunk 8']:.1%} of it; "
          f"the kernel alone {timing['ms']:.2f} ms of the gather route (bound "
          f"{timing['bound_ms']:.3f} ms); peak with the matvecs {peak_matvec / 1e9:.2f} GB; "
          + ", ".join(f"{k} {d:.3e} (bound {b:.3e})" for k, (d, b) in diffs.items()),
          flush=True)
    if not aliased:
        fail("config 5: densify built a second W stack for identical string sets")
    for what, (diff, bound) in diffs.items():
        if not diff <= bound:
            fail(f"config 5: {what} differ by {diff:.3e}")
    del dense, whole, ham32, c32
    torch.cuda.empty_cache()

    # -- (c) solve_sci by both strategies -----------------------------------------
    def solve(count, strategy):
        with Probe() as probe:
            probe.timed(fermion, "build_sci_hamiltonian", "table builds + upload")
            probe.solve_stages()
            cross_spin.cross_spin_matvec.launches = 0
            torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            result = fermion.solve_sci((strs[:count], strs[:count]), h1, eri, norb, nelec,
                                       device=dev, matvec_strategy=strategy, **CONFIG5_SOLVER)
            sync()
            seconds = time.perf_counter() - t0
            launches = cross_spin.cross_spin_matvec.launches
        run = probe.davidson_runs[0]
        span = probe.spans[-1]
        stages = ", ".join(f"{k} {span[k]:.3f} s"
                           for k in ("table builds + upload", *SOLVE_STAGES) if k in span)
        print(f"config 5 solve_sci [{strategy}, {count} strings per spin] ({smi}): "
              f"{seconds:.3f} s; {stages}; Davidson {probe.davidson} in {run['segments']} "
              f"segment(s), converged {run['converged']}, residual {run['residual']:.3e}, "
              f"kernel launches in it "
              f"{run['launches']} ({launches} in the solve); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        if not (len(probe.davidson_runs) == 1 and run["converged"]):
            fail(f"config 5 [{strategy}, {count}]: one converged f32 Davidson expected")
        if (run["launches"] > 0) != (strategy == "gather"):
            fail(f"config 5 [{strategy}, {count}]: {run['launches']} kernel launches in the "
                 f"Davidson")
        return result, launches

    def padded(amps, shape):
        vec = np.zeros(shape)
        vec[: amps.shape[0], : amps.shape[1]] = amps
        return vec

    # the sub-shape, where the NumPy quotient takes seconds
    sub = bitpack.pack_ints(strs[:CONFIG5_SUB], norb)
    ham_sub = ham_ops.build_sci_hamiltonian(sub, sub, h1, eri, norb, nelec, device=dev,
                                            eri_factor=None)
    sub_diffs = {}
    for strategy in ("gather", "dense_df"):
        result, _ = solve(CONFIG5_SUB, strategy)
        vec = padded(result.sci_state.amplitudes, ham_sub.shape)
        t0 = time.perf_counter()
        e_host = host_f64_energy(ham_sub, vec)
        t_host = time.perf_counter() - t0
        sub_diffs[f"{strategy}: |E - host f64|"] = abs(result.energy - e_host)
        sub_diffs[f"{strategy}: |device quotient - host f64|"] = abs(
            device_f64_energy(ham_sub, vec) - e_host)
    print(f"config 5 at {CONFIG5_SUB} strings per spin: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sub_diffs.items())
          + f" (NumPy quotient {t_host:.2f} s)", flush=True)
    for what, diff in sub_diffs.items():
        if not diff < TOL_ENERGY:
            fail(f"config 5 sub-shape: {what} = {diff:.3e}")
    del ham_sub

    results = {}
    for strategy in ("gather", "dense_df"):
        result, launches = solve(len(strs), strategy)
        sync()
        t0 = time.perf_counter()
        e_quot = device_f64_energy(ham64, padded(result.sci_state.amplitudes, ham64.shape))
        t_quot = time.perf_counter() - t0
        results[strategy] = (result, launches, e_quot)
        occ_a, occ_b = result.orbital_occupancies
        print(f"config 5 [{strategy}]: energy {result.energy:.10f} Ha, |E - device f64 "
              f"quotient| {abs(result.energy - e_quot):.3e} (quotient {t_quot:.2f} s)",
              flush=True)
        checks = {
            "energy within 1e-7 Ha of the f64 quotient": abs(result.energy - e_quot) < TOL_ENERGY,
            "amplitudes (3163, 3163) and finite": result.sci_state.amplitudes.shape
            == (len(strs), len(strs)) and bool(np.isfinite(result.sci_state.amplitudes).all()),
            "occupancies sum to (27, 27)": abs(occ_a.sum() - 27) < 1e-8
            and abs(occ_b.sum() - 27) < 1e-8,
            "no 2-RDM was asked for": result.rdm2 is None,
        }
        for what, ok in checks.items():
            if not ok:
                fail(f"config 5 [{strategy}]: {what}")
    between = abs(results["gather"][0].energy - results["dense_df"][0].energy)
    print(f"config 5: |E(gather) - E(dense_df)| {between:.3e} Ha (gate {TOL_ROUTES:.0e})",
          flush=True)
    if not between < TOL_ROUTES:
        fail("config 5: the two routes' energies differ")
    if results["dense_df"][1] != 0 or results["gather"][1] == 0:
        fail("config 5: the kernel must launch in the gather solve and not in the dense one")
    return (results["gather"][1], timing, err, results["dense_df"][0].energy,
            results["gather"][0].energy)


TOL_OO_ENERGY = 1e-6  # Ha, each outer iteration's solve against sqd_tpu's record
# final k_flat, max-abs: 100 x the solves' residual tolerance (1e-6).  The
# RDMs are first order in the residual, and each outer iteration's SGD moves
# the minimiser of the RDM-contracted energy by their error over the
# curvature; the port's CPU run with the same f32-then-f64 solves lands
# 1.6e-6 from the record
TOL_OO_K = 1e-4
TOL_SGD = 1e-10  # 100 SGD steps: the card's form against the port's CPU step
SGD_CHECK_STEPS = 100
AUGMENT_CHECK_SHOTS = 2000


def single_excitation_operators(norb):
    """Every same-spin single excitation of ``2 * norb`` modes as transition
    strings: ``'+'`` at q, ``'-'`` at p, p != q within each half of the row
    (``2 norb (norb - 1)`` operators)."""
    import numpy as np

    ops = []
    for base in (0, norb):
        for p in range(norb):
            for q in range(norb):
                if p != q:
                    row = np.full(2 * norb, "I")
                    row[base + q], row[base + p] = "+", "-"
                    ops.append(row)
    return np.array(ops)


def excitation_rows_loop(shots, ops):
    """``enlarge_batch_from_transitions`` written as a loop over operators and
    modes in NumPy: '+' needs an empty mode and fills it, '-' needs a filled
    one and empties it, 'n' needs a filled one; rows operator-major."""
    import numpy as np

    out = []
    for op in ops:
        new, ok = shots.copy(), np.ones(len(shots), dtype=bool)
        for j, ch in enumerate(op):
            if ch == "+":
                ok &= ~shots[:, j]
                new[:, j] = True
            elif ch == "-":
                ok &= shots[:, j]
                new[:, j] = False
            elif ch == "n":
                ok &= shots[:, j]
        out.append(new[ok])
    return np.concatenate(out)


def oo_phase(dev, smi, h1, eri, ecore) -> int:
    """Phase 11 (a): orbital optimization (BASELINE config 4's path) through
    ``optimize_orbitals`` with f32 solves.  Returns the kernel's launches."""
    import numpy as np
    import torch

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import cross_spin

    with open(OO_DATA) as f:
        recorded = json.load(f)
    k_rand, strings = oo_inputs()
    h_rand, eri_rand = fermion.rotate_integrals(h1, eri, k_rand, device=dev)
    h_cpu, eri_cpu = fermion.rotate_integrals(h1, eri, k_rand, device="cpu")
    rot_err = max(float(np.abs(h_rand - h_cpu).max()), float(np.abs(eri_rand - eri_cpu).max()))
    iterations = []  # per outer iteration: solve seconds, result, SGD seconds

    def timed_solve(fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            iterations.append({"solve_s": time.perf_counter() - t0, "result": out})
            return out
        return wrapper

    def timed_sgd(fn):
        def wrapper(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            iterations[-1]["sgd_s"] = time.perf_counter() - t0
            return out
        return wrapper

    with Probe() as probe:
        probe.wrap(fermion, "solve_sci", timed_solve)
        probe.wrap(fermion, "_sgd_momentum_orbital_step", timed_sgd)
        cross_spin.cross_spin_matvec.launches = 0
        sync()
        t0 = time.perf_counter()
        energy, k_final, _ = fermion.optimize_orbitals(
            strings, h_rand, eri_rand, np.zeros(120), num_iters=OO["num_iters"],
            num_steps_grad=OO["num_steps_grad"], learning_rate=OO["learning_rate"],
            momentum=OO["momentum"], device=dev, solver_dtype=torch.float32)
        sync()
        t_oo = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
    steps = OO["num_steps_grad"]
    for i, (it, solve, e_ref) in enumerate(zip(iterations, probe.solves,
                                               recorded["iteration_energies"])):
        print(f"oo iteration {i}: solve {it['solve_s']:.3f} s ({solve['launches']} kernel "
              f"launches), SGD {it['sgd_s']:.3f} s = {it['sgd_s'] / steps * 1e3:.4f} ms per step "
              f"({steps} steps, CUDA graph); energy {it['result'].energy + ecore:.10f} Ha, "
              f"|E - sqd_tpu| {abs(it['result'].energy - e_ref):.3e} ({smi})", flush=True)
    energies = [it["result"].energy for it in iterations]
    k_err = float(np.abs(k_final - np.array(recorded["k_flat"])).max())
    print(f"optimize_orbitals: {len(iterations)} outer iterations in {t_oo:.3f} s ({smi}); "
          f"{np.prod([len(s) for s in strings])} determinants; energy {energy + ecore:.10f} Ha "
          f"from {energies[0] + ecore:.10f} at k = 0 (unrotated basis "
          f"{recorded['unrotated_energy'] + ecore:.10f}); |k - sqd_tpu| {k_err:.3e} (gate "
          f"{TOL_OO_K:.0e}); rotate_integrals card vs CPU {rot_err:.3e}; {launches} kernel "
          f"launches", flush=True)

    # the SGD forms on the last solve's fixed RDMs: graph and eager on the
    # card, eager on the CPU
    last = iterations[-1]["result"]
    rdm2_phys = np.transpose(last.rdm2, (0, 2, 3, 1))
    eri_phys = np.transpose(eri_rand, (0, 2, 3, 1))
    k_start = np.array(recorded["k_flat"])

    def tensors(device):
        return [torch.tensor(np.asarray(x), dtype=torch.float64, device=device)
                for x in (last.rdm1, rdm2_phys, h_rand, eri_phys, k_start)]

    rates = (OO["learning_rate"], OO["momentum"])
    squarings = fermion.EXPM_SQUARINGS
    on_card, on_cpu = tensors(dev), tensors("cpu")
    timings = {}
    for label, run, n_steps in (("graph", fermion._sgd_graph, 10 * SGD_CHECK_STEPS),
                                ("eager", fermion._sgd_eager, 2 * SGD_CHECK_STEPS)):
        run(*on_card, *rates, 1, squarings)  # warm
        sync()
        t0 = time.perf_counter()
        run(*on_card, *rates, n_steps, squarings)
        sync()
        timings[label] = (time.perf_counter() - t0) / n_steps * 1e3
    graph_k = fermion._sgd_momentum_orbital_step(*on_card, *rates, SGD_CHECK_STEPS).cpu()
    eager_k, _ = fermion._sgd_eager(*on_card, *rates, SGD_CHECK_STEPS, squarings)
    t0 = time.perf_counter()
    cpu_k = fermion._sgd_momentum_orbital_step(*on_cpu, *rates, SGD_CHECK_STEPS)
    t_cpu = (time.perf_counter() - t0) / SGD_CHECK_STEPS * 1e3
    graph_err = float((graph_k - cpu_k).abs().max())
    eager_err = float((eager_k.cpu() - cpu_k).abs().max())
    moved = float((cpu_k - on_cpu[4]).abs().max())
    print(f"SGD step on fixed RDMs ({smi}): CUDA graph {timings['graph']:.4f} ms, eager on the "
          f"card {timings['eager']:.4f} ms, eager on the host CPU {t_cpu:.4f} ms per step; "
          f"{SGD_CHECK_STEPS} steps (k moved {moved:.3e}): |graph - CPU| {graph_err:.3e}, "
          f"|eager - CPU| {eager_err:.3e} (gate {TOL_SGD:.0e})", flush=True)
    checks = {
        "each outer iteration's energy within 1e-6 Ha of sqd_tpu's": len(energies)
        == len(recorded["iteration_energies"]) == OO["num_iters"] and all(
            abs(a - b) < TOL_OO_ENERGY for a, b in zip(energies, recorded["iteration_energies"])),
        "the final k_flat near sqd_tpu's": k_err < TOL_OO_K,
        "the last energy below the k = 0 start": energy < energies[0] and energy == energies[-1],
        "the kernel launched in every solve": len(probe.solves) == OO["num_iters"]
        and all(s["launches"] >= 1 for s in probe.solves),
        "rotate_integrals on the card equals the CPU's": rot_err < 1e-12,
        "the card's SGD steps equal the CPU's": graph_err < TOL_SGD and eager_err < TOL_SGD
        and moved > 1e-6,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"orbital optimization: {what}")
    return launches


def excited_phase(dev, smi, h1, eri, ecore, strs_a, strs_b, e_ground) -> None:
    """Phase 11 (b): the three lowest states at the headline strings."""
    import numpy as np
    import torch

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian

    with open(EXCITED_DATA) as f:
        recorded = json.load(f)
    runs = []

    def recorded_k(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            runs.append(out)
            return out
        return wrapper

    with Probe() as probe:
        probe.wrap(fermion, "davidson_lowest_k", recorded_k)
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        results = fermion.solve_sci_excited((strs_a, strs_b), h1, eri, 16, (5, 5),
                                            k=EXCITED_K, device=dev)
        sync()
        t_exc = time.perf_counter() - t0
    pad_to = tuple(-(-len(s) // 32) * 32 for s in (strs_a, strs_b))  # the solve's padding
    ham64 = build_sci_hamiltonian(bitpack.pack_ints(strs_a, 16), bitpack.pack_ints(strs_b, 16),
                                  h1, eri, 16, (5, 5), device=dev, pad_to=pad_to)
    energies = [r.energy for r in results]
    padded = []
    for r in results:
        vec = np.zeros(ham64.shape)
        vec[:len(strs_a), :len(strs_b)] = r.sci_state.amplitudes
        padded.append(vec)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(EXCITED_K) as pool:  # NumPy's products release the GIL
        host = list(pool.map(lambda vec: host_f64_energy(ham64, vec), padded))
    t_host = time.perf_counter() - t0
    vecs = np.stack([r.sci_state.amplitudes.ravel() for r in results])
    ortho = float(np.abs(vecs @ vecs.T - np.eye(EXCITED_K)).max())
    vs_host = max(abs(a - b) for a, b in zip(energies, host))
    vs_ref = max(abs(a - b) for a, b in zip(energies, recorded["energies"]))
    print(f"solve_sci_excited (k = {EXCITED_K}, 10^6 determinants, f64 block Davidson): "
          f"{t_exc:.3f} s, {runs[0].iterations} iterations, converged {runs[0].converged}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi}); energies "
          f"{[round(e + ecore, 10) for e in energies]} Ha; |E0 - solve_sci| "
          f"{abs(energies[0] - e_ground):.3e}, max |E - host f64| {vs_host:.3e}, max |E - sqd_tpu| "
          f"{vs_ref:.3e}, max |V V^T - I| {ortho:.3e} (host quotients {t_host:.1f} s)", flush=True)
    checks = {
        "the lowest energy within 1e-7 Ha of solve_sci's": abs(energies[0] - e_ground) < TOL_ENERGY,
        "each energy within 1e-7 Ha of its host f64 quotient": vs_host < TOL_ENERGY,
        "each energy within 1e-7 Ha of sqd_tpu's": len(energies) == len(recorded["energies"])
        and vs_ref < TOL_ENERGY,
        "the states orthonormal to 1e-8": ortho < 1e-8,
        "the energies ascending": energies == sorted(energies),
        "the block Davidson converged": len(runs) == 1 and runs[0].converged,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"excited states: {what}")


def augmentation_phase(dev, smi) -> None:
    """Phase 11 (c): every same-spin single excitation of phase 6's shots."""
    import numpy as np
    import torch

    from sqd_tpu_torch import fermion

    shots = loop_shots()
    norb = shots.shape[1] // 2
    ops = single_excitation_operators(norb)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    rows = fermion.enlarge_batch_from_transitions(shots, ops, device=dev)
    sync()
    t_aug = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_b, n_a = shots[:, :norb].sum(1), shots[:, norb:].sum(1)
    expected = int((n_b * (norb - n_b) + n_a * (norb - n_a)).sum())
    # the rows of the first shots, cut from each operator's block by the
    # legality that occupancies alone give, against the NumPy loop
    p_col = np.array([np.flatnonzero(op == "-")[0] for op in ops])
    q_col = np.array([np.flatnonzero(op == "+")[0] for op in ops])
    legal = (shots[:, p_col] & ~shots[:, q_col]).T  # (ops, shots)
    starts = np.concatenate([[0], np.cumsum(legal.sum(1))[:-1]])
    head = legal[:, :AUGMENT_CHECK_SHOTS].sum(1)
    picked = np.concatenate([rows[s:s + h] for s, h in zip(starts, head)])
    ref = excitation_rows_loop(shots[:AUGMENT_CHECK_SHOTS], ops)
    same = picked.shape == ref.shape and bool((picked == ref).all())
    print(f"enlarge_batch_from_transitions: {len(ops)} operators x {len(shots)} shots x "
          f"{shots.shape[1]} bits ({len(ops) * shots.size / 1e9:.2f} GB of bool rows) in "
          f"{t_aug:.3f} s, peak device memory {peak / 1e9:.2f} GB ({smi}); {len(rows)} legal rows "
          f"({expected} from occupancies); the first {AUGMENT_CHECK_SHOTS} shots' {len(ref)} rows "
          f"equal to the NumPy loop: {same}", flush=True)
    if not (rows.dtype == np.bool_ and rows.shape == (expected, shots.shape[1]) and same):
        fail("excitation augmentation disagrees with the occupancy count or the NumPy loop")


def resume_phase(dev, smi, h1, eri, ecore, uninterrupted, strs_a, strs_b, kernel_ms) -> int:
    """Phase 11 (d): phase 6's loop stopped after iteration 0 and resumed
    from its checkpoint, a state file round trip, and a traced solve.
    Returns the kernel's launches in the two loop runs."""
    import tempfile

    import numpy as np

    from sqd_tpu_torch import fermion
    from sqd_tpu_torch.ops import cross_spin
    from sqd_tpu_torch.primitives import BitArray
    from sqd_tpu_torch.utils.tracing import profile_trace

    shots = BitArray.from_bool_array(loop_shots())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop.npz")
        cross_spin.cross_spin_matvec.launches = 0
        sync()
        t0 = time.perf_counter()
        fermion.diagonalize_fermionic_hamiltonian(
            h1, eri, shots, norb=16, nelec=(5, 5), device=dev, checkpoint_path=path,
            **{**LOOP_SETTINGS, "max_iterations": 1})
        sync()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = fermion.diagonalize_fermionic_hamiltonian(
            h1, eri, shots, norb=16, nelec=(5, 5), device=dev, checkpoint_path=path,
            resume=True, **LOOP_SETTINGS)
        sync()
        t_resumed = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
        state_path = os.path.join(tmp, "state.npz")
        resumed.sci_state.save(state_path)
        loaded = fermion.SCIState.load(state_path, device=dev)
        rdm_err = float(np.abs(loaded.rdm(rank=1) - resumed.sci_state.rdm(rank=1)).max())
        trace_dir = os.path.join(tmp, "trace")
        with profile_trace(trace_dir):
            fermion.solve_sci((strs_a, strs_b), h1, eri, 16, (5, 5), device=dev)
            sync()
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "cross_spin_kernel" in e.get("name", "")]
    traced_ms = sum(e["dur"] for e in kernels) / max(len(kernels), 1) / 1e3
    same_strings = (list(resumed.sci_state.ci_strs_a) == list(uninterrupted.sci_state.ci_strs_a)
                    and list(resumed.sci_state.ci_strs_b)
                    == list(uninterrupted.sci_state.ci_strs_b))
    print(f"resumed loop ({smi}): iteration 0 with a checkpoint {t_first:.3f} s, resumed to "
          f"{LOOP_SETTINGS['max_iterations']} iterations {t_resumed:.3f} s, {launches} kernel "
          f"launches; best energy {resumed.energy + ecore:.12f} Ha, |E - uninterrupted| "
          f"{abs(resumed.energy - uninterrupted.energy):.3e}, same strings {same_strings}; "
          f"SCIState save/load: 1-RDM max|diff| {rdm_err:.3e}", flush=True)
    print(f"profile_trace of one headline solve_sci: {len(kernels)} cross_spin_kernel launches "
          f"in the Chrome trace, {traced_ms:.4f} ms each on the card (trace), against "
          f"{kernel_ms:.4f} ms from CUDA events in phase 3 ({smi})", flush=True)
    checks = {
        "the resumed best energy within 1e-9 Ha of the uninterrupted run's":
            abs(resumed.energy - uninterrupted.energy) < 1e-9,
        "the resumed best has the uninterrupted run's strings": same_strings,
        "the loaded state equals the saved one": bool(
            np.array_equal(loaded.amplitudes, resumed.sci_state.amplitudes)
            and list(loaded.ci_strs_a) == list(resumed.sci_state.ci_strs_a)
            and list(loaded.ci_strs_b) == list(resumed.sci_state.ci_strs_b)) and rdm_err < 1e-12,
        "the trace holds the cross-spin kernel": len(kernels) > 0,
        "the kernel launched in the loop's solves": launches > 0,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"checkpoint and tracing: {what}")
    return launches


TOL_TABLE_VAL = 1e-14  # relative to max|val|: same-spin values, device against native
TOL_TABLE_MATVEC = 1e-12  # relative to max(|sigma|, 1): one f64 matvec of each operator


def compare_tables(label, dev, smi, pa, pb, h1, eri, norb, nelec, **kwargs) -> dict:
    """Build the f64 operator with ``tables_backend="native"`` and
    ``"device"``, each warm and then twice on a synchronised host clock; fail
    unless the gather tables are equal bit for bit, the same-spin lists equal
    once the device's valid entries of value 0 are dropped (the native build
    keeps only values != 0: its compaction, applied to the device lists,
    gives its layout) with values within ``TOL_TABLE_VAL * max|val|``, and one
    f64 matvec of each within ``TOL_TABLE_MATVEC * max(|sigma|, 1)``; time one
    f32 matvec of each.  Returns both backends' seconds, the device build's
    chunks and peak, and the f32 matvec times."""
    import numpy as np
    import torch

    from sqd_tpu_torch import native
    from sqd_tpu_torch.ops import hamiltonian as ham_ops

    chunks = [0]
    candidates = ham_ops._samespin_candidates

    def counted(*args):
        chunks[0] += 1
        return candidates(*args)

    def build(backend):
        return ham_ops.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device=dev,
                                             tables_backend=backend, **kwargs)

    seconds = {"native": [], "device": []}
    ham_ops._samespin_candidates = counted
    try:
        for backend in ("native", "device"):
            build(backend)  # warm
        for _ in range(2):
            for backend in ("native", "device"):
                chunks[0] = 0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                sync()
                t0 = time.perf_counter()
                ham = build(backend)
                sync()
                seconds[backend].append(time.perf_counter() - t0)
                if backend == "device":
                    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                    chunks_per_spin = chunks[0] // 2
                del ham
    finally:
        ham_ops._samespin_candidates = candidates
    ham_n, ham_d = build("native"), build("device")
    gather_equal = all(torch.equal(getattr(ham_n, k), getattr(ham_d, k))
                       for k in ("src_a", "sign_a", "src_b", "sign_b"))
    idx_equal, val_err, val_scale = True, 0.0, 0.0
    for spin in "ab":
        idx_n = getattr(ham_n, f"nbr_idx_{spin}").cpu().numpy()
        val_n = getattr(ham_n, f"nbr_val_{spin}").cpu().numpy()
        idx_d, val_d = native.compact_neighbours(
            getattr(ham_d, f"nbr_idx_{spin}").cpu().numpy(),
            getattr(ham_d, f"nbr_val_{spin}").cpu().numpy())
        same = idx_d.shape == idx_n.shape and np.array_equal(idx_d, idx_n)
        idx_equal &= same
        if same:
            val_err = max(val_err, float(np.abs(val_d - val_n).max()))
        val_scale = max(val_scale, float(np.abs(val_n).max()))
    hd_equal = torch.equal(ham_n.hdiag, ham_d.hdiag)
    c = torch.as_tensor(np.random.default_rng(12).normal(size=ham_n.shape), device=dev)
    sig_n, sig_d = ham_n.matvec(c), ham_d.matvec(c)
    mv_err = float((sig_n - sig_d).abs().max())
    mv_bound = TOL_TABLE_MATVEC * max(float(sig_n.abs().max()), 1.0)
    # what the device lists' valid zero entries cost: one f32 matvec of each
    c32 = c.to(torch.float32)
    f32_ms = {}
    for backend, ham in (("native", ham_n), ("device", ham_d)):
        ham32 = ham.astype(torch.float32)
        f32_ms[backend] = float(np.median([event_ms(lambda: ham32.matvec(c32), 3)
                                           for _ in range(3)]))
    del ham32
    widths = (tuple(ham_n.nbr_idx_a.shape), tuple(ham_d.nbr_idx_a.shape))
    t_n, t_d = seconds["native"], seconds["device"]
    print(f"tables [{label}] operator {ham_n.shape}, npair {norb * norb}, "
          f"{pa.shape[1]}-word strings ({smi}): native {t_n[0]:.4f}, {t_n[1]:.4f} s; device "
          f"{t_d[0]:.4f}, {t_d[1]:.4f} s (warm, synchronised host clock); device same-spin "
          f"build {chunks_per_spin} row chunk(s) per spin, peak {peak:.3f} GB over the "
          f"operator's base; alpha lists native {widths[0]}, device {widths[1]}; gather "
          f"tables equal {gather_equal}, same-spin idx equal {idx_equal}, max|dval| "
          f"{val_err:.3e} (bound {TOL_TABLE_VAL * val_scale:.3e}), hdiag equal {hd_equal}, f64 "
          f"matvec max|diff| {mv_err:.3e} (bound {mv_bound:.3e}); one f32 matvec on the native "
          f"tables {f32_ms['native']:.4f} ms, on the device tables {f32_ms['device']:.4f} ms "
          f"(medians of 3 rounds of 3 calls, CUDA events)", flush=True)
    checks = {
        "gather tables equal bit for bit": gather_equal,
        "same-spin idx equal bit for bit": idx_equal,
        "same-spin values within 1e-14 max|val|": val_err <= TOL_TABLE_VAL * val_scale,
        "one f64 matvec of each within 1e-12": mv_err <= mv_bound,
        "the same diagonal": hd_equal,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"tables [{label}]: {what}")
    return {"native_s": t_n, "device_s": t_d, "chunks_per_spin": chunks_per_spin,
            "device_peak_gb": peak, "f32_matvec_ms": f32_ms}


def geometry_phase(dev, smi, e_casci) -> int:
    """Phase 12 (a): N2/6-31G from its geometry through the port's chemistry
    to the full CASCI.  Returns the kernel's launches in the solve."""
    import numpy as np
    import torch

    from sqd_tpu_torch import chem, fermion, native
    from sqd_tpu_torch.models.fcidump import read_fcidump
    from sqd_tpu_torch.ops import bitpack, cross_spin

    with open(CHEM_DATA) as f:
        record = json.load(f)["n2_631g"]
    dump = read_fcidump(DATA_STEM + ".fcidump")
    stages = {}
    t0 = time.perf_counter()
    mol = chem.Molecule(N2_ATOMS, basis="6-31g")
    ints = chem.ao_integrals(mol, backend="native")
    stages["AO integrals (native)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mf = chem.rhf(mol, integrals=ints)
    stages["RHF"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h1, eri, ecore = chem.active_space_integrals(mf, ncas=16, nelecas=10)
    stages["active space"] = time.perf_counter() - t0
    print(f"from geometry: N2/6-31G, {mol.nao} AOs: RHF {mf.e_tot:.12f} Ha (converged "
          f"{mf.converged}), |dE| to the sqd_tpu record {abs(mf.e_tot - record['rhf_e_tot']):.3e}; "
          f"CAS(16o,10e) ecore {ecore:.14f}, |d| to the FCIDUMP's "
          f"{abs(ecore - dump['ecore']):.3e}", flush=True)
    checks = {
        "RHF within 1e-8 Ha of the record": abs(mf.e_tot - record["rhf_e_tot"]) < TOL_CHEM,
        "ecore within 1e-8 Ha of the FCIDUMP's": abs(ecore - dump["ecore"]) < TOL_CHEM,
    }
    strs = all_strings(16, 5)
    packed = bitpack.pack_ints(strs, 16)
    # the FCIDUMP writer drops integrals the chemistry keeps as rounding, and
    # the native same-spin lists keep every value != 0
    widths = [native.samespin_tables(packed, a, b, 16, 5)[0].shape[1]
              for a, b in ((h1, eri), (dump["h1e"], dump["eri"]))]
    print(f"from geometry: {np.count_nonzero(np.abs(eri) < 1e-12)} of {eri.size} eri entries "
          f"below 1e-12 in magnitude ({np.count_nonzero(dump['eri'] == 0)} exactly 0 in the "
          f"FCIDUMP); native same-spin lists {widths[0]} wide ({widths[1]} on the FCIDUMP's "
          f"integrals)", flush=True)
    tables = compare_tables("casci", dev, smi, packed, packed, h1, eri, 16, (5, 5),
                            pad_to=(4384, 4384))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cross_spin.cross_spin_matvec.launches = 0
    sync()
    t0 = time.perf_counter()
    result = fermion.solve_sci((strs, strs), h1, eri, 16, (5, 5), device=dev)
    sync()
    stages["solve_sci"] = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    e_total = result.energy + ecore
    amps = result.sci_state.amplitudes
    print(f"from geometry: CASCI {len(strs) ** 2} determinants: energy {e_total:.12f} Ha, "
          f"|dE| to the published {abs(e_total - CASCI_ENERGY):.3e} (gate {TOL_CASCI:.0e}), to "
          f"phase 7's {abs(e_total - e_casci):.3e} (gate 1e-6); kernel launches {launches}; "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in stages.items())}; table builds native "
          f"{min(tables['native_s']):.3f} s, device {min(tables['device_s']):.3f} s; peak "
          f"device memory {peak:.2f} GB ({smi})", flush=True)
    checks.update({
        "the kernel launched in the f32 Davidson": launches > 0,
        "amplitudes (4368, 4368) and finite": amps.shape == (4368, 4368)
        and bool(np.isfinite(amps).all()),
        "energy within 2e-6 Ha of the published CASCI energy":
            abs(e_total - CASCI_ENERGY) < TOL_CASCI,
        "energy within 1e-6 Ha of phase 7's": abs(e_total - e_casci) < 1e-6,
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"from geometry: {what}")
    return launches


def open_shell_phase(dev, smi) -> None:
    """Phase 12 (c): BASELINE config 4's named systems, triplet CH2 and
    [2Fe-2S], through the port's open-shell chemistry."""
    import numpy as np

    from sqd_tpu_torch import chem, fermion
    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian

    with open(CHEM_DATA) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    ch2 = chem.Molecule(CH2_ATOMS, basis="sto-3g")
    ints = chem.ao_integrals(ch2, backend="native")
    ro = chem.rohf(ch2, spin=2, integrals=ints)
    u = chem.uhf(ch2, spin=2, integrals=ints)
    ref = record["ch2_sto3g_triplet"]
    diffs = {"ROHF": abs(ro.e_tot - ref["rohf_e_tot"]), "UHF": abs(u.e_tot - ref["uhf_e_tot"]),
             "UHF <S^2>": abs(u.spin_square - ref["uhf_spin_square"])}
    print(f"open shells: CH2 triplet ROHF {ro.e_tot:.12f}, UHF {u.e_tot:.12f} Ha, <S^2> "
          f"{u.spin_square:.9f}; against the record {', '.join(f'{k} {v:.3e}' for k, v in diffs.items())} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    checks = {f"CH2 {k} within 1e-8 of the record": v < TOL_CHEM for k, v in diffs.items()}

    ref = record["fe2s2_sto3g"]
    t0 = time.perf_counter()
    fe2s2 = chem.Molecule(FE2S2_ATOMS, basis="sto-3g")
    fe_ints = chem.ao_integrals(fe2s2, backend="native")
    t_int = time.perf_counter() - t0
    digests = integral_digests(fe_ints)
    worst = max(abs(digests[m][k] - ref["digests"][m][k]) / abs(ref["digests"][m][k])
                for m in digests for k in digests[m])
    t0 = time.perf_counter()
    mf = chem.rohf(fe2s2, integrals=fe_ints, **FE2S2_ROHF)
    t_rohf = time.perf_counter() - t0
    gap = abs(mf.e_tot - ref["rohf_e_tot"])
    ncas, nelecas = 6, (4, 2)
    h1, eri, ecore = chem.active_space_integrals(mf, ncas, nelecas)
    sa, sb = all_strings(ncas, nelecas[0]), all_strings(ncas, nelecas[1])
    t0 = time.perf_counter()
    res = fermion.solve_sci((sa, sb), h1, eri, ncas, nelecas, device=dev)
    t_solve = time.perf_counter() - t0
    ham = build_sci_hamiltonian(bitpack.pack_ints(sa, ncas), bitpack.pack_ints(sb, ncas),
                                h1, eri, ncas, nelecas, device=dev)
    e_host = host_f64_energy(ham, res.sci_state.amplitudes)
    print(f"open shells: [2Fe-2S]/STO-3G, {fe2s2.nao} AOs (d shells by the native kernel): "
          f"integrals {t_int:.2f} s, digests within {worst:.3e} relative of the record (gate "
          f"{TOL_DIGEST:.0e}); ROHF {FE2S2_ROHF['max_cycle']} cycles {t_rohf:.2f} s, "
          f"{mf.e_tot:.10f} Ha (converged {mf.converged}), |dE| to the record {gap:.3e} (gate "
          f"{TOL_FE2S2_ROHF:.0e}); CAS(6o,(4,2)) {len(sa) * len(sb)} determinants: solve_sci "
          f"{t_solve:.3f} s, energy {res.energy + ecore:.10f} Ha, |E - host f64| "
          f"{abs(res.energy - e_host):.3e} ({smi})", flush=True)
    checks.update({
        "[2Fe-2S] integral digests within 1e-10 relative": worst < TOL_DIGEST,
        "[2Fe-2S] ROHF within 1e-6 Ha of the record": gap < TOL_FE2S2_ROHF,
        "[2Fe-2S] CAS energy within 1e-7 Ha of host f64": abs(res.energy - e_host) < TOL_ENERGY
        and bool(np.isfinite(res.sci_state.amplitudes).all()),
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"open shells: {what}")


def parallel_phase(dev, smi, h1, eri, ecore, it0, t_loop, strs_a, strs_b, e_headline, e_casci,
                   e_dense5, rng) -> tuple[int, dict]:
    """Phase 13: the sharded solvers of ``sqd_tpu_torch.parallel``.  Returns
    the kernel's launches in (a) and its row-restricted case's times."""
    import dataclasses
    import functools

    import torch
    import torch.distributed as dist

    from sqd_tpu_torch import fermion, parallel
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops import hamiltonian as ham_ops
    from sqd_tpu_torch.parallel.dryrun import MODES, _free_port, dryrun_multichip
    from sqd_tpu_torch.primitives import BitArray

    norb, nelec = 16, (5, 5)
    with open(LOOP_DATA) as f:
        recorded = json.load(f)

    # -- the kernel on operands restricted to rank 0 of 2's rows at the CASCI:
    # 2192 output rows of a 4384-row c, sources past the output range
    t13 = time.perf_counter()
    casci_strs = all_strings(norb, nelec[0])
    casci_packed = bitpack.pack_ints(casci_strs, norb)
    ham32 = ham_ops.build_sci_hamiltonian(casci_packed, casci_packed, h1, eri, norb, nelec,
                                          device=dev, dtype=torch.float32, pad_to=(4384, 4384))
    m = ham32.shape[0]
    rows = slice(0, m // 2)
    shard = dataclasses.replace(ham32, src_a=ham32.src_a[:, rows], sign_a=ham32.sign_a[:, rows],
                                nbr_idx_a=ham32.nbr_idx_a[rows], nbr_val_a=ham32.nbr_val_a[rows],
                                hdiag=ham32.hdiag[rows])
    if not shard.cross_spin_operands().src_rows > m // 2:
        fail("parallel: the row-restricted operands read no row past their output rows")
    err = check_kernel("row_restricted", shard, rng, c_rows=m)
    timing = time_kernel("row_restricted", shard, rng, smi, rounds=3, calls=3, c_rows=m)
    timing["max_abs_err"] = err
    del ham32, shard
    torch.cuda.empty_cache()

    # -- (a) world size 1 over NCCL, wired through init_distributed ----------
    os.environ.update({"SQD_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                       "SQD_TPU_NUM_PROCESSES": "1", "SQD_TPU_PROCESS_ID": "0"})
    if not parallel.init_distributed():
        fail("parallel: init_distributed did not join the process group")
    if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
        fail(f"parallel: {dist.get_backend()} at world size {dist.get_world_size()}")
    launches_a = 0

    def run(fn):
        nonlocal launches_a
        cross_spin.cross_spin_matvec.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        launches = cross_spin.cross_spin_matvec.launches
        launches_a += launches
        return out, time.perf_counter() - t0, launches, torch.cuda.max_memory_allocated() / 1e9

    checks = {}
    batches = [(r.sci_state.ci_strs_a, r.sci_state.ci_strs_b) for r in it0]
    res, secs, launches, _ = run(lambda: parallel.solve_sci_batch_sharded(
        batches, h1, eri, norb, nelec, device=dev))
    d_batch = max(abs(r.energy - b.energy) for r, b in zip(res, it0))
    d_record = max(abs(r.energy - b["energy"]) for r, b in zip(res, recorded["batches"]))
    print(f"parallel (a) batch-sharded: {len(res)} batches {[r.sci_state.amplitudes.shape for r in res]}"
          f" in {secs:.3f} s, kernel launches {launches}; max |dE| against solve_sci_batch "
          f"{d_batch:.3e}, against the sqd_tpu record {d_record:.3e} Ha ({smi})", flush=True)
    checks["batch-sharded within 1e-7 Ha of solve_sci_batch and the record"] = (
        len(res) == len(it0) and d_batch < TOL_ENERGY and d_record < TOL_ENERGY)
    checks["batch-sharded launched the kernel"] = launches > 0

    history = []
    best, secs, launches, _ = run(lambda: fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, BitArray.from_bool_array(loop_shots()), norb=norb, nelec=nelec,
        callback=history.append, device=dev,
        sci_solver=functools.partial(parallel.solve_sci_batch_sharded, device=dev),
        **LOOP_SETTINGS))
    it0_strings = [
        (strings_digest(r.sci_state.ci_strs_a), strings_digest(r.sci_state.ci_strs_b))
        == (b["sha256_alpha"], b["sha256_beta"]) for r, b in zip(history[0], recorded["batches"])]
    print(f"parallel (a) loop through the seam: {len(history)} iterations in {secs:.3f} s (phase 6 "
          f"{t_loop:.3f} s), kernel launches {launches}, best energy {best.energy + ecore:.12f} "
          f"Ha; iteration 0 vs sqd_tpu: strings {it0_strings}", flush=True)
    checks["the loop's iteration 0 gives sqd_tpu's strings"] = (
        len(history[0]) == len(recorded["batches"]) and all(it0_strings))

    local, t_local, _, _ = run(lambda: fermion.solve_sci((strs_a, strs_b), h1, eri, norb, nelec,
                                                         device=dev))
    modes = {"pair (distributed)": parallel.solve_sci_distributed,
             "row": parallel.solve_sci_rowsharded, "grid": parallel.solve_sci_gridsharded}
    parts, mode_launches = [], {}
    for label, solve in modes.items():
        res, secs, mode_launches[label], peak = run(lambda: solve(
            (strs_a, strs_b), h1, eri, norb, nelec, device=dev, **HEADLINE_SHARDED))
        diff = abs(res.energy - e_headline)
        parts.append(f"{label} {secs:.3f} s, |dE| {diff:.3e}, launches {mode_launches[label]}, "
                     f"peak {peak:.2f} GB")
        checks[f"headline {label} within 1e-7 Ha of phase 5"] = diff < TOL_ENERGY
    # the row shards' f32 channel is the kernel; the pair and grid modes are torch ops
    checks["headline: the kernel in the row-sharded solve only"] = (
        mode_launches["row"] > 0 and mode_launches["pair (distributed)"] == 0
        and mode_launches["grid"] == 0)
    print(f"parallel (a) headline, 1000 x 1000 ({smi}): solve_sci {t_local:.3f} s (|dE| from "
          f"phase 5 {abs(local.energy - e_headline):.3e}); " + "; ".join(parts), flush=True)

    res, secs, launches, peak = run(lambda: parallel.solve_sci_rowsharded(
        (casci_strs, casci_strs), h1, eri, norb, nelec, device=dev, **CASCI_ROWSHARDED))
    e_total = res.energy + ecore
    print(f"parallel (a) CASCI row-sharded, {len(casci_strs) ** 2} determinants: {secs:.3f} s, "
          f"energy {e_total:.12f} Ha, |dE| published {abs(e_total - CASCI_ENERGY):.3e} (gate "
          f"{TOL_CASCI:.0e}), phase 7 {abs(e_total - e_casci):.3e} (gate 1e-7); kernel launches "
          f"{launches}, peak device memory {peak:.2f} GB ({smi})", flush=True)
    checks["CASCI row-sharded within 2e-6 Ha of the published energy"] = (
        abs(e_total - CASCI_ENERGY) < TOL_CASCI)
    checks["CASCI row-sharded within 1e-7 Ha of phase 7"] = abs(e_total - e_casci) < TOL_ENERGY
    checks["CASCI row-sharded launched the kernel"] = launches > 0
    del res
    torch.cuda.empty_cache()

    c5_h1, c5_eri, c5_strs = config5_problem()
    res, secs, launches, peak = run(lambda: parallel.solve_sci_dfsharded(
        (c5_strs, c5_strs), c5_h1, c5_eri, CONFIG5["norb"], CONFIG5["nelec"], device=dev,
        **CONFIG5_SOLVER))
    diff = abs(res.energy - e_dense5)
    print(f"parallel (a) config 5 factor-sharded: {secs:.3f} s, |dE| from phase 10's dense route "
          f"{diff:.3e} (gate {TOL_DF_SHARDED:.0e}), kernel launches {launches}, peak device "
          f"memory {peak:.2f} GB ({smi})", flush=True)
    checks["config 5 factor-sharded within 1e-6 Ha of phase 10's dense route"] = (
        diff < TOL_DF_SHARDED)
    del res
    dist.destroy_process_group()
    for name in ("SQD_TPU_COORDINATOR", "SQD_TPU_NUM_PROCESSES", "SQD_TPU_PROCESS_ID"):
        del os.environ[name]
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t13

    # -- (c) the dry run on every card (NCCL); (b) two ranks on the one card (gloo)
    t0 = time.perf_counter()
    one = dryrun_multichip(torch.cuda.device_count())
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    # every mode: gloo serves all their collectives for CUDA tensors in the
    # card's torch 2.11 (probes/torch_gloo_cuda_collectives.py)
    two = dryrun_multichip(2, backend="gloo")
    t_b = time.perf_counter() - t0
    diffs = {}
    for key in ("local", *MODES):
        ref = one[0][key][0] if key == "batch" else one[0][key]
        diffs[key] = max(abs((r[key][0] if key == "batch" else r[key]) - ref) for r in two)
    print(f"parallel (b) two ranks on {smi} over gloo against (c)'s one: "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
          + f" Ha (gate {TOL_WORLDS:.0e}); (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s",
          flush=True)
    for key, diff in diffs.items():
        checks[f"two ranks' {key} within 1e-8 Ha of one rank's"] = diff < TOL_WORLDS
    for what, ok in checks.items():
        if not ok:
            fail(f"parallel: {what}")
    return launches_a, timing


def bench_qubit_phase(dev, smi, e_gather5) -> None:
    """Phase 15: ``bench_torch.py``'s sections 4 and 5 at full size, their
    grouped matvecs held to :func:`pauli_host_energy`; then its section 6,
    config 5's segmented dense-DF solve, held to phase 10's gather-route
    energy ``e_gather5``."""
    import torch

    import bench_torch
    from sqd_tpu_torch.ops import cross_spin
    from sqd_tpu_torch.ops.pauli_proj import pauli_apply_flat

    sections = (("88-term grouped projection", bench_torch.multiterm_section, 1_000_000),
                ("66-term Heisenberg projection", bench_torch.heisenberg_section, 49_718))
    for name, section, d in sections:
        cross_spin.cross_spin_matvec.launches = 0
        sync()
        t0 = time.perf_counter()
        detail, run = section(dev)
        sync()
        secs = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
        v = run.vector
        hv = pauli_apply_flat(run.proj, v)
        e_card = float(torch.dot(v, hv) / torch.dot(v, v))
        e_host = pauli_host_energy(run.ints, run.op.paulis, run.op.coeffs, v.cpu().numpy())
        rel = abs(e_card - e_host) / abs(e_host)
        timings = ", ".join(f"{k} {val:.4f} s" for k, val in detail.items() if k.endswith("seconds"))
        print(f"bench {name}, d = {detail['dim']}, {detail['terms']} terms ({smi}): {timings}; "
              f"section {secs:.2f} s; checksum {detail['checksum']!r}; {run.proj.num_groups} "
              f"x-groups; <v|H|v>/<v|v> {e_card:.12f} on the card, {e_host:.12f} on the host "
              f"(relative {rel:.3e}, gate {TOL_BENCH_QUBIT:.0e}); kernel launches {launches}",
              flush=True)
        checks = {
            f"d = {d}": detail["dim"] == d,
            "88 terms in 23 x-groups": detail["terms"] == 88 and run.proj.num_groups == 23,
            "the grouped matvec's quotient within 1e-9 of the host's": rel < TOL_BENCH_QUBIT,
            "no cross-spin kernel on the qubit path": launches == 0,
        }
        for what, ok in checks.items():
            if not ok:
                fail(f"bench {name}: {what}")
        del detail, run, v, hv
        torch.cuda.empty_cache()

    # section 6: the f32 dense-DF solve in segments (a warm-up, then the timed one)
    cross_spin.cross_spin_matvec.launches = 0
    with Probe() as probe:
        probe.count_segments()
        sync()
        t0 = time.perf_counter()
        detail = bench_torch.config5_section(dev)
        sync()
        secs = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    timed = probe.segments[len(probe.segments) // 2:]
    gap = abs(detail["energy_f64_eval"] - e_gather5)
    print(f"bench config 5, {detail['dim']} determinants ({smi}): table build "
          f"{detail['table_build_seconds']:.3f} s, densify {detail['densify_seconds']:.3f} s, "
          f"solve {detail['solve_seconds']:.3f} s (section {secs:.2f} s); "
          f"{detail['iterations']} iterations in {len(timed)} segments {timed}, residual "
          f"{detail['residual_norm']:.3e}; energy_f64_eval {detail['energy_f64_eval']:.10f} Ha, "
          f"|E - theta| {detail['f64_eval_vs_theta_abs']:.3e} (gate "
          f"{bench_torch.TOL_CONFIG5:.0e}), |E - phase 10's gather route| {gap:.3e} (gate "
          f"{TOL_BENCH_CONFIG5:.0e}); kernel launches {launches}", flush=True)
    checks = {
        "converged (residual below tol 1e-4)": detail["residual_norm"] < 1e-4,
        "fewer than 200 iterations": detail["iterations"] < 200,
        "f64 energy within 5e-3 Ha of the Ritz value":
            detail["f64_eval_vs_theta_abs"] < bench_torch.TOL_CONFIG5,
        "f64 energy within 1e-6 Ha of phase 10's gather route": gap < TOL_BENCH_CONFIG5,
        "the timed solve's segments sum to its iterations": sum(timed) == detail["iterations"],
        "no cross-spin kernel on the dense route": launches == 0,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"bench config 5: {what}")
    del detail
    torch.cuda.empty_cache()


def examples_phase(dev, smi) -> tuple[dict, float]:
    """Phase 14 (a): every port example at its guide size on the card, with
    the port's own recovery noise.  Its ``exact`` and ``time`` lines must
    equal the ``sqd_tpu`` record (``tools/make_example_records.py``) by
    ``records.compare`` (numbers within 1e-7), its printed variational
    energies lie no lower than its printed exact energy less 1e-8 Ha, and its
    own asserts hold.  Returns each example's seconds, and ``13``'s energy."""
    import tempfile

    from sqd_tpu_torch.examples import records

    recorded = records.load_records()
    seconds, energy13 = {}, None
    for name in records.EXAMPLES:
        module = records.load_example(name)
        cwd = os.getcwd()
        sync()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # where an example writes files
            try:
                lines, results = records.run_calls(module, records.SIZES[name]["guide"],
                                                   device=dev, **records.PORT_KWARGS.get(name, {}))
            except Exception as exc:  # an assert of the example, or an error
                fail(f"example {name} failed on the card: {type(exc).__name__}: {exc}")
            finally:
                os.chdir(cwd)
        sync()
        seconds[name] = time.perf_counter() - t0
        if name == "13_large_active_space":
            energy13 = results[0]
        rec = recorded[name]["guide"]["lines"]
        errors = records.compare(name, rec, lines, all_lines=False)
        errors += records.variational_violations(name, lines)
        kinds = records.classify(name, lines)
        print(f"example {name}: {seconds[name]:.2f} s on {smi}; {len(lines)} lines, "
              f"{kinds.count('exact')} exact and {kinds.count('time')} timing lines held to the "
              f"record (numbers within {records.TOL:.0e}), {kinds.count('loop')} on the loop's "
              f"noise; asserts and variational bound held", flush=True)
        if errors:
            print("\n".join(lines), flush=True)
            fail(f"example {name} disagrees with the sqd_tpu record: {errors[:5]}")
    return seconds, energy13


def example_kernel_phase(dev, smi, rng, energy13) -> tuple[int, dict]:
    """Phase 14 (b): the inputs of example 13 (``problem()``: 36 orbitals,
    two-word strings, 24 x 24) by ``solve_sci``'s gather route in f32, which
    must launch the kernel and land within 1e-7 Ha of the example's f64
    energy; the kernel against its plain version on that operator, timed.
    Returns the launches and the timing."""
    import numpy as np
    import torch

    from sqd_tpu_torch.examples import records
    from sqd_tpu_torch.fermion import solve_sci
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian

    h1, eri, sa, sb, norb, nelec = records.load_example("13_large_active_space").problem()
    cross_spin.cross_spin_matvec.launches = 0
    sync()
    t0 = time.perf_counter()
    res = solve_sci((sa, sb), h1, eri, norb, nelec, spin_sq=None, solver_dtype=torch.float32,
                    device=dev)
    sync()
    secs = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    diff = abs(res.energy - energy13)
    print(f"example 13 by the f32 gather route: E = {res.energy:.10f} in {secs:.3f} s, kernel "
          f"launches {launches}; |E - the example's f64 energy| {diff:.3e} (gate "
          f"{TOL_ENERGY:.0e}); 2-RDM finite {bool(np.isfinite(res.rdm2).all())} ({smi})",
          flush=True)
    if launches == 0 or diff > TOL_ENERGY or not np.isfinite(res.rdm2).all():
        fail("example 13's f32 solve: no kernel launch, or its energy is off")
    pad = -(-len(sa) // 32) * 32  # solve_sci's pad_bucket
    ham32 = build_sci_hamiltonian(bitpack.pack_ints(sa, norb), bitpack.pack_ints(sb, norb), h1,
                                  eri, norb, nelec, device=dev, pad_to=(pad, pad),
                                  dtype=torch.float32)
    err = check_kernel("example13", ham32, rng)
    timing = time_kernel("example13", ham32, rng, smi)
    timing["max_abs_err"] = err
    return launches, timing


def table_kernels_phase(dev, smi, shapes) -> dict:
    """Phase 3b: ``card_tables.build_tables`` against the native host build
    at each of ``shapes`` (label -> ``(packed_a, packed_b, h1, eri, norb,
    nelec)``).  Fails unless its eight tables, and ``gather_tables``' two of
    each spin, equal the native ones with ``torch.equal``; returns, per
    shape, the kernels' device time per build, the native build's time and
    the kernels' bound."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from sqd_tpu_torch import native
    from sqd_tpu_torch.ops import card_tables

    def host(pa, pb, h1, eri, norb, nelec):
        out = []
        for p in (pa, pb):
            src, sign = native.gather_tables(p, norb)
            out += [torch.from_numpy(src).to(torch.int64), torch.from_numpy(sign)]
        for p, ne in ((pa, nelec[0]), (pb, nelec[1])):
            idx, val = native.samespin_tables(p, h1, eri, norb, ne)
            out += [torch.from_numpy(idx).to(torch.int64), torch.from_numpy(val)]
        return out

    def same(got, want):
        return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g.cpu(), w)
                   for g, w in zip(got, want))

    records = {}
    for label, (pa, pb, h1, eri, norb, nelec) in shapes.items():
        def card():
            return card_tables.build_tables(pa, pb, h1, eri, norb, nelec, device=dev)

        want = host(pa, pb, h1, eri, norb, nelec)
        got = card()
        gathers = [t for p in (pa, pb) for t in card_tables.gather_tables(p, norb, device=dev)]
        equal, gather_equal = same(got, want), same(gathers, want[:4])
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            host(pa, pb, h1, eri, norb, nelec)
            host_s.append(time.perf_counter() - t0)
        card_s = []
        for _ in range(10):
            sync()
            t0 = time.perf_counter()
            card()
            sync()
            card_s.append(time.perf_counter() - t0)
        builds = 5
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(builds):
                card()
            sync()
        kernel_ms = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and (
                    "gather_kernel" in e.key or "samespin_kernel" in e.key):
                name = "count" if "<false>" in e.key else "fill" if "<true>" in e.key else "gather"
                kernel_ms[name] = e.self_device_time_total / 1e3 / builds
        ms = sum(kernel_ms.values())
        # the least bytes: the keys, the slot tables and the integrals read
        # once, the eight tables written once
        n = pa.shape[0] + pb.shape[0]
        read = 8 * n + 8 * (norb**2 + norb**4) + sum(
            4 * native.samespin_width(norb, ne) for ne in nelec)
        written = sum(t.numel() * t.element_size() for t in got)
        bound_ms = (read + written) / PEAK_HBM_BYTES * 1e3
        widths = (int(got[4].shape[1]), int(got[6].shape[1]))
        records[label] = {
            "shape": [int(pa.shape[0]), int(pb.shape[0]), norb, int(pa.shape[1])],
            "widths": list(widths), "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": float(np.median(host_s)) * 1e3, "card_s": float(np.median(card_s)),
            "bound_ms": bound_ms, "bound_by": "bytes", "equal": equal and gather_equal,
        }
        print(f"table kernels [{label}] {pa.shape[0]} x {pb.shape[0]} strings of {norb} "
              f"orbitals, {pa.shape[1]}-word, nelec {tuple(nelec)}, lists {widths} wide "
              f"({smi}): tables equal to the native build {equal}, gather_tables equal "
              f"{gather_equal}; kernels {ms:.4f} ms a build ("
              + ", ".join(f"{k} {v:.4f}" for k, v in kernel_ms.items())
              + f"; torch.profiler, {builds} builds), the build {np.median(card_s) * 1e3:.3f} ms "
              f"(synchronised host clock, median of 10), native {np.median(host_s) * 1e3:.2f} ms "
              f"(median of 3); bound {bound_ms:.5f} ms by bytes "
              f"({(read + written) / 1e6:.3f} MB at 3.35 TB/s), kernels at "
              f"{bound_ms / ms if ms else 0.0:.2%} of it", flush=True)
        if not (equal and gather_equal):
            fail(f"table kernels [{label}]: the card's tables differ from the native build's")
        if not kernel_ms:
            fail(f"table kernels [{label}]: the profiler saw no table kernel")
    return records


def main() -> None:
    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    sys.path.insert(0, ROOT)
    try:
        from sqd_tpu_torch import build, native
    except ImportError as exc:
        fail(f"the sqd_tpu_torch package is not beside this script ({exc})")
    from sqd_tpu_torch.fermion import solve_sci
    from sqd_tpu_torch.models.fcidump import read_fcidump
    from sqd_tpu_torch.ops import bitpack, card_tables, cross_spin
    from sqd_tpu_torch.ops.davidson import davidson_ground_state, davidson_initial_guess
    from sqd_tpu_torch.ops.hamiltonian import (
        build_sci_hamiltonian, pivoted_cholesky_pairs, sci_matvec_flat,
    )
    from sqd_tpu_torch.ops.precision import highest_precision

    # -- 2. build ----------------------------------------------------------
    with ThreadPoolExecutor(3) as pool:  # g++ and nvcc side by side
        for job in [pool.submit(native.load), pool.submit(cross_spin._kernel_library),
                    pool.submit(card_tables._library)]:
            job.result()
    print(
        f"build: g++ sqdcore {build.build_seconds['sqdcore']:.2f} s, "
        f"nvcc cross_spin_matvec (sm_90a) {build.build_seconds['cross_spin_matvec']:.2f} s, "
        f"nvcc sci_tables (sm_90a) {build.build_seconds['sci_tables']:.2f} s",
        flush=True,
    )

    # -- 3. kernel vs plain ------------------------------------------------
    dump = read_fcidump(DATA_STEM + ".fcidump")
    with open(DATA_STEM + ".json") as f:
        recorded = json.load(f)
    h1, eri, ecore = dump["h1e"], dump["eri"], dump["ecore"]
    norb, nelec = 16, (5, 5)
    strs_a = excitation_strings(1000, norb, nelec[0], 1)
    strs_b = excitation_strings(1000, norb, nelec[1], 2)
    pa, pb = bitpack.pack_ints(strs_a, norb), bitpack.pack_ints(strs_b, norb)
    ham64 = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device=dev, pad_to=(1024, 1024))
    ham32 = ham64.astype(torch.float32)
    rng = np.random.default_rng(0)
    small_a = pa[np.sort(rng.choice(1000, 37, replace=False))]
    small_b = pb[np.sort(rng.choice(1000, 45, replace=False))]
    # N2/cc-pVDZ over 28 orbitals (phase 8's integrals): a 1000 x 1000 batch
    # of excitation strings, npair 784.  sqd_tpu's "auto" rank cap (784 // 3)
    # declines to factor these integrals (rank 365 at 1e-13), so the factor
    # is computed uncapped and passed explicitly, here and in phase 8.
    dump28 = read_fcidump(CCPVDZ_STEM + ".fcidump")
    h1_28, eri_28 = dump28["h1e"], dump28["eri"]
    factor_28 = pivoted_cholesky_pairs(eri_28, 28)
    if factor_28 is None:
        fail("no pivoted-Cholesky factor of the cc-pVDZ integrals")
    ham28 = build_sci_hamiltonian(
        bitpack.pack_ints(excitation_strings(1000, 28, 7, 3), 28),
        bitpack.pack_ints(excitation_strings(1000, 28, 7, 4), 28),
        h1_28, eri_28, 28, (7, 7), device=dev, pad_to=(1024, 1024), eri_factor=factor_28,
    ).astype(torch.float32)
    cases = {
        "headline": ham32,
        "ragged": build_sci_hamiltonian(
            small_a, small_b, h1, eri, norb, nelec, device=dev, dtype=torch.float32),
        "spin_penalty": build_sci_hamiltonian(
            small_a, small_b, h1, eri, norb, nelec, device=dev, dtype=torch.float32,
            spin_shift=0.35, spin_target=2.0, pad_to=(40, 48)),
        # every beta string of the sector (4368, padded to 4480) against the
        # headline's alpha strings (up to 36 valid pairs): several k tiles
        "wide": build_sci_hamiltonian(
            pa, bitpack.pack_ints(all_strings(norb, nelec[1]), norb), h1, eri, norb, nelec,
            device=dev, dtype=torch.float32),
        # 37 x 45 strings padded to 256 x 512: most rows and columns are empty
        "sparse": build_sci_hamiltonian(
            small_a, small_b, h1, eri, norb, nelec, device=dev, dtype=torch.float32,
            pad_to=(256, 512)),
        # the headline with 320-column k tiles and 96-row rs tiles
        "tiled": ham32,
        # the 28-orbital batch at npair 784, with plan()'s tiles, and with
        # 256-column k tiles and 184-row rs tiles forced
        "ccpvdz": ham28,
        "ccpvdz_tiled": ham28,
    }
    forced = {"tiled": (320, 96), "ccpvdz_tiled": (256, 184)}
    errs = {}
    for name, ham in cases.items():
        errs[name] = check_kernel(name, ham, rng, forced.get(name))
        if name in ("wide", "tiled", "ccpvdz_tiled"):
            ops = ham.cross_spin_operands()
            n, npair = ham.shape[1], ops.eri.shape[0]
            tiles = forced.get(name) or cross_spin.plan(
                n, npair, cross_spin.row_stride(ops.ka_pq.shape[1]))
            if -(-n // tiles[0]) < 2 or (name == "ccpvdz_tiled" and -(-npair // tiles[1]) < 2):
                fail(f"the {name} case should take several tiles")
    del cases

    headline = time_kernel("headline", ham32, rng, smi)
    c = torch.as_tensor(rng.normal(size=ham32.shape), dtype=torch.float32, device=dev)
    matvec_ms = [event_ms(lambda: ham32.matvec(c)) for _ in range(20)]
    print(f"f32 matvec at {tuple(c.shape)}: {float(np.median(matvec_ms)):.4f} ms "
          f"(medians of 20 rounds of 10 calls, CUDA events)", flush=True)
    ccpvdz = time_kernel("ccpvdz", ham28, rng, smi, rounds=5)
    # one f32 matvec at npair 784 by each route: the kernel (matvec) and the
    # Cholesky-factored contraction (_matvec_full with the factor attached)
    c28 = torch.as_tensor(rng.normal(size=ham28.shape), dtype=torch.float32, device=dev)
    with highest_precision():
        by_kernel, by_factor = ham28.matvec(c28), ham28._matvec_full(c28)
        route_err = float((by_kernel - by_factor).abs().max())
        route_tol = TOL_KERNEL * max(float(by_factor.abs().max()), 1.0)
        kernel_route = [event_ms(lambda: ham28.matvec(c28), 5) for _ in range(5)]
        factor_route = [event_ms(lambda: ham28._matvec_full(c28), 5) for _ in range(5)]
    print(f"f32 matvec at {tuple(c28.shape)}, npair 784 ({smi}): kernel route "
          f"{float(np.median(kernel_route)):.4f} ms, factored route (rank "
          f"{factor_28.shape[0]}) {float(np.median(factor_route)):.4f} ms (medians of 5 rounds "
          f"of 5 calls, CUDA events); routes differ by {route_err:.3e} (bound {route_tol:.3e})",
          flush=True)
    if route_err > route_tol:
        fail("the kernel and factored f32 matvecs disagree at npair 784")
    del ham28, c28, by_kernel, by_factor
    # both blocked f64 variants against the unblocked dense route on the
    # headline operator forced to col_block 128, bare and with the spin penalty
    c64 = torch.as_tensor(rng.normal(size=ham64.shape), dtype=torch.float64, device=dev)
    for label, spin in (("bare", {}), ("spin_penalty", {"spin_shift": 0.35, "spin_target": 2.0})):
        blocked = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device=dev,
                                        pad_to=(1024, 1024), col_block=128, **spin)
        full = blocked._matvec_dense(c64)
        scale = max(float(full.abs().max()), 1.0)
        line = [f"f64 _matvec_dense {np.median([event_ms(lambda: blocked._matvec_dense(c64), 3) for _ in range(3)]):.3f} ms"]
        for name in BLOCKED_VARIANTS:
            diff = float((getattr(blocked, name)(c64) - full).abs().max())
            ms = np.median([event_ms(lambda: getattr(blocked, name)(c64), 3) for _ in range(3)])
            line.append(f"{name.split('__')[-1]} {ms:.3f} ms, max|diff| {diff:.3e}")
            if diff > 1e-12 * scale:
                fail(f"{name} disagrees with _matvec_dense ({label})")
        print(f"blocked f64 matvecs [{label}] at {tuple(c64.shape)}, col_block 128 ({smi}): "
              f"{'; '.join(line)} (bound {1e-12 * scale:.3e}; medians of 3 rounds of 3 calls)",
              flush=True)
    del blocked, full, c64
    torch.cuda.empty_cache()
    # -- 3c. the f64 kernel ---------------------------------------------------
    f64_kernel = f64_kernel_phase(dev, smi, rng, ham64)

    # -- 3b. the table kernels against the native build ----------------------
    h26, eri26 = h1_28[2:, 2:].copy(), eri_28[2:, 2:, 2:, 2:].copy()  # the frozen-core cell's
    casci_packed = bitpack.pack_ints(all_strings(norb, nelec[0]), norb)
    h5, eri5, strs5 = config5_problem()
    p5 = bitpack.pack_ints(strs5, CONFIG5["norb"])
    c17 = bitpack.pack_ints(all_strings(17, 5), 17)
    tables = table_kernels_phase(dev, smi, {
        "headline": (pa, pb, h1, eri, norb, nelec),
        "ccpvdz_26o": (bitpack.pack_ints(excitation_strings(1000, 26, 5, 1), 26),
                       bitpack.pack_ints(excitation_strings(1000, 26, 5, 2), 26),
                       h26, eri26, 26, (5, 5)),
        "ccpvdz_28o": (bitpack.pack_ints(excitation_strings(1000, 28, 7, 3), 28),
                       bitpack.pack_ints(excitation_strings(1000, 28, 7, 4), 28),
                       h1_28, eri_28, 28, (7, 7)),
        "casci": (casci_packed, casci_packed, h1, eri, norb, nelec),
        "config5": (p5, p5, h5, eri5, CONFIG5["norb"], CONFIG5["nelec"]),
        "c17_all": (c17, c17, h1_28[2:19, 2:19].copy(), eri_28[2:19, 2:19, 2:19, 2:19].copy(),
                    17, (5, 5)),
    })
    del casci_packed, h5, eri5, strs5, p5, c17

    # -- 4. Davidson on the headline operator --------------------------------
    hd32 = ham32.hdiag.reshape(-1)
    sync()
    t0 = time.perf_counter()
    v0 = davidson_initial_guess(hd32, torch.float32)
    res = davidson_ground_state(
        sci_matvec_flat, ham32, hd32, v0, tol=1e-3, max_subspace=24, max_iterations=200)
    sync()
    t_dav = time.perf_counter() - t0
    print(f"davidson f32: {res.iterations} iterations, residual {res.residual_norm:.3e}, "
          f"theta {res.theta + ecore:.10f} Ha, {t_dav:.3f} s", flush=True)
    if not res.converged:
        fail("the f32 Davidson did not converge on the headline operator")

    # -- 5. the slice: solve_sci on the headline problem ---------------------
    table_launches = {}  # phase -> [build_tables, gather_tables] launches in it

    def took(phase):
        table_launches[phase] = [card_tables.build_tables.launches,
                                 card_tables.gather_tables.launches]
        card_tables.build_tables.launches = card_tables.gather_tables.launches = 0

    card_tables.build_tables.launches = card_tables.gather_tables.launches = 0
    cross_spin.cross_spin_matvec.launches = cross_spin.cross_spin_matvec_f64.launches = 0
    with Probe() as probe:  # records any column-blocked f64 matvec
        sync()
        t0 = time.perf_counter()
        result = solve_sci((strs_a, strs_b), h1, eri, norb, nelec, device="cuda")
        sync()
        t_solve = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    f64_launches = cross_spin.cross_spin_matvec_f64.launches
    took("5")
    amps = result.sci_state.amplitudes
    vec = np.zeros(ham64.shape)
    vec[: amps.shape[0], : amps.shape[1]] = amps
    e_host = host_f64_energy(ham64, vec)
    occ_a, occ_b = result.orbital_occupancies
    print(f"solve_sci: energy {result.energy + ecore:.12f} Ha, kernel launches {launches}, "
          f"f64 kernel launches {f64_launches}, f64 blocked variants "
          f"{sorted(set(probe.variants))}, "
          f"{t_solve:.3f} s; |E - host f64| {abs(result.energy - e_host):.3e}, "
          f"|E - sqd_tpu| {abs(result.energy - recorded['energy']):.3e}", flush=True)
    checks = {
        "kernel launched during the solve": launches > 0,
        "the f64 refinement and energy ran the f64 kernel, no blocked matvec":
            f64_launches > 0 and not probe.variants,
        "the card built the solve's tables once": table_launches["5"][0] == 1,
        "amplitudes (1000, 1000) and finite": amps.shape == (1000, 1000)
        and bool(np.isfinite(amps).all()),
        "occupancies sum to (5, 5)": abs(occ_a.sum() - 5) < 1e-8 and abs(occ_b.sum() - 5) < 1e-8,
        "rdm1/rdm2 finite": bool(np.isfinite(result.rdm1).all() and np.isfinite(result.rdm2).all()),
        "energy vs host f64": abs(result.energy - e_host) < TOL_ENERGY,
        "energy vs sqd_tpu": abs(result.energy - recorded["energy"]) < TOL_ENERGY,
    }
    for what, ok in checks.items():
        if not ok:
            fail(what)
    del ham32, ham64
    # the headline operator by both table builds (phase 12 (b))
    compare_tables("headline", dev, smi, pa, pb, h1, eri, norb, nelec, pad_to=(1024, 1024))
    took("5 tables by 'native' and 'device'")

    # -- 6. the SQD loop; 7. the full CASCI; 8. the cc-pVDZ loop -------------
    loop_launches, loop_best, loop_it0, t_loop, loop_f64_launches = sqd_loop_phase(
        dev, smi, h1, eri, ecore)
    took("6")
    casci_launches, casci_f64_launches, casci, casci_err, e_casci = casci_phase(
        dev, smi, h1, eri, ecore, rng)
    took("7")
    ccpvdz_launches, ccpvdz_f64_launches = ccpvdz_phase(dev, smi, factor_28)
    took("8")
    ccpvdz["max_abs_err"] = errs["ccpvdz"]

    # -- 9. the qubit path (no kernel of its own: torch ops and host C++) ----
    t0 = time.perf_counter()
    projection_phase(dev, smi)
    qubit_solve_phase(dev, smi)
    qubit_k_phase(dev, smi)
    print(f"qubit path: {time.perf_counter() - t0:.1f} s", flush=True)
    took("9")

    # -- 10. BASELINE config 5 by the gather and the dense density-fitted route
    t0 = time.perf_counter()
    config5_launches, config5, config5_err, e_dense5, e_gather5 = dense_df_phase(dev, smi, rng)
    print(f"config 5: {time.perf_counter() - t0:.1f} s", flush=True)
    took("10")

    # -- 11. the rest of the fermion API: orbital optimization, excited
    # states, excitation augmentation, a resumed loop and a traced solve
    t11 = [time.perf_counter()]
    oo_launches = oo_phase(dev, smi, h1, eri, ecore)
    t11.append(time.perf_counter())
    excited_phase(dev, smi, h1, eri, ecore, strs_a, strs_b, result.energy)
    t11.append(time.perf_counter())
    augmentation_phase(dev, smi)
    t11.append(time.perf_counter())
    resume_launches = resume_phase(dev, smi, h1, eri, ecore, loop_best, strs_a, strs_b,
                                   headline["ms"])
    t11.append(time.perf_counter())
    took("11")
    parts = ", ".join(f"({part}) {b - a:.1f} s" for part, a, b in zip("abcd", t11, t11[1:]))
    print(f"fermion API: {t11[-1] - t11[0]:.1f} s: {parts}; the script so far "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)

    # -- 12. from geometry: the port's chemistry to the full CASCI, with the
    # device-built tables against the native ones; the open-shell systems
    t12 = [time.perf_counter()]
    geometry_launches = geometry_phase(dev, smi, e_casci)
    t12.append(time.perf_counter())
    open_shell_phase(dev, smi)
    t12.append(time.perf_counter())
    took("12")
    print(f"from geometry: {t12[-1] - t12[0]:.1f} s: (a) {t12[1] - t12[0]:.1f} s, (c) "
          f"{t12[2] - t12[1]:.1f} s; the script {time.perf_counter() - T_START:.1f} s", flush=True)

    # -- 13. the sharded solvers: world size 1 over NCCL, two ranks on the one
    # card over gloo, the dry run
    t0 = time.perf_counter()
    parallel_launches, row_restricted = parallel_phase(
        dev, smi, h1, eri, ecore, loop_it0, t_loop, strs_a, strs_b, result.energy, e_casci,
        e_dense5, rng)
    print(f"sharded solvers: {time.perf_counter() - t0:.1f} s; the script "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)
    took("13")

    # -- 14. the sixteen guide examples at their guide sizes; example 13's
    # inputs in f32 through the kernel
    t14 = [time.perf_counter()]
    example_seconds, energy13 = examples_phase(dev, smi)
    t14.append(time.perf_counter())
    example_launches, example13 = example_kernel_phase(dev, smi, rng, energy13)
    t14.append(time.perf_counter())
    took("14")
    slowest = max(example_seconds, key=example_seconds.get)
    print(f"examples: {t14[2] - t14[0]:.1f} s: (a) {t14[1] - t14[0]:.1f} s (slowest {slowest} "
          f"{example_seconds[slowest]:.1f} s), (b) {t14[2] - t14[1]:.1f} s; the script "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)

    # -- 15. bench_torch.py's qubit sections at full size, against the host;
    # its config-5 section, against phase 10
    t0 = time.perf_counter()
    bench_qubit_phase(dev, smi, e_gather5)
    print(f"bench sections: {time.perf_counter() - t0:.1f} s; the script "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)
    took("15")
    print(f"table kernels' launches by phase ([build_tables, gather_tables]): "
          f"{table_launches}", flush=True)
    # phase 6's solves build none (checked there): its one build is the
    # operator of the best result's host quotient
    if table_launches["7"][0] < 1:
        fail("the card table builds by phase: none in phase 7's CASCI")

    print(json.dumps({"kernels": [{
        "name": "cross_spin_matvec",
        "route": "cuda",
        "source": "sqd_tpu_torch/csrc/cross_spin_matvec.cu",
        "replaces": "sqd_tpu/ops/pallas_matvec.py:167",
        "launches": launches,
        "launches_sqd_loop": loop_launches,
        "launches_casci": casci_launches,
        "launches_ccpvdz_loop": ccpvdz_launches,
        "launches_config5_gather": config5_launches,
        "launches_orbital_optimization": oo_launches,
        "launches_resumed_loop": resume_launches,
        "launches_from_geometry": geometry_launches,
        "launches_sharded_solvers": parallel_launches,
        "launches_examples": example_launches,
        "max_abs_err": max(*errs.values(), casci_err, config5_err, row_restricted["max_abs_err"],
                           example13["max_abs_err"]),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this contraction
        "at_shapes": {"ccpvdz": ccpvdz, "casci": casci, "config5": config5,
                      "row_restricted": row_restricted, "example13": example13},
    }, {
        "name": "cross_spin_matvec_f64",
        "route": "cuda",
        "source": "sqd_tpu_torch/csrc/cross_spin_matvec.cu",
        "replaces": None,  # sqd_tpu sends f64 to XLA's dense route
        "launches": f64_launches,
        "launches_sqd_loop": loop_f64_launches,
        "launches_casci": casci_f64_launches,
        "launches_ccpvdz_loop": ccpvdz_f64_launches,
        "max_abs_err": max(t["max_abs_err"] for t in f64_kernel.values()),
        "ms": f64_kernel["headline"]["ms"],
        "plain_ms": f64_kernel["headline"]["plain_ms"],
        "bound_ms": f64_kernel["headline"]["bound_ms"],
        "bound_by": f64_kernel["headline"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this contraction
        "at_shapes": f64_kernel,
    }, {
        "name": "sci_tables",
        "route": "cuda",
        "source": "sqd_tpu_torch/csrc/sci_tables.cu",
        "kernels": ["gather_kernel", "samespin_kernel<false>", "samespin_kernel<true>"],
        "replaces": None,  # sqd_tpu builds these tables on the host or as XLA ops
        "plain": "native.gather_tables and native.samespin_tables (host, one thread)",
        "launches": table_launches["5"][0],
        "launches_by_phase": table_launches,
        "equal": all(r["equal"] for r in tables.values()),
        "ms": tables["headline"]["ms"],
        "plain_ms": tables["headline"]["plain_ms"],
        "bound_ms": tables["headline"]["bound_ms"],
        "bound_by": tables["headline"]["bound_by"],
        "library_ms": None,  # no library call builds these tables
        "at_shapes": tables,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
