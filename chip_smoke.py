#!/usr/bin/env python3
# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Smoke run of ``sqd_tpu_torch`` on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:

1. device — needs CUDA; prints ``nvidia-smi``'s name and power limit;
2. build — compiles the native host library (g++, ``csrc/sqdcore.cpp``) and
   the cross-spin CUDA kernel (nvcc, sm_90a, ``csrc/cross_spin_matvec.cu``)
   from the sources in the checkout, both at once;
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
   route, and both column-blocked f64 matvecs against ``_matvec_full`` on
   the headline operator forced to ``col_block`` 128, bare and with the
   spin penalty, within ``1e-12 * max(|full|, 1)``;
4. Davidson — the f32 solver on the headline operator (``bench.py``'s
   settings: tol 1e-3, max_subspace 24, 200 iterations) must converge;
5. slice — ``sqd_tpu_torch.fermion.solve_sci`` on the bench headline problem
   (N2/6-31G CAS(16o,(5,5)e), 1000 x 1000 excitation strings, integrals from
   the committed FCIDUMP); the kernel must be launched during the solve, and
   the energy must lie within 1e-7 Ha of a host-f64 Rayleigh quotient of the
   returned amplitudes and of the ``sqd_tpu`` energy recorded beside the
   FCIDUMP;
6. SQD loop — ``sqd_tpu_torch.fermion.diagonalize_fermionic_hamiltonian`` on
   the same integrals with 200,000 shots (:func:`loop_shots`) and
   ``LOOP_SETTINGS`` (3 iterations of 3 batches of ~950 x 950 strings, the
   default solver with a fresh ``TableCache``).  Iteration 0 must give the
   strings and, within 1e-7 Ha, the energies that ``sqd_tpu`` recorded
   (``tools/make_sqd_loop_data.py``); the best energy must lie within
   1e-7 Ha of a host-f64 Rayleigh quotient of its amplitudes; every batch
   solve must run in f32 (above 200k determinants) and launch the kernel;
   the table cache must have reused rows.  Prints each iteration's seconds
   in recovery, subsampling, table builds and solves;
7. CASCI — ``solve_sci`` with its defaults on all C(16,5) = 4368 strings per
   spin of the same problem (19,079,424 determinants, padded to 4384 x 4480,
   ``col_block`` 128): first the kernel against its plain version, and
   timed, on that operator; then the solve must launch the kernel (f32
   Davidson), run a column-blocked f64 matvec (refinement and energy), and
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
   occupancies sum to (7, 7); every batch solve must build the sparse
   same-spin tables, a column-blocked operator with the factor attached,
   launch the kernel and run a blocked f64 matvec;
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
   f32 then an f64 Davidson, the energy within 1e-7 of a NumPy host-f64
   Rayleigh quotient (:func:`pauli_host_energy`) and within 1e-6 of the
   ``sqd_tpu`` record ``sqd_tpu_torch/data/qubit_heisenberg26_1e7.json``
   (``tools/make_qubit_data.py``); one f32 and one f64 matvec timed beside
   their byte bound; (c) ``solve_qubit_device(k=3)`` on a 20-site ring with
   a Dzyaloshinskii-Moriya term (complex128) and on the real ring, over 2e5
   strings (seed 8), within 1e-7 of ``solve_qubit(k=3, which="SA")`` with
   orthonormal columns.  This path reaches no Pallas kernel in ``sqd_tpu``,
   so it has no CUDA kernel and no entry in the kernels' record;
10. dense density-fitted solve — BASELINE config 5, ``bench.py``'s (54e,36o)
   problem made here from its seed (:func:`config5_problem`: 36 orbitals,
   27 + 27 electrons, synthetic PSD integrals of rank 108, the same 3163
   two-word excitation strings for both spins, 10,004,569 determinants,
   padded 3168 x 3200, npair 1296).  (a) the operator: ``eri_factor="auto"``
   must attach the factor and the sparse same-spin tables must be built;
   the kernel against its plain version at this shape, then timed beside
   its bound; (b) ``DenseDFOperator.matvec`` (f32, ``wb`` aliasing ``wa``)
   against the kernel-route f32 matvec and both against the f64 blocked
   matvec (the kernel route within ``1e-5 * max(|f64|, 1)``, the dense
   route, three f32 products in a row, within ``1e-4`` of it); one matvec of each route timed
   beside its bound (dense: ``4 X P^3`` FLOPs at the f32 rate, P the common
   padded width), with ``x_chunk`` 8 and the whole stack; ``densify``'s
   seconds, the W-stack bytes and the peak memory; (c) ``solve_sci`` with
   ``CONFIG5_SOLVER`` by ``matvec_strategy="gather"`` (must launch the
   kernel) and ``"dense_df"`` (must launch none): each energy within 1e-7 Ha
   of :func:`device_f64_energy` (the host quotient transcribed to torch f64
   on the card, from the tables alone), the two within 1e-3 Ha, both
   Davidsons converged; and both routes on the first 512 strings per spin
   within 1e-7 Ha of the NumPy :func:`host_f64_energy`, which the device
   quotient must also meet there.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_STEM = os.path.join(ROOT, "sqd_tpu_torch", "data", "n2_631g_cas16o_5a5b")
TOL_KERNEL = 1e-5  # relative to max(|plain|, 1): f32 sums in another order
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
CONFIG5 = {"norb": 36, "nelec": (27, 27), "strings": 3163, "rank": 108,
           "integral_seed": 7, "string_seed": 1}
CONFIG5_SOLVER = {"tol": 1e-4, "max_subspace": 12, "max_cycle": 200,  # bench.py's
                  "with_rdms": False, "refine_iterations": 0}
CONFIG5_SUB = 512  # strings per spin of the sub-shape held against the NumPy quotient
TOL_ROUTES = 1e-3  # Ha between the two routes' energies (both stop at tol 1e-4)
# the dense f32 matvec relative to max(|f64|, 1): three f32 products in a row,
# each entry a sum over X * P = 108 * 3200 terms
TOL_DENSE = 1e-4
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes per second


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def excitation_strings(count, norb, n_elec, seed):
    """HF determinant + a random walk of low-order excitations (as ``bench.py``)."""
    import numpy as np

    r = np.random.default_rng(seed)
    hf = (1 << n_elec) - 1
    seen = {hf}
    frontier = [hf]
    while len(seen) < count:
        base = frontier[r.integers(len(frontier))] if frontier else hf
        occ = [p for p in range(norb) if (base >> p) & 1]
        virt = [p for p in range(norb) if not (base >> p) & 1]
        o = occ[r.integers(len(occ))]
        v = virt[r.integers(len(virt))]
        new = base ^ (1 << o) ^ (1 << v)
        if new not in seen:
            seen.add(new)
            frontier.append(new)
            if len(frontier) > 64:
                frontier.pop(0)
    return np.array(sorted(seen), dtype=np.int64)


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


def config5_problem(count=CONFIG5["strings"]):
    """``bench.py``'s BASELINE config 5 from its seeds: ``(h1, eri, strings)``
    for 36 orbitals and 27 electrons per spin, with a near-diagonal ``h1``,
    PSD ``eri`` from a random symmetric factor of rank 108, and ``count``
    excitation strings (int64, ascending) that serve both spins."""
    import numpy as np

    norb, rank = CONFIG5["norb"], CONFIG5["rank"]
    rng = np.random.default_rng(CONFIG5["integral_seed"])
    h1 = np.diag(np.linspace(-14.0, 4.0, norb)) + 0.05 * rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(rank, norb, norb)) * (0.5 / np.sqrt(rank))
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    strs = excitation_strings(count, norb, CONFIG5["nelec"][0], CONFIG5["string_seed"])
    return h1, eri, strs


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


def host_f64_energy(ham, vec, row_block=32) -> float:
    """True f64 Rayleigh quotient <c|H|c>/<c|c> in NumPy from the operator's
    own tables (as ``bench.py``'s ``_host_f64_energy``), the opposite-spin
    pair Gram accumulated over blocks of ``row_block`` alpha rows (at 28
    orbitals the whole Gram's operands would take 12 GB of host memory)."""
    import numpy as np

    m, n = ham.shape
    c = np.asarray(vec, np.float64).reshape(m, n)
    c = c / np.linalg.norm(c)
    src_a = ham.src_a.cpu().numpy()
    sign_a = ham.sign_a.cpu().numpy().astype(np.float64)
    src_b = ham.src_b.cpu().numpy()
    sign_b = ham.sign_b.cpu().numpy().astype(np.float64)
    eri_t = ham.eri_t.cpu().numpy().astype(np.float64)
    npair = eri_t.shape[0]
    pab = np.zeros((npair, npair))
    for i0 in range(0, m, row_block):
        rows = slice(i0, i0 + row_block)
        # pairs with no valid entry in these rows contribute nothing
        live = np.flatnonzero(np.any(sign_a[:, rows] != 0, axis=1))
        d_a = (sign_a[live, rows, None] * c[src_a[live, rows]]).reshape(len(live), -1)
        d_b = np.swapaxes(np.take(c[rows], src_b, axis=1), 0, 1) * sign_b[:, None, :]
        pab[live] += d_a @ d_b.reshape(npair, -1).T
        del d_a, d_b
    e = float(np.sum(eri_t * pab.T))
    gram_r = c @ c.T
    gram_c = c.T @ c
    idx_a = ham.nbr_idx_a.cpu().numpy()
    val_a = ham.nbr_val_a.cpu().numpy().astype(np.float64)
    e += float(np.sum(val_a * gram_r[idx_a, np.arange(m)[:, None]]))
    idx_b = ham.nbr_idx_b.cpu().numpy()
    val_b = ham.nbr_val_b.cpu().numpy().astype(np.float64)
    e += float(np.sum(val_b * gram_c[idx_b, np.arange(n)[:, None]]))
    return e


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


def check_kernel(name, ham, rng, tiles=None) -> float:
    """The kernel against its plain version on random amplitudes; returns
    the largest difference and fails past ``TOL_KERNEL * max(|plain|, 1)``."""
    import torch

    from sqd_tpu_torch.ops import cross_spin

    ops = ham.cross_spin_operands()
    m, n = ham.shape
    npair = ops.eri.shape[0]
    if tiles is None:
        tiles = cross_spin.plan(n, npair, cross_spin.row_stride(ops.ka_pq.shape[1]))
    c = torch.as_tensor(rng.normal(size=ham.shape), dtype=torch.float32, device=ham.src_a.device)
    out = cross_spin.cross_spin_matvec(c, ops, tiles=tiles)
    sync()
    ref = cross_spin.cross_spin_plain(c, ops)
    err = float((out - ref).abs().max())
    bound = TOL_KERNEL * max(float(ref.abs().max()), 1.0)
    finite = bool(torch.isfinite(out).all())
    empty = (int((ops.ka_n == 0).sum()), int((ops.kb_n == 0).sum()))
    print(f"kernel vs plain [{name}] shape {(m, n)} npair {npair} ka {ops.ka_pq.shape[1]} "
          f"kb {ops.kb_rs.shape[1]}, empty rows/cols {empty}, tiles (cols, rs) {tiles}: "
          f"{-(-n // tiles[0])} k x {-(-npair // tiles[1])} rs: "
          f"max|diff| {err:.3e} (bound {bound:.3e})", flush=True)
    if not finite or err > bound:
        fail(f"cross_spin_matvec disagrees with its plain version on {name}")
    return err


def time_kernel(label, ham, rng, smi, rounds=10, calls=10) -> dict:
    """Median per-call times of the kernel and its plain version (in turns:
    plain, kernel, kernel, plain) and the kernel's bound, at ``ham``'s shape."""
    import numpy as np
    import torch

    from sqd_tpu_torch.ops import cross_spin

    ops = ham.cross_spin_operands()
    c = torch.as_tensor(rng.normal(size=ham.shape), dtype=torch.float32, device=ham.src_a.device)
    m, n = ham.shape
    npair = ops.eri.shape[0]

    def run_kernel():
        cross_spin.cross_spin_matvec(c, ops)

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
    moved = [c, c, ops.ka_n, ops.ka_pq, ops.ka_src, ops.ka_sgn,
             ops.kb_n, ops.kb_rs, ops.kb_src, ops.kb_sgn, ops.eri]
    nbytes = float(sum(t.numel() * t.element_size() for t in moved))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    print(f"timing [{label}] at {(m, n)}, npair {npair} ({smi}): kernel {t_kernel:.4f} ms, "
          f"plain {t_plain:.4f} ms (per call: medians of {2 * rounds} rounds of {calls} calls, "
          f"CUDA events)", flush=True)
    print(f"bound [{label}]: {flops / 1e9:.4f} GFLOP at 67 TFLOP/s = {t_ops:.5f} ms, "
          f"{nbytes / 1e6:.3f} MB at 3.35 TB/s = {t_bytes:.5f} ms; bound {bound_ms:.5f} ms "
          f"by {bound_by}; kernel at {bound_ms / t_kernel:.2%} of it "
          f"({flops / t_kernel / 1e9:.3f} TFLOP/s)", flush=True)
    return {"shape": [m, n, npair], "ms": t_kernel, "plain_ms": t_plain,
            "bound_ms": bound_ms, "bound_by": bound_by}


STEPS = ("postselect", "recovery", "recovery on the device", "subsampling",
         "table builds + upload", "solves (tables included)")
SOLVE_STAGES = ("host tables", "densify", "f32 Davidson", "f64 refinement", "RDMs",
                "two-hole tables (device, in RDMs)", "f64 energy")
BLOCKED_VARIANTS = ("_SCIHamiltonian__matvec_blocked",
                    "_SCIHamiltonian__matvec_blocked_beta_first_rowmajor")


class Probe:
    """Wrappers around functions the port calls, for one phase: seconds per
    step (each wrapper synchronises the card before and after), and per batch
    solve its subspace, kernel launches, blocked-matvec variants, the
    operators it built (``col_block``, an attached factor) and the sparse
    same-spin table fills.  Restores everything on exit."""

    def __init__(self):
        self.spans: list[dict] = [{}]
        self.solves: list[dict] = []
        self.builds: list[dict] = []
        self.variants: list[str] = []
        self.sparse_fills = 0
        self.davidson: list[tuple[str, int]] = []  # (stage, iterations) of each call
        self.davidson_runs: list[dict] = []  # converged, kernel launches of each call
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
        from sqd_tpu_torch.ops import cross_spin
        from sqd_tpu_torch.ops.hamiltonian import SCIHamiltonian

        def counted_solve(fn):
            def wrapper(ci_strings, *args, **kwargs):
                launches, builds = cross_spin.cross_spin_matvec.launches, len(self.builds)
                variants, fills = len(self.variants), self.sparse_fills
                davidson = len(self.davidson)
                out = fn(ci_strings, *args, **kwargs)
                self.solves.append({
                    "davidson": self.davidson[davidson:],
                    "shape": (len(ci_strings[0]), len(ci_strings[1])),
                    "launches": cross_spin.cross_spin_matvec.launches - launches,
                    "builds": self.builds[builds:],
                    "variants": sorted(set(self.variants[variants:])),
                    "sparse_fills": self.sparse_fills - fills,
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
        the RDMs with their two-hole tables, and the f64 energy."""
        from sqd_tpu_torch import fermion, native
        from sqd_tpu_torch.ops import cross_spin, linktab
        from sqd_tpu_torch.ops import rdm as rdm_ops

        self.timed(native, "gather_tables", "host tables")
        self.timed(native, "samespin_tables", "host tables")
        self.timed(rdm_ops, "make_rdms", "RDMs")
        self.timed(linktab, "build_desdes_tables", "two-hole tables (device, in RDMs)")
        self.timed(fermion, "expectation_value", "f64 energy")
        self.timed(fermion, "densify", "densify")

        def davidson_stage(fn):
            def wrapper(matvec, operator, hdiag, v0, **kwargs):
                stage = "f32 Davidson" if v0.dtype.itemsize == 4 else "f64 refinement"
                launches = cross_spin.cross_spin_matvec.launches
                sync()
                t0 = time.perf_counter()
                out = fn(matvec, operator, hdiag, v0, **kwargs)
                sync()
                self.spans[-1][stage] = self.spans[-1].get(stage, 0.0) + time.perf_counter() - t0
                self.davidson.append((stage, out.iterations))
                self.davidson_runs.append({
                    "converged": out.converged, "residual": out.residual_norm,
                    "launches": cross_spin.cross_spin_matvec.launches - launches})
                return out
            return wrapper

        self.wrap(fermion, "davidson_ground_state", davidson_stage)

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


def sqd_loop_phase(dev, smi, h1, eri, ecore) -> int:
    """Phase 6: the SQD loop at full width.  Returns the kernel's launches in it."""
    import numpy as np

    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu_torch.primitives import BitArray

    with open(LOOP_DATA) as f:
        recorded = json.load(f)
    norb, nelec = 16, (5, 5)
    probe, best, _, launches, checks = run_loop(
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
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"sqd loop: {what}")
    return launches


def casci_phase(dev, smi, h1, eri, ecore, rng) -> tuple[int, dict, float]:
    """Phase 7: the full N2/6-31G CASCI (C(16,5)^2 = 19,079,424 determinants)
    through ``solve_sci`` with its defaults.  Returns the kernel's launches in
    the solve, its times at this shape and its largest difference from the
    plain version."""
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
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        result = fermion.solve_sci((strs, strs), h1, eri, norb, nelec, device=dev)
        sync()
        t_solve = time.perf_counter() - t0
        launches = cross_spin.cross_spin_matvec.launches
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
          f"solve_sci {t_solve:.3f} s, kernel launches {launches}, peak device memory "
          f"{peak:.2f} GB ({smi})", flush=True)
    print(f"casci: energy {e_total:.12f} Ha, published {CASCI_ENERGY:.12f} Ha, "
          f"|dE| {abs(e_total - CASCI_ENERGY):.3e} (gate {TOL_CASCI:.0e})", flush=True)
    checks = {
        "the kernel launched in the f32 Davidson": launches > 0,
        "col_block > 0": build["col_block"] > 0,
        "the f64 refinement ran the blocked matvec": bool(probe.variants),
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
    return launches, timing, err


def ccpvdz_phase(dev, smi, factor) -> int:
    """Phase 8: BASELINE config 3, the SQD loop on N2/cc-pVDZ over all 28
    orbitals.  Returns the kernel's launches in it."""
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
          f"operators {[b for s in probe.solves for b in s['builds']]}, sparse same-spin fills "
          f"{[s['sparse_fills'] for s in probe.solves]}, f64 blocked variants "
          f"{[s['variants'] for s in probe.solves]}, Davidson (stage, iterations) "
          f"{[s['davidson'] for s in probe.solves]}", flush=True)
    checks.update({
        "every batch above 877 strings per spin (sparse same-spin tables)": all(
            min(s["shape"]) > 877 for s in probe.solves),
        "every batch solve filled sparse same-spin tables": all(
            s["sparse_fills"] >= 2 for s in probe.solves),
        "every batch operator has col_block > 0 and an attached eri_chol": all(
            len(s["builds"]) == 1 and s["builds"][0]["col_block"] > 0
            and s["builds"][0]["eri_chol"] for s in probe.solves),
        "every batch f64 refinement ran a blocked matvec": all(
            s["variants"] for s in probe.solves),
        "sub-batch energy within 1e-7 Ha of sqd_tpu's": sub_diff < TOL_ENERGY,
        "best energy vs host f64": abs(best.energy - e_host) < TOL_ENERGY,
        "best occupancies sum to (7, 7)": abs(occ_a.sum() - 7) < 1e-8
        and abs(occ_b.sum() - 7) < 1e-8,
        "best energy below RHF": best.energy + ecore < recorded["rhf_energy"],
    })
    for what, ok in checks.items():
        if not ok:
            fail(f"ccpvdz loop: {what}")
    return launches


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
    davidson: list[tuple[str, int]] = []
    probe = Probe()
    probe.timed(qubit, "build_projected_operator", "operator build")
    probe.timed(pauli_proj, "_pair_cols", "membership (pairing sorts)")

    def stage(fn):
        def wrapper(matvec, operator, hdiag, v0, **kwargs):
            name = "f32 Davidson" if v0.dtype.itemsize == 4 else "f64 Davidson"
            sync()
            t0 = time.perf_counter()
            out = fn(matvec, operator, hdiag, v0, **kwargs)
            sync()
            probe.spans[-1][name] = time.perf_counter() - t0
            davidson.append((name, out.iterations))
            return out
        return wrapper

    probe.wrap(qubit, "davidson_ground_state", stage)
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
          + f"; Davidson (stage, iterations) {davidson}; peak device memory {peak:.2f} GB "
          f"({smi})", flush=True)
    print(f"qubit solve: energy {energy:.12f}, |E - host f64| {abs(energy - e_host):.3e} "
          f"(host quotient {t_host:.2f} s), |E - sqd_tpu| {abs(energy - recorded['energy']):.3e} "
          f"(sqd_tpu {recorded['energy']:.12f})", flush=True)
    checks = {
        "packed weights and the group loop": proj.packed_weights and proj.scan_matvec,
        "membership by the pairing sorts": "membership (pairing sorts)" in span,
        "the recorded group count": proj.num_groups == recorded["num_groups"],
        "operator bytes equal the estimate": proj.memory_bytes == estimate,
        "an f32 stage and an f64 stage ran": [s for s, _ in davidson] == ["f32 Davidson",
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


def dense_df_phase(dev, smi, rng) -> tuple[int, dict, float]:
    """Phase 10: BASELINE config 5 by the gather route and the dense
    density-fitted route.  Returns the kernel's launches in the gather solve,
    its times at this shape and its largest difference from the plain
    version."""
    import dataclasses

    import numpy as np
    import torch

    from sqd_tpu_torch import fermion, native
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops import hamiltonian as ham_ops
    from sqd_tpu_torch.ops.dense_df import densify

    norb, nelec = CONFIG5["norb"], CONFIG5["nelec"]
    h1, eri, strs = config5_problem()
    packed = bitpack.pack_ints(strs, norb)
    pad = -(-len(strs) // 32) * 32  # solve_sci's pad_bucket

    # -- (a) the operator, and the kernel at npair 1296 -----------------------
    with Probe() as probe:
        sync()
        t0 = time.perf_counter()
        ham64 = ham_ops.build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device=dev,
                                              pad_to=(pad, pad))
        sync()
        t_build = time.perf_counter() - t0
    ham32 = ham64.astype(torch.float32)
    m, n = ham64.shape
    rank = None if ham64.eri_chol is None else ham64.eri_chol.shape[0]
    # why (c) passes with_rdms=False: the same-spin 2-RDMs' two-hole tables
    two_hole = len(native.desdes_unique(packed, nelec[0]))
    print(f"config 5: {len(strs)} x {len(strs)} = {len(strs) ** 2} determinants of {norb} "
          f"orbitals, {packed.shape[1]}-word strings, operator {(m, n)}, npair {norb * norb}, "
          f"col_block {ham64.col_block}, eri_factor 'auto' rank {rank}, same-spin lists "
          f"{tuple(ham64.nbr_idx_a.shape)} ({probe.sparse_fills} sparse fills), {two_hole} "
          f"two-hole intermediates per spin (an int64 (npair, K) table of "
          f"{norb * norb * two_hole * 8 / 1e9:.1f} GB, so no 2-RDM here); build "
          f"{t_build:.3f} s ({smi})", flush=True)
    checks = {
        "two-word strings": packed.shape[1] == 2,
        "'auto' attached a factor of rank <= npair // 3": rank is not None
        and rank <= norb * norb // 3,
        "the sparse same-spin tables were built": probe.sparse_fills >= 2,
        "padded to (3168, 3200) with a column block": (m, n) == (3168, 3200)
        and ham64.col_block > 0,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"config 5: {what}")
    err = check_kernel("config5", ham32, rng)
    timing = time_kernel("config5", ham32, rng, smi, rounds=3, calls=3)
    timing["max_abs_err"] = err

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
        "kernel-route f32 vs blocked f64": (float((by_kernel - ref).abs().max()),
                                            TOL_KERNEL * scale),
        "dense f32 vs blocked f64": (float((by_dense - ref).abs().max()), TOL_DENSE * scale),
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
              f"{seconds:.3f} s; {stages}; Davidson {probe.davidson}, converged "
              f"{run['converged']}, residual {run['residual']:.3e}, kernel launches in it "
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
    return results["gather"][1], timing, err


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
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops.davidson import davidson_ground_state, davidson_initial_guess
    from sqd_tpu_torch.ops.hamiltonian import (
        build_sci_hamiltonian, pivoted_cholesky_pairs, sci_matvec_flat,
    )
    from sqd_tpu_torch.ops.precision import highest_precision

    # -- 2. build ----------------------------------------------------------
    with ThreadPoolExecutor(2) as pool:  # g++ and nvcc side by side
        for job in [pool.submit(native.load), pool.submit(cross_spin._kernel_library)]:
            job.result()
    print(
        f"build: g++ sqdcore {build.build_seconds['sqdcore']:.2f} s, "
        f"nvcc cross_spin_matvec (sm_90a) {build.build_seconds['cross_spin_matvec']:.2f} s",
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
    # both blocked f64 variants against _matvec_full on the headline operator
    # forced to col_block 128, bare and with the spin penalty
    c64 = torch.as_tensor(rng.normal(size=ham64.shape), dtype=torch.float64, device=dev)
    for label, spin in (("bare", {}), ("spin_penalty", {"spin_shift": 0.35, "spin_target": 2.0})):
        blocked = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device=dev,
                                        pad_to=(1024, 1024), col_block=128, **spin)
        full = blocked._matvec_full(c64)
        scale = max(float(full.abs().max()), 1.0)
        line = [f"f64 _matvec_full {np.median([event_ms(lambda: blocked._matvec_full(c64), 3) for _ in range(3)]):.3f} ms"]
        for name in BLOCKED_VARIANTS:
            diff = float((getattr(blocked, name)(c64) - full).abs().max())
            ms = np.median([event_ms(lambda: getattr(blocked, name)(c64), 3) for _ in range(3)])
            line.append(f"{name.split('__')[-1]} {ms:.3f} ms, max|diff| {diff:.3e}")
            if diff > 1e-12 * scale:
                fail(f"{name} disagrees with _matvec_full ({label})")
        print(f"blocked f64 matvecs [{label}] at {tuple(c64.shape)}, col_block 128 ({smi}): "
              f"{'; '.join(line)} (bound {1e-12 * scale:.3e}; medians of 3 rounds of 3 calls)",
              flush=True)
    del blocked, full, c64
    torch.cuda.empty_cache()

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
    cross_spin.cross_spin_matvec.launches = 0
    sync()
    t0 = time.perf_counter()
    result = solve_sci((strs_a, strs_b), h1, eri, norb, nelec, device="cuda")
    sync()
    t_solve = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    amps = result.sci_state.amplitudes
    vec = np.zeros(ham64.shape)
    vec[: amps.shape[0], : amps.shape[1]] = amps
    e_host = host_f64_energy(ham64, vec)
    occ_a, occ_b = result.orbital_occupancies
    print(f"solve_sci: energy {result.energy + ecore:.12f} Ha, kernel launches {launches}, "
          f"{t_solve:.3f} s; |E - host f64| {abs(result.energy - e_host):.3e}, "
          f"|E - sqd_tpu| {abs(result.energy - recorded['energy']):.3e}", flush=True)
    checks = {
        "kernel launched during the solve": launches > 0,
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

    # -- 6. the SQD loop; 7. the full CASCI; 8. the cc-pVDZ loop -------------
    loop_launches = sqd_loop_phase(dev, smi, h1, eri, ecore)
    casci_launches, casci, casci_err = casci_phase(dev, smi, h1, eri, ecore, rng)
    ccpvdz_launches = ccpvdz_phase(dev, smi, factor_28)
    ccpvdz["max_abs_err"] = errs["ccpvdz"]

    # -- 9. the qubit path (no kernel of its own: torch ops and host C++) ----
    t0 = time.perf_counter()
    projection_phase(dev, smi)
    qubit_solve_phase(dev, smi)
    qubit_k_phase(dev, smi)
    print(f"qubit path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 10. BASELINE config 5 by the gather and the dense density-fitted route
    t0 = time.perf_counter()
    config5_launches, config5, config5_err = dense_df_phase(dev, smi, rng)
    print(f"config 5: {time.perf_counter() - t0:.1f} s", flush=True)

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
        "max_abs_err": max(*errs.values(), casci_err, config5_err),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this contraction
        "at_shapes": {"ccpvdz": ccpvdz, "casci": casci, "config5": config5},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
