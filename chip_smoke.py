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
   have no valid pair) and the headline with small tiles forced on both the
   k and the rs axis, within ``1e-5 * max(|plain|, 1)``; median times of
   both at the headline shape from CUDA events, the kernel's bound (the
   larger of its FLOPs at the f32 rate and its bytes at the HBM rate,
   counted from the operands) and one f32 matvec's time;
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
   in recovery, subsampling, table builds and solves.

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


def loop_shots(n_shots=LOOP_SHOTS, seed=5):
    """Phase 6's samples: an ``(n_shots, 32)`` bool matrix, rows ``[b_15..b_0, a_15..a_0]``.

    80 % are (alpha, beta) pairs drawn uniformly from the headline string sets
    (samples concentrated near the HF determinant), 20 % uniform random bits
    that configuration recovery has to repair.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    strs_a = excitation_strings(1000, 16, 5, 1)
    strs_b = excitation_strings(1000, 16, 5, 2)
    n_pairs = n_shots * 4 // 5
    pick_a = strs_a[rng.integers(0, len(strs_a), n_pairs)]
    pick_b = strs_b[rng.integers(0, len(strs_b), n_pairs)]
    shifts = np.arange(15, -1, -1)
    pairs = np.hstack([(pick_b[:, None] >> shifts) & 1, (pick_a[:, None] >> shifts) & 1])
    noise = rng.integers(0, 2, size=(n_shots - n_pairs, 32))
    return np.vstack([pairs, noise]).astype(bool)


def strings_digest(strs) -> str:
    """sha256 of a CI-string array as int64 bytes (the loop's sorted batch strings)."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(strs, dtype=np.int64).tobytes()).hexdigest()


def host_f64_energy(ham, vec) -> float:
    """True f64 Rayleigh quotient <c|H|c>/<c|c> in NumPy from the operator's
    own tables (as ``bench.py``'s ``_host_f64_energy``)."""
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
    d_a = (sign_a[:, :, None] * c[src_a]).reshape(npair, -1)
    d_b = np.swapaxes(np.take(c, src_b, axis=1), 0, 1) * sign_b[:, None, :]
    pab = d_a @ d_b.reshape(npair, -1).T
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


STEPS = ("postselect", "recovery", "recovery on the device", "subsampling",
         "table builds + upload", "solves (tables included)")


def sqd_loop_phase(dev, smi, h1, eri, ecore) -> int:
    """Phase 6: the SQD loop at full width.  Returns the kernel's launches in it."""
    import numpy as np
    import torch

    from sqd_tpu_torch import configuration_recovery, fermion
    from sqd_tpu_torch.ops import bitpack, cross_spin
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu_torch.ops.table_cache import TableCache
    from sqd_tpu_torch.primitives import BitArray

    with open(LOOP_DATA) as f:
        recorded = json.load(f)
    norb, nelec = 16, (5, 5)
    shots = BitArray.from_bool_array(loop_shots())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # Seconds per step, one dict per iteration, from wrappers around the
    # functions the loop calls (each synchronises the card before and after).
    spans: list[dict] = [{}]
    solves = []  # (m, n, kernel launches) of each batch solve
    originals = []

    def wrap(module, name, make):
        fn = getattr(module, name)
        originals.append((module, name, fn))
        setattr(module, name, make(fn))

    def timed(key):
        def make(fn):
            def wrapper(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                spans[-1][key] = spans[-1].get(key, 0.0) + time.perf_counter() - t0
                return out
            return wrapper
        return make

    def counted(fn):
        def wrapper(ci_strings, *args, **kwargs):
            before = cross_spin.cross_spin_matvec.launches
            out = fn(ci_strings, *args, **kwargs)
            solves.append((len(ci_strings[0]), len(ci_strings[1]),
                           cross_spin.cross_spin_matvec.launches - before))
            return out
        return wrapper

    for module, name, key in (
        (fermion, "postselect_by_hamming_right_and_left", "postselect"),
        (fermion, "recover_configurations", "recovery"),
        (configuration_recovery, "_gumbel_noise", "recovery on the device"),
        (configuration_recovery, "_recover_kernel", "recovery on the device"),
        (fermion, "subsample", "subsampling"),
        (fermion, "build_sci_hamiltonian", "table builds + upload"),
        (fermion, "solve_sci", "solves (tables included)"),
    ):
        wrap(module, name, timed(key))
    wrap(fermion, "solve_sci", counted)

    history = []

    def callback(results):
        history.append(results)
        spans.append({})

    cache = TableCache()
    cross_spin.cross_spin_matvec.launches = 0
    sync()
    t0 = time.perf_counter()
    best = fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, shots, norb=norb, nelec=nelec, callback=callback,
        solver_options={"table_cache": cache}, device=dev, **LOOP_SETTINGS,
    )
    sync()
    t_loop = time.perf_counter() - t0
    launches = cross_spin.cross_spin_matvec.launches
    for module, name, fn in reversed(originals):
        setattr(module, name, fn)
    spans.pop()  # opened after the last iteration

    for i, (results, span) in enumerate(zip(history, spans)):
        steps = ", ".join(f"{k} {span[k]:.4f} s" for k in STEPS if k in span)
        print(f"sqd loop iteration {i}: {steps}; subspaces "
              f"{[r.sci_state.amplitudes.shape for r in results]}; energies "
              f"{[round(r.energy + ecore, 10) for r in results]} Ha", flush=True)

    it0 = history[0]
    it0_strings = [
        (strings_digest(r.sci_state.ci_strs_a), strings_digest(r.sci_state.ci_strs_b))
        == (b["sha256_alpha"], b["sha256_beta"])
        for r, b in zip(it0, recorded["batches"])
    ]
    it0_diff = max(abs(r.energy - b["energy"]) for r, b in zip(it0, recorded["batches"]))
    state = best.sci_state
    ham = build_sci_hamiltonian(bitpack.pack_ints(state.ci_strs_a, norb),
                                bitpack.pack_ints(state.ci_strs_b, norb),
                                h1, eri, norb, nelec, device=dev)
    vec = np.zeros(ham.shape)
    vec[: state.amplitudes.shape[0], : state.amplitudes.shape[1]] = state.amplitudes
    e_host = host_f64_energy(ham, vec)
    occ_a, occ_b = best.orbital_occupancies
    strings_solved = sum(m + n for m, n, _ in solves)
    print(f"sqd loop: {len(history)} iterations, {len(solves)} batch solves in "
          f"{t_loop:.3f} s ({smi}); best energy {best.energy + ecore:.12f} Ha, "
          f"|E - host f64| {abs(best.energy - e_host):.3e}; iteration 0 vs sqd_tpu: strings "
          f"{it0_strings}, max |dE| {it0_diff:.3e}; kernel launches per solve "
          f"{[k for _, _, k in solves]} ({launches} in all); table cache: "
          f"{cache.native_rows_computed} native rows for {strings_solved} strings solved "
          f"(a direct build computes {2 * strings_solved})", flush=True)
    checks = {
        "iteration 0 gives sqd_tpu's strings": len(it0) == len(recorded["batches"])
        and all(it0_strings),
        "iteration 0 energies within 1e-7 Ha of sqd_tpu's": it0_diff < TOL_ENERGY,
        "best energy vs host f64": abs(best.energy - e_host) < TOL_ENERGY,
        "best occupancies sum to (5, 5)": abs(occ_a.sum() - 5) < 1e-8
        and abs(occ_b.sum() - 5) < 1e-8,
        "every batch solve above 200k determinants (f32)": all(
            m * n > 200_000 for m, n, _ in solves),
        "the kernel launched in every batch solve": len(solves) == sum(map(len, history))
        and all(k >= 1 for _, _, k in solves),
        "the table cache reused rows": cache.native_rows_computed < strings_solved,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"sqd loop: {what}")
    return launches


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
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian, sci_matvec_flat

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
    }
    max_err = 0.0
    for name, ham in cases.items():
        ops = ham.cross_spin_operands()
        m, n = ham.shape
        npair = ops.eri.shape[0]
        tiles = (320, 96) if name == "tiled" else cross_spin.plan(
            n, npair, cross_spin.row_stride(ops.ka_pq.shape[1]))
        c = torch.as_tensor(rng.normal(size=ham.shape), dtype=torch.float32, device=dev)
        out = cross_spin.cross_spin_matvec(c, ops, tiles=tiles)
        torch.cuda.synchronize()
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
        if name in ("wide", "tiled") and -(-n // tiles[0]) < 2:
            fail(f"the {name} case should take several k tiles")
        max_err = max(max_err, err)

    ops = ham32.cross_spin_operands()
    c = torch.as_tensor(rng.normal(size=ham32.shape), dtype=torch.float32, device=dev)

    def event_ms(fn, calls=10) -> float:
        """Per-call device time of ``calls`` back-to-back calls between two events."""
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / calls

    def run_kernel():
        cross_spin.cross_spin_matvec(c, ops)

    def run_plain():
        cross_spin.cross_spin_plain(c, ops)

    run_kernel(), run_plain()  # warm
    kernel_ms, plain_ms = [], []
    for _ in range(10):  # in turns: plain, kernel, kernel, plain
        plain_ms.append(event_ms(run_plain))
        kernel_ms.append(event_ms(run_kernel))
        kernel_ms.append(event_ms(run_kernel))
        plain_ms.append(event_ms(run_plain))
    t_kernel, t_plain = float(np.median(kernel_ms)), float(np.median(plain_ms))
    print(f"timing at {tuple(c.shape)}, npair 256 ({smi}): kernel {t_kernel:.4f} ms, "
          f"plain {t_plain:.4f} ms (per call: medians of 20 rounds of 10 calls, CUDA events)",
          flush=True)
    # the least time for the same work: every valid (alpha pair, beta pair)
    # couple is one FMA; every input is read once and the output written once
    flops = 2.0 * float(ops.ka_n.sum()) * float(ops.kb_n.sum())
    moved = [c, c, ops.ka_n, ops.ka_pq, ops.ka_src, ops.ka_sgn,
             ops.kb_n, ops.kb_rs, ops.kb_src, ops.kb_sgn, ops.eri]
    nbytes = float(sum(t.numel() * t.element_size() for t in moved))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    print(f"bound at the headline: {flops / 1e9:.4f} GFLOP at 67 TFLOP/s = {t_ops:.5f} ms, "
          f"{nbytes / 1e6:.3f} MB at 3.35 TB/s = {t_bytes:.5f} ms; bound {bound_ms:.5f} ms "
          f"by {bound_by}; kernel at {bound_ms / t_kernel:.2%} of it "
          f"({flops / t_kernel / 1e9:.3f} TFLOP/s)", flush=True)
    matvec_ms = [event_ms(lambda: ham32.matvec(c)) for _ in range(20)]
    print(f"f32 matvec at {tuple(c.shape)}: {float(np.median(matvec_ms)):.4f} ms "
          f"(medians of 20 rounds of 10 calls, CUDA events)", flush=True)

    # -- 4. Davidson on the headline operator --------------------------------
    hd32 = ham32.hdiag.reshape(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v0 = davidson_initial_guess(hd32, torch.float32)
    res = davidson_ground_state(
        sci_matvec_flat, ham32, hd32, v0, tol=1e-3, max_subspace=24, max_iterations=200)
    torch.cuda.synchronize()
    t_dav = time.perf_counter() - t0
    print(f"davidson f32: {res.iterations} iterations, residual {res.residual_norm:.3e}, "
          f"theta {res.theta + ecore:.10f} Ha, {t_dav:.3f} s", flush=True)
    if not res.converged:
        fail("the f32 Davidson did not converge on the headline operator")

    # -- 5. the slice: solve_sci on the headline problem ---------------------
    cross_spin.cross_spin_matvec.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = solve_sci((strs_a, strs_b), h1, eri, norb, nelec, device="cuda")
    torch.cuda.synchronize()
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

    loop_launches = sqd_loop_phase(dev, smi, h1, eri, ecore)

    print(json.dumps({"kernels": [{
        "name": "cross_spin_matvec",
        "route": "cuda",
        "source": "sqd_tpu_torch/csrc/cross_spin_matvec.cu",
        "replaces": "sqd_tpu/ops/pallas_matvec.py:167",
        "launches": launches,
        "launches_sqd_loop": loop_launches,
        "max_abs_err": max_err,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this contraction
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
