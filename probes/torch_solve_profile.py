# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where the time of ``sqd_tpu_torch``'s headline ``solve_sci`` goes, on one GPU.

Runs the bench headline problem (N2/6-31G CAS(16o,(5,5)e), 1000 x 1000
excitation strings, committed FCIDUMP) three ways and prints one JSON line:

* phases — the steps of ``solve_sci`` called one by one with a synchronised
  host clock around each (host tables + upload, f32 Davidson, f64 refine,
  RDMs and, inside them, the two-hole tables (host enumeration, device
  build), f64 energy);
* solve — the whole ``solve_sci`` call, warm, on the host clock, with the peak
  device memory;
* profile — ``torch.profiler`` over one warm ``solve_sci``: device time by
  kernel (top 12) and the device-busy share of the call's wall-clock.

Run from the repository root: ``python3 probes/torch_solve_profile.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DATA_STEM, excitation_strings  # noqa: E402
from sqd_tpu_torch import fermion  # noqa: E402
from sqd_tpu_torch.models.fcidump import read_fcidump  # noqa: E402
from sqd_tpu_torch.ops import bitpack, cross_spin, linktab  # noqa: E402
from sqd_tpu_torch.ops import rdm as rdm_ops  # noqa: E402
from sqd_tpu_torch.ops.davidson import davidson_ground_state, davidson_initial_guess  # noqa: E402
from sqd_tpu_torch.ops.hamiltonian import (  # noqa: E402
    build_sci_hamiltonian,
    expectation_value,
    sci_matvec_flat,
)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dump = read_fcidump(DATA_STEM + ".fcidump")
    h1, eri = dump["h1e"], dump["eri"]
    norb, nelec = 16, (5, 5)
    strs_a = excitation_strings(1000, norb, 5, 1)
    strs_b = excitation_strings(1000, norb, 5, 2)
    pa, pb = bitpack.pack_ints(strs_a, norb), bitpack.pack_ints(strs_b, norb)
    dev = torch.device("cuda")

    def solve():
        return fermion.solve_sci((strs_a, strs_b), h1, eri, norb, nelec, device=dev)

    solve()  # builds the libraries, warms the allocator and cuBLAS

    phases = {}
    ham64, phases["tables_and_upload"] = timed(lambda: build_sci_hamiltonian(
        pa, pb, h1, eri, norb, nelec, device=dev, pad_to=(1024, 1024)))
    ham32 = ham64.astype(torch.float32)
    hd = ham32.hdiag.reshape(-1)
    scale = float(torch.where(hd.abs() > 1e20, 0.0, hd).abs().max())
    tol_eff = max(1e-6, 32 * torch.finfo(torch.float32).eps * max(1.0, scale))
    cross_spin.cross_spin_matvec.launches = 0
    res32, phases["davidson_f32"] = timed(lambda: davidson_ground_state(
        sci_matvec_flat, ham32, hd, davidson_initial_guess(hd, torch.float32), tol=tol_eff))
    launches = cross_spin.cross_spin_matvec.launches
    res64, phases["refine_f64"] = timed(lambda: davidson_ground_state(
        sci_matvec_flat, ham64, ham64.hdiag.reshape(-1), res32.vector.double(),
        tol=1e-6, max_iterations=6))
    vec = res64.vector.reshape(ham64.shape)
    _, phases["rdms_f64"] = timed(lambda: rdm_ops.make_rdms(ham64, vec, pa, pb))
    # the two-hole tables of the RDMs (inside rdms_f64): the enumeration runs
    # on the host, the search over all pairs on the device
    _, phases["of_which_two_hole_tables"] = timed(lambda: [
        linktab.build_desdes_tables(p, norb, 5, device=dev) for p in (pa, pb)])
    _, phases["energy_f64"] = timed(lambda: expectation_value(ham64, vec, spin_penalty=False))
    mv32 = torch.randn(ham32.shape, device=dev)
    mv64 = mv32.double()
    _, t_mv32 = timed(lambda: [ham32.matvec(mv32) for _ in range(10)])
    _, t_mv64 = timed(lambda: [ham64.matvec(mv64) for _ in range(3)])

    torch.cuda.reset_peak_memory_stats()
    result, t_solve = timed(solve)
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, t_prof = timed(solve)
    # device-side rows only (kernels, copies, sets): the CPU ops that launch
    # them report the same device time again
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    top = [
        {"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
        for e in kernels[:12]
    ]
    print(json.dumps({
        "gpu": smi,
        "energy_total": result.energy + dump["ecore"],
        "davidson_f32": {"iterations": res32.iterations, "residual": res32.residual_norm,
                         "converged": res32.converged, "kernel_launches": launches},
        "refine_f64_iterations": res64.iterations,
        "phases_s": phases,
        "matvec_ms": {"f32": t_mv32 / 10 * 1e3, "f64": t_mv64 / 3 * 1e3},
        "solve_s": t_solve,
        "peak_device_bytes": peak,
        "profiled_solve_s": t_prof,
        "device_busy_share": device_us / 1e6 / t_prof,
        "top_device_ops": top,
    }))


if __name__ == "__main__":
    main()
