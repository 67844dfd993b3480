# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where the time of ``sqd_tpu_torch``'s 10^7-row qubit solve goes, on one GPU.

``chip_smoke.py`` phase 9 (b)'s problem: the 26-site Heisenberg ring
(h_z = 0.1) over ``chip_smoke.solve_strings()`` (d = 10^7), through
``solve_qubit_device(tol=1e-6)``.  Prints one JSON line:

* solve_s — the call cold (first in the process) and warm, on a
  synchronised host clock;
* profile — ``torch.profiler`` over one warm call: the device-busy share of
  its wall-clock and device time by kernel (top 12);
* matvec — ``torch.profiler`` over 5 f32 matvecs: device time by kernel
  (top 8) and the device-busy share.

Run from the repository root: ``python3 probes/torch_qubit_profile.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import QUBIT_SOLVE, solve_strings  # noqa: E402
from sqd_tpu_torch import qubit  # noqa: E402
from sqd_tpu_torch.models.heisenberg import heisenberg_ring  # noqa: E402
from sqd_tpu_torch.ops.pauli_proj import pauli_apply_flat  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(fn, top):
    """Wall-clock, device-busy share and the top device ops of one call."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, seconds = timed(fn)
    # device-side rows only: the CPU ops that launch them report it again
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    return {
        "seconds": seconds,
        "device_busy_share": device_us / 1e6 / seconds,
        "top_device_ops": [
            {"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in kernels[:top]
        ],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    packed = solve_strings().astype(np.uint32)[:, None]
    op = heisenberg_ring(QUBIT_SOLVE["sites"], h_z=QUBIT_SOLVE["h_z"])

    def solve():
        return qubit.solve_qubit_device(packed, op, tol=QUBIT_SOLVE["tol"], device=dev)

    (energy, _, proj), cold = timed(solve)
    _, warm = timed(solve)
    profile = profiled(solve, 12)
    v = torch.randn(proj.dim, device=dev)
    pauli_apply_flat(proj, v)
    matvec = profiled(lambda: [pauli_apply_flat(proj, v) for _ in range(5)], 8)
    print(json.dumps({
        "gpu": smi, "d": proj.dim, "groups": proj.num_groups, "energy": energy,
        "solve_s": {"cold": cold, "warm": warm}, "profile": profile, "matvec_f32_x5": matvec,
    }))


if __name__ == "__main__":
    main()
