# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The orbital-optimization SGD step on the card: its forms and its kernels.

On random f64 RDMs and integrals of ``--norb`` orbitals (16: the headline's
width; the step's cost does not depend on the values) this prints, beside
the card's name and power limit:

* the CUDA kernels one eager step launches (``torch.profiler``), and their
  summed device time;
* ms per step of the eager step and of the replayed CUDA graph
  (``fermion._sgd_eager`` / ``fermion._sgd_graph``), in turns, each over
  ``--steps`` steps;
* whether ``torch.linalg.matrix_exp`` can be captured in a CUDA graph (the
  reason the step computes its own exponential, ``fermion._expm``).

Run from the repository root on a machine with a card::

    python3 probes/torch_sgd_step_forms.py [--norb 16] [--steps 2000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--norb", type=int, default=16)
    parser.add_argument("--steps", type=int, default=2000)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from sqd_tpu_torch import fermion

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    n = args.norb
    rng = np.random.default_rng(0)
    dm1 = rng.normal(size=(n, n))
    dm2 = rng.normal(size=(n,) * 4) * 0.1
    h1 = rng.normal(size=(n, n))
    eri = rng.normal(size=(n,) * 4) * 0.1
    k0 = rng.normal(size=n * (n - 1) // 2) * 0.1
    inputs = [torch.tensor(x + np.swapaxes(x, 0, 1), dtype=torch.float64, device=dev)
              for x in (dm1, dm2, h1, eri)]
    inputs.append(torch.tensor(k0, dtype=torch.float64, device=dev))
    rates = (0.01, 0.9)
    squarings = fermion.EXPM_SQUARINGS

    # the kernels of one eager step
    fermion._sgd_eager(*inputs, *rates, 2, squarings)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        fermion._sgd_eager(*inputs, *rates, 1, squarings)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)

    times = {"eager": [], "graph": []}
    for form in ("eager", "graph", "graph", "eager"):
        run = fermion._sgd_eager if form == "eager" else fermion._sgd_graph
        steps = args.steps if form == "graph" else args.steps // 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*inputs, *rates, steps, squarings)
        torch.cuda.synchronize()
        times[form].append((time.perf_counter() - t0) / steps * 1e3)

    a = fermion._antisymmetric_matrix_from_upper_tri(inputs[4], n)
    torch.linalg.matrix_exp(a)  # warm
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            torch.linalg.matrix_exp(a)
        capture = "captured"
    except RuntimeError as exc:  # the answer being probed, printed below
        capture = f"refused: {str(exc).splitlines()[0][:160]}"
    torch.cuda.synchronize()

    record = {
        "device": smi,
        "norb": n,
        "kernels_per_eager_step": len(kernels),
        "kernel_device_ms_per_step": device_us / 1e3,
        "eager_ms_per_step": times["eager"],
        "graph_ms_per_step": times["graph"],
        "matrix_exp_in_a_cuda_graph": capture,
    }
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
