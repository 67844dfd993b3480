# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The operator's tables built on the card against the native host build, on one GPU.

For the headline (N2/6-31G, 1000 x 1000 excitation strings), the (5,5)e set
in 26 orbitals (the cc-pVDZ FCIDUMP's 26 highest orbitals, 1000 x 1000
excitation strings), the full CASCI (all 4368 strings per spin) and config 5
(``bench_torch.config5_problem``: 3163 two-word strings, 36 orbitals, 12,880
same-spin candidates a string), prints one JSON line (and writes it to
``chiprun_out/card_tables_probe.json``) with, per shape:

* ``host_s``: both spins' native tables (``native.gather_tables`` and
  ``native.samespin_tables``), what ``tables.host`` runs without a cache;
* ``card_s``: ``card_tables.build_tables`` on a synchronised host clock,
  and ``equal``: its eight tables against the native ones (``torch.equal``);
* ``card_device_ms``: ``torch.profiler``'s device time of each of its
  kernels per build, and ``card_busy_share``: their sum over ``card_s``;
* ``operator_native_s`` and ``operator_auto_s``: the whole f64
  ``build_sci_hamiltonian`` by ``tables_backend="native"`` and ``"auto"``.

Medians of warm calls (3 for the host, 10 for the card).  Run from the
repository root: ``python3 probes/torch_card_tables.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import config5_problem, excitation_strings  # noqa: E402
from sqd_tpu_torch import native  # noqa: E402
from sqd_tpu_torch.models.fcidump import read_fcidump  # noqa: E402
from sqd_tpu_torch.ops import bitpack, card_tables, hamiltonian  # noqa: E402
from sqd_tpu_torch.ops.dense_fci import all_hamming_strings  # noqa: E402

DATA = os.path.join(ROOT, "sqd_tpu_torch", "data")


def median_s(fn, reps) -> float:
    fn()  # warm
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def host_tables(pa, pb, h1, eri, norb, nelec):
    return (*native.gather_tables(pa, norb), *native.gather_tables(pb, norb),
            *native.samespin_tables(pa, h1, eri, norb, nelec[0]),
            *native.samespin_tables(pb, h1, eri, norb, nelec[1]))


def shape_record(dev, pa, pb, h1, eri, norb, nelec, pad_to) -> dict:
    def card():
        return card_tables.build_tables(pa, pb, h1, eri, norb, nelec, device=dev)

    want = host_tables(pa, pb, h1, eri, norb, nelec)
    got = card()
    torch.cuda.synchronize()
    equal = all(torch.equal(g.cpu(), torch.from_numpy(np.asarray(w)).to(g.dtype))
                and g.shape == w.shape for g, w in zip(got, want))
    out = {
        "widths": [int(got[4].shape[1]), int(got[6].shape[1])],
        "equal": equal,
        "host_s": median_s(lambda: host_tables(pa, pb, h1, eri, norb, nelec), 3),
        "card_s": median_s(card, 10),
    }
    builds = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(builds):
            card()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out["card_device_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 / builds
                             for e in kernels}
    out["card_busy_share"] = sum(out["card_device_ms"].values()) / 1e3 / out["card_s"]
    for backend in ("native", "auto"):
        out[f"operator_{backend}_s"] = median_s(lambda: hamiltonian.build_sci_hamiltonian(
            pa, pb, h1, eri, norb, nelec, device=dev, pad_to=pad_to,
            tables_backend=backend), 3)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    native.load()
    dump = read_fcidump(os.path.join(DATA, "n2_631g_cas16o_5a5b.fcidump"))
    h1, eri = dump["h1e"], dump["eri"]
    record = {"gpu": smi}
    pa = bitpack.pack_ints(excitation_strings(1000, 16, 5, 1), 16)
    pb = bitpack.pack_ints(excitation_strings(1000, 16, 5, 2), 16)
    record["headline"] = shape_record(dev, pa, pb, h1, eri, 16, (5, 5), (1024, 1024))
    dz = read_fcidump(os.path.join(DATA, "n2_ccpvdz_28o_7a7b.fcidump"))
    h26, eri26 = dz["h1e"][2:, 2:].copy(), dz["eri"][2:, 2:, 2:, 2:].copy()
    pa = bitpack.pack_ints(excitation_strings(1000, 26, 5, 1), 26)
    pb = bitpack.pack_ints(excitation_strings(1000, 26, 5, 2), 26)
    record["ccpvdz_26o"] = shape_record(dev, pa, pb, h26, eri26, 26, (5, 5), (1024, 1024))
    full = bitpack.pack_ints(all_hamming_strings(16, 5), 16)
    record["casci"] = shape_record(dev, full, full, h1, eri, 16, (5, 5), (4384, 4384))
    h5, eri5, strs5 = config5_problem()
    p5 = bitpack.pack_ints(strs5, 36)
    record["config5"] = shape_record(dev, p5, p5, h5, eri5, 36, (27, 27), (3168, 3200))
    line = json.dumps(record)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "card_tables_probe.json"), "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
