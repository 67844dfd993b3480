# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where the time of ``sqd_tpu_torch``'s SQD loop goes, on one GPU.

Runs ``chip_smoke.py``'s phase-6 problem (N2/6-31G CAS(16o,(5,5)e), 200,000
shots, ``LOOP_SETTINGS``) and prints one JSON line:

* tables — the table build of the three iteration-0 batches (~950 x 950
  strings), step by step on a synchronised host clock: gather tables,
  same-spin tables, diagonal, and the rest of ``build_sci_hamiltonian``
  (padding and upload).  Three ways: the direct native build; one
  ``TableCache`` across the three batches (the first cold, the next two
  reusing its rows); and that cache on the first batch again (every row
  cached).  Inside the cached builds, the row store's lookup and the
  neighbour-list compaction are timed too.  Medians of three rounds;
* loop — the whole loop, warm, on the host clock, twice;
* profile — ``torch.profiler`` over one more warm loop: the device-busy
  share of its wall-clock and the top device ops.

Run from the repository root: ``python3 probes/torch_sqd_loop_profile.py``.
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

from chip_smoke import DATA_STEM, LOOP_SETTINGS, loop_shots  # noqa: E402
from sqd_tpu_torch import fermion, native  # noqa: E402
from sqd_tpu_torch.counts import bit_array_to_arrays, bitstring_matrix_to_integers  # noqa: E402
from sqd_tpu_torch.models.fcidump import read_fcidump  # noqa: E402
from sqd_tpu_torch.ops import bitpack, table_cache  # noqa: E402
from sqd_tpu_torch.ops import hamiltonian as ham_ops  # noqa: E402
from sqd_tpu_torch.primitives import BitArray  # noqa: E402
from sqd_tpu_torch.subsampling import postselect_by_hamming_right_and_left, subsample  # noqa: E402

NORB, NELEC = 16, (5, 5)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def iteration_zero_batches(shots):
    """The packed (alpha, beta) strings of the loop's iteration-0 batches."""
    bits, probs = bit_array_to_arrays(shots)
    bits, probs = postselect_by_hamming_right_and_left(bits, probs, hamming_right=5,
                                                       hamming_left=5)
    rng = np.random.default_rng(LOOP_SETTINGS["seed"])
    batches = []
    for rows in subsample(bits, probs, LOOP_SETTINGS["samples_per_batch"],
                          LOOP_SETTINGS["num_batches"], rand_seed=rng):
        strs = [np.unique(bitstring_matrix_to_integers(half)) for half in
                (rows[:, NORB:], rows[:, :NORB])]
        batches.append([bitpack.pack_ints(s, NORB) for s in strs])
    return batches


class Spans:
    """Seconds spent in wrapped functions, reset per measured build."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def wrap(self, owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, name, wrapper)


def table_build(pa, pb, h1, eri, tables, spans, dev):
    """One build_sci_hamiltonian's steps; ``tables`` is ``native`` or a TableCache."""
    spans.seconds = {}
    steps = {}
    _, steps["gather_tables"] = timed(lambda: [tables.gather_tables(p, NORB) for p in (pa, pb)])
    _, steps["samespin_tables"] = timed(lambda: [
        tables.samespin_tables(p, h1, eri, NORB, n) for p, n in zip((pa, pb), NELEC)])
    _, steps["diagonal"] = timed(lambda: ham_ops._hdiag_np(
        ham_ops._occupancy_np(pa, NORB), ham_ops._occupancy_np(pb, NORB), h1, eri))
    steps.update({f"of which {k}": v for k, v in spans.seconds.items()})
    cache = tables if isinstance(tables, table_cache.TableCache) else None
    pad = tuple(-(-len(p) // 32) * 32 for p in (pa, pb))
    # the whole host build once more (its tables are now cached where a cache
    # is used, so a cached build is timed twice over): padding and upload
    _, whole = timed(lambda: ham_ops.build_sci_hamiltonian(
        pa, pb, h1, eri, NORB, NELEC, device=dev, pad_to=pad, table_cache=cache,
        tables_backend="native"))
    steps["whole build"] = whole
    return steps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    dump = read_fcidump(DATA_STEM + ".fcidump")
    h1, eri = dump["h1e"], dump["eri"]
    shots = BitArray.from_bool_array(loop_shots())
    batches = iteration_zero_batches(shots)

    spans = Spans()
    spans.wrap(table_cache._Store, "lookup", "row store lookup")
    spans.wrap(native, "compact_neighbours", "compaction")
    spans.wrap(native, "samespin_values", "native value kernels")
    spans.wrap(native, "gather_values", "native value kernels")
    (pa0, pb0) = batches[0]
    fermion.solve_sci(  # builds the libraries, warms the allocator and cuBLAS
        (bitpack.unpack_to_ints(pa0, NORB), bitpack.unpack_to_ints(pb0, NORB)),
        h1, eri, NORB, NELEC, device=dev)

    rounds = {"direct": [], "cache": [], "cache, every row cached": []}
    for _ in range(3):
        rounds["direct"].append([table_build(pa, pb, h1, eri, native, spans, dev)
                                 for pa, pb in batches])
        cache = table_cache.TableCache()
        rounds["cache"].append([table_build(pa, pb, h1, eri, cache, spans, dev)
                                for pa, pb in batches])
        rounds["cache, every row cached"].append(
            [table_build(pa0, pb0, h1, eri, cache, spans, dev)])
    tables = {}
    for way, runs in rounds.items():
        tables[way] = [
            {k: float(np.median([run[b][k] for run in runs])) for k in runs[0][b]}
            for b in range(len(runs[0]))
        ]

    def loop():
        return fermion.diagonalize_fermionic_hamiltonian(
            h1, eri, shots, norb=NORB, nelec=NELEC, device=dev, **LOOP_SETTINGS)

    best, t_loop = zip(*(timed(loop) for _ in range(2)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, t_prof = timed(loop)
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    print(json.dumps({
        "gpu": smi,
        "batch_shapes": [[len(pa), len(pb)] for pa, pb in batches],
        "tables_s": tables,
        "loop_s": list(t_loop),
        "best_energy_total": [b.energy + dump["ecore"] for b in best],
        "profiled_loop_s": t_prof,
        "device_busy_share": device_us / 1e6 / t_prof,
        "top_device_ops": [
            {"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in kernels[:10]
        ],
    }))


if __name__ == "__main__":
    main()
