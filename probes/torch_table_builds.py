# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where the time of ``build_sci_hamiltonian`` goes by each table backend, on one GPU.

For the headline (N2/6-31G, 1000 x 1000 excitation strings), the full CASCI
(all 4368 strings per spin) and config 5 (``chip_smoke.config5_problem``:
3163 two-word strings, 36 orbitals, 12,880 same-spin candidates a string),
prints one JSON line with, per shape, medians of three warm calls on a
synchronised host clock of

* the host tables: ``native.gather_tables`` and ``native.samespin_tables``
  of the alpha strings;
* the device tables: ``linktab.build_gather_tables`` and
  ``hamiltonian.build_samespin_tables`` of the alpha strings;
* the whole f64 ``build_sci_hamiltonian`` by ``tables_backend="native"`` and
  ``"device"`` (no pair factor: it is shared), and at config 5 the device
  build again with its searches on the words (``bitpack._searchsorted_words``);

and, at config 5, ``torch.profiler``'s device time by kernel (top 12) over
one device same-spin build with its device-busy share, and the search of
one row chunk's two-word queries by ``bitpack._searchsorted_words`` (a
binary search on the words) beside ``bitpack.torch_searchsorted_packed``
(one ``torch.searchsorted`` over int64 keys).

Run from the repository root: ``python3 probes/torch_table_builds.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DATA_STEM, all_strings, config5_problem, excitation_strings  # noqa: E402
from sqd_tpu_torch import native  # noqa: E402
from sqd_tpu_torch.models.fcidump import read_fcidump  # noqa: E402
from sqd_tpu_torch.ops import bitpack, hamiltonian, linktab  # noqa: E402


def median_s(fn, reps=3) -> float:
    fn()  # warm
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def shape_times(dev, pa, pb, h1, eri, norb, nelec, pad_to) -> dict:
    h1_d = torch.as_tensor(h1, device=dev)
    eri_d = torch.as_tensor(eri, device=dev)
    out = {
        "native_gather_s": median_s(lambda: native.gather_tables(pa, norb)),
        "native_samespin_s": median_s(lambda: native.samespin_tables(pa, h1, eri, norb,
                                                                     nelec[0])),
        "device_gather_s": median_s(lambda: linktab.build_gather_tables(pa, norb, device=dev)),
        "device_samespin_s": median_s(lambda: hamiltonian.build_samespin_tables(
            pa, h1_d, eri_d, norb, nelec[0], device=dev)),
    }
    for backend in ("native", "device"):
        out[f"build_{backend}_s"] = median_s(lambda: hamiltonian.build_sci_hamiltonian(
            pa, pb, h1, eri, norb, nelec, device=dev, pad_to=pad_to, eri_factor=None,
            tables_backend=backend))
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
    dump = read_fcidump(DATA_STEM + ".fcidump")
    h1, eri = dump["h1e"], dump["eri"]
    record = {"gpu": smi}
    pa = bitpack.pack_ints(excitation_strings(1000, 16, 5, 1), 16)
    pb = bitpack.pack_ints(excitation_strings(1000, 16, 5, 2), 16)
    record["headline"] = shape_times(dev, pa, pb, h1, eri, 16, (5, 5), (1024, 1024))
    full = bitpack.pack_ints(all_strings(16, 5), 16)
    record["casci"] = shape_times(dev, full, full, h1, eri, 16, (5, 5), (4384, 4384))
    h5, eri5, strs5 = config5_problem()
    p5 = bitpack.pack_ints(strs5, 36)
    record["config5"] = shape_times(dev, p5, p5, h5, eri5, 36, (27, 27), (3168, 3168))
    # the same device build with every two-word search on the words instead
    keyed = bitpack.torch_searchsorted_packed
    bitpack.torch_searchsorted_packed = bitpack._searchsorted_words
    try:
        record["config5"]["build_device_word_search_s"] = median_s(
            lambda: hamiltonian.build_sci_hamiltonian(
                p5, p5, h5, eri5, 36, (27, 27), device=dev, pad_to=(3168, 3168),
                eri_factor=None, tables_backend="device"))
    finally:
        bitpack.torch_searchsorted_packed = keyed

    # config 5: the device same-spin build under the profiler
    h5_d, eri5_d = torch.as_tensor(h5, device=dev), torch.as_tensor(eri5, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hamiltonian.build_samespin_tables(p5, h5_d, eri5_d, 36, 27, device=dev)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kernels)
    record["config5_samespin_profile"] = {
        "wall_s": t_prof, "device_busy_share": device_us / 1e6 / t_prof,
        "top_device_ops": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3} for e in kernels[:12]],
    }

    # one row chunk's queries: the search on the words against the int64 keys
    strs = bitpack.to_device_words(p5, dev)
    w = strs.shape[1]
    step = max(1, hamiltonian.SAMESPIN_BUILD_BYTES
               // (native.samespin_width(36, 27) * (12 + 6 * w) * 8))
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randint(0, strs.shape[0], (step * native.samespin_width(36, 27),),
                         device=dev, generator=gen)
    queries = strs[rows] ^ (strs[torch.roll(rows, 1)] & 1)  # half hits, half misses
    words = bitpack._searchsorted_words(strs, queries)
    keys = bitpack.torch_searchsorted_packed(strs, queries)
    record["config5_chunk_search"] = {
        "queries": int(queries.shape[0]),
        "equal": bool(torch.equal(words, keys)),
        "words_ms": 1e3 * median_s(lambda: bitpack._searchsorted_words(strs, queries)),
        "int64_keys_ms": 1e3 * median_s(lambda: bitpack.torch_searchsorted_packed(strs, queries)),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
