# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Variants of the cross-spin CUDA kernel timed in turns at the headline shape.

On one GPU, at the bench headline operator (M = N = 1024, npair = 256), with
CUDA events over back-to-back calls (medians of 20 rounds of 10 calls, the
variants taken in turn within each round):

* ``kernel`` — ``sqd_tpu_torch.ops.cross_spin.cross_spin_matvec`` as the port
  builds it;
* ``512x2`` — the same source rewritten for 512 threads and two blocks per
  SM, with the shared-memory plan for half an SM (228 KB / 2 less the 1 KB
  each block reserves);
* ``no_dot`` — a diagnostic build of the same source whose dot products are
  cut to one shared read each: what staging and the entry walk cost alone
  (its output is wrong and is not checked);
* ``stage_only`` — a diagnostic build that stages the tiles and walks no
  entries: what staging costs alone (output wrong, not checked);
* ``parent`` — with ``--parent-source PATH``, an earlier
  ``cross_spin_matvec.cu`` whose C interface takes the dense beta tables
  (``src_b`` int32, ``sign_b`` int8);
* ``plain`` — ``cross_spin_plain``.

Every variant but the diagnostic ones is held against ``plain`` within
``1e-5 * max(|plain|, 1)``.  Prints the card's name and power limit and one
JSON line.  Run from the repository root:
``python3 probes/torch_cross_spin_variants.py [--parent-source PATH]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DATA_STEM, excitation_strings  # noqa: E402
from sqd_tpu_torch.build import BUILD_DIR  # noqa: E402
from sqd_tpu_torch.models.fcidump import read_fcidump  # noqa: E402
from sqd_tpu_torch.ops import bitpack, cross_spin  # noqa: E402
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian  # noqa: E402

DOT = "const float4 a = ap[g];"  # the first line of the dot product's loop body
WALK = "while (t < stop && k < k1) {"
HALF_SM = 233472 // 2 - 1024  # shared memory each of two blocks on one SM may use
TWO_PER_SM = {  # source text -> its 512-thread, two-blocks-per-SM form
    "constexpr int kThreads = 1024;": "constexpr int kThreads = 512;",
    "__launch_bounds__(kThreads, 1)": "__launch_bounds__(kThreads, 2)",
    "constexpr int kMaxSmem = 232448;": f"constexpr int kMaxSmem = {HALF_SM};",
}
NEW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_int,
            *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 4, ctypes.c_void_p, ctypes.c_void_p]
PARENT_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4,
               ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p]


def build(builddir, name, source_text):
    """Start nvcc on ``source_text``; returns (process, library path)."""
    src = os.path.join(builddir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source_text)
    lib = os.path.join(builddir, f"lib{name}.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, *cross_spin.NVCC_FLAGS, "-Xptxas", "-v", src, "-o", lib]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-source", help="an earlier cross_spin_matvec.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with open(cross_spin.SOURCE) as f:
        source = f.read()
    for text in [DOT, WALK, "s = fmaf(sg, d, s);", *TWO_PER_SM]:
        if source.count(text) != 1:
            raise SystemExit(f"{cross_spin.SOURCE} no longer holds {text!r} once")
    two_per_sm = source
    for old, new in TWO_PER_SM.items():
        two_per_sm = two_per_sm.replace(old, new)
    builddir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(builddir, exist_ok=True)
    jobs = {
        "512x2": build(builddir, "v512x2", two_per_sm),
        "no_dot": build(builddir, "no_dot", source.replace(
            DOT, "break;  // no dot product\n" + DOT).replace(
            "s = fmaf(sg, d, s);", "s = fmaf(sg, ap[0].x * bp[0].x, s);")),
        "stage_only": build(builddir, "stage_only", source.replace(
            WALK, "while (t < 0) {")),
    }
    if args.parent_source:
        with open(args.parent_source) as f:
            jobs["parent"] = build(builddir, "parent", f.read())
    cross_spin._kernel_library()
    libs = {}
    for name, (proc, path) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"building {name} failed:\n{log}")
        print(name, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])
        lib = ctypes.CDLL(path)
        lib.cross_spin_matvec_f32.argtypes = PARENT_ARGS if name == "parent" else NEW_ARGS
        lib.cross_spin_matvec_f32.restype = ctypes.c_int
        libs[name] = lib
    shutil.rmtree(builddir)

    dev = torch.device("cuda")
    dump = read_fcidump(DATA_STEM + ".fcidump")
    pa = bitpack.pack_ints(excitation_strings(1000, 16, 5, 1), 16)
    pb = bitpack.pack_ints(excitation_strings(1000, 16, 5, 2), 16)
    ham = build_sci_hamiltonian(pa, pb, dump["h1e"], dump["eri"], 16, (5, 5), device=dev,
                                pad_to=(1024, 1024), dtype=torch.float32)
    ops = ham.cross_spin_operands()
    m, n = ham.shape
    npair, ka = ops.eri.shape[0], ops.ka_pq.shape[1]
    kp = cross_spin.row_stride(ka)
    c = torch.as_tensor(np.random.default_rng(0).normal(size=(m, n)), dtype=torch.float32,
                        device=dev)
    src_b32, sign_b8 = ops.src_b.to(torch.int32), ops.sign_b.to(torch.int8)
    stream = torch.cuda.current_stream().cuda_stream

    def new_call(lib, tiles):
        def call():
            out = torch.empty_like(c)
            rc = lib.cross_spin_matvec_f32(
                c.data_ptr(), m, n, ops.ka_n.data_ptr(), ops.ka_pq.data_ptr(),
                ops.ka_src.data_ptr(), ops.ka_sgn.data_ptr(), ka, ops.kb_n.data_ptr(),
                ops.kb_rs.T.data_ptr(), ops.kb_src.T.data_ptr(), ops.kb_sgn.T.data_ptr(),
                ops.eri.data_ptr(), npair, kp, *tiles, out.data_ptr(), stream)
            assert rc == 0, rc
            return out
        return call

    def parent_call():
        out = torch.empty_like(c)
        rc = libs["parent"].cross_spin_matvec_f32(
            c.data_ptr(), m, n, ops.ka_n.data_ptr(), ops.ka_pq.data_ptr(),
            ops.ka_src.data_ptr(), ops.ka_sgn.data_ptr(), ka, src_b32.data_ptr(),
            sign_b8.data_ptr(), ops.eri.data_ptr(), npair, out.data_ptr(), stream)
        assert rc == 0, rc
        return out

    calls = {
        "kernel": lambda: cross_spin.cross_spin_matvec(c, ops),
        "512x2": new_call(libs["512x2"], cross_spin.plan(n, npair, kp, HALF_SM)),
        "no_dot": new_call(libs["no_dot"], cross_spin.plan(n, npair, kp)),
        "stage_only": new_call(libs["stage_only"], cross_spin.plan(n, npair, kp)),
        "plain": lambda: cross_spin.cross_spin_plain(c, ops),
    }
    if "parent" in libs:
        calls["parent"] = parent_call
    ref = cross_spin.cross_spin_plain(c, ops)
    tol = 1e-5 * max(float(ref.abs().max()), 1.0)
    errs = {}
    for name, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        errs[name] = float((out - ref).abs().max())
        if name not in ("no_dot", "stage_only") and errs[name] > tol:
            raise SystemExit(f"{name} disagrees with the plain version: {errs[name]:.3e}")

    def event_ms(fn, count=10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / count

    times = {name: [] for name in calls}
    for _ in range(20):
        for name, fn in calls.items():
            times[name].append(event_ms(fn))
    print(json.dumps({
        "gpu": smi, "shape": [m, n], "npair": npair, "ka": ka, "kp": kp,
        "tiles": {"kernel": cross_spin.plan(n, npair, kp),
                  "512x2": cross_spin.plan(n, npair, kp, HALF_SM)},
        "median_ms": {k: float(np.median(v)) for k, v in times.items()},
        "min_ms": {k: float(np.min(v)) for k, v in times.items()},
        "max_abs_err": errs,
    }), flush=True)


if __name__ == "__main__":
    main()
