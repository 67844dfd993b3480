#!/usr/bin/env python3
# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Time the forms the dense density-fitted matvec could take, on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 probes/torch_dense_df_variants.py

Builds ``chip_smoke.py``'s BASELINE config 5 operator ((54e,36o), 3163 strings
per spin, padded 3168 x 3200, npair 1296, factor rank 108), densifies it, and
times one f32 application of ``sum_x Wa_x @ c @ Wb_x^T`` in each form, in
turns, with CUDA events, at ``x_chunk`` 8, 27 and the whole stack:

* ``addmm``: ``t = (Wa stacked) @ c`` in one product, then one in-place
  ``sigma.addmm_(t[x], Wb_x^T)`` per factor (no second intermediate);
* ``einsum``: ``sqd_tpu``'s ``einsum("xij,jk->xik")`` then
  ``einsum("xik,xlk->il")``;
* ``bmm``: the same first product, then ``torch.bmm(t, Wb^T)`` and a sum
  over x: the form ``ops/dense_df`` keeps.

Every form is held against ``addmm`` at ``x_chunk`` 8 (``1e-5 * max|ref|``),
TF32 off.  Also prints ``densify``'s seconds and the peak memory of each form.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from sqd_tpu_torch.ops import bitpack
    from sqd_tpu_torch.ops.dense_df import densify
    from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu_torch.ops.precision import highest_precision

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    norb, nelec = chip_smoke.CONFIG5["norb"], chip_smoke.CONFIG5["nelec"]
    h1, eri, strs = chip_smoke.config5_problem()
    packed = bitpack.pack_ints(strs, norb)
    ham = build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, device=dev,
                                pad_to=(3168, 3168))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = densify(ham, dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"densify {time.perf_counter() - t0:.3f} s, W {tuple(op.wa.shape)}, "
          f"aliased {op.wb is op.wa}", flush=True)
    del ham
    wa, wb = op.wa, op.wb
    x_tot, m, n = wa.shape[0], wa.shape[1], wb.shape[1]
    c = torch.randn((m, n), dtype=torch.float32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def addmm(wa_c, wb_c, sigma):
        t = (wa_c.reshape(-1, m) @ c).reshape(-1, m, n)
        for x in range(t.shape[0]):
            sigma.addmm_(t[x], wb_c[x].T)

    def einsum(wa_c, wb_c, sigma):
        t = torch.einsum("xij,jk->xik", wa_c, c)
        sigma += torch.einsum("xik,xlk->il", t, wb_c)

    def bmm(wa_c, wb_c, sigma):
        t = torch.matmul(wa_c, c)
        sigma += torch.bmm(t, wb_c.transpose(1, 2)).sum(dim=0)

    def apply(form, cx):
        sigma = torch.zeros((m, n), dtype=torch.float32, device=dev)
        for x0 in range(0, x_tot, cx):
            form(wa[x0 : x0 + cx], wb[x0 : x0 + cx], sigma)
        return sigma

    with highest_precision():
        ref = apply(addmm, 8)
        scale = float(ref.abs().max())
        cases = [(form, cx) for cx in (8, 27, x_tot) for form in (addmm, einsum, bmm)]
        times = {case: [] for case in cases}
        peaks = {}
        for form, cx in cases:  # warm, check, peak memory
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            err = float((apply(form, cx) - ref).abs().max())
            torch.cuda.synchronize()
            peaks[(form, cx)] = (torch.cuda.max_memory_allocated() - base) / 1e9
            if not err <= 1e-5 * scale:
                raise SystemExit(f"{form.__name__} x_chunk {cx} differs by {err:.3e}")
        for _ in range(3):
            for case in cases:
                times[case].append(chip_smoke.event_ms(lambda: apply(*case), 2))
    flops = 4.0 * x_tot * m * m * n
    for (form, cx), ms in times.items():
        med = float(np.median(ms))
        print(f"{form.__name__:7s} x_chunk {cx:3d}: {med:8.2f} ms "
              f"({flops / med / 1e9:.1f} TFLOP/s; rounds {[round(t, 2) for t in ms]}), "
              f"peak {peaks[(form, cx)]:.2f} GB over the operator ({smi})", flush=True)


if __name__ == "__main__":
    main()
