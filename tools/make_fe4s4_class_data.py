# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Write the integrals of the benchmark's ``fe4s4_class`` configuration.

BASELINE config 5 is the (54e,36o) [4Fe-4S] active space of the SQD paper
(Robledo-Moreno et al., arXiv:2405.05068).  The paper's integrals for that
space are not in the repository, so the configuration runs on the seeded
stand-in that ``bench_torch.config5_problem`` (and ``bench.py``) builds:
36 orbitals, a near-diagonal ``h1`` (``diag(linspace(-14, 4))`` plus
``0.05 N(0, 1)``, symmetrised) and a PSD ``eri`` from a symmetric random
factor of rank 108 = 3 * 36, all from ``default_rng(7)``.

This script rebuilds those integrals (:func:`integrals`) and writes
``benchmark/data/fe4s4_class_36o_27a27b.fcidump`` (``NORB=36,NELEC=54,MS2=0``,
core energy 0): every 8-fold-unique element of ``eri`` and every element of
``h1``'s lower triangle, each at 17 significant digits, so that reading the
file back gives the same f64 numbers.  Run from the repository root on a CPU
host (a few seconds)::

    python tools/make_fe4s4_class_data.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "benchmark", "data", "fe4s4_class_36o_27a27b.fcidump")
NORB, NELEC, SEED = 36, (27, 27), 7


def integrals() -> tuple[np.ndarray, np.ndarray]:
    """``(h1, eri)`` of ``bench_torch.config5_problem``, from its seed."""
    rng = np.random.default_rng(SEED)
    h1 = np.diag(np.linspace(-14.0, 4.0, NORB)) + 0.05 * rng.normal(size=(NORB, NORB))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(3 * NORB, NORB, NORB)) * (0.5 / np.sqrt(3 * NORB))
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    return h1, eri


def main() -> None:
    sys.path.insert(0, ROOT)
    from sqd_tpu_torch.models.fcidump import write_fcidump

    h1, eri = integrals()
    # tol 0: every element but exact zeros, of which these integrals have none
    write_fcidump(PATH, h1, eri, nelec=NELEC, ecore=0.0, tol=0.0)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
