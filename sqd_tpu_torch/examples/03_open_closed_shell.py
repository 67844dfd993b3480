# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Open- vs closed-shell subspace strategies.

The port of ``examples/03_open_closed_shell.py`` (the reference guide
docs/guides/select_open_closed_shell.ipynb): with ``open_shell=False`` the
alpha and beta halves of the sampled bitstrings are merged into one shared
configuration set (spin-exchange-symmetric subspace, up to twice the strings
per spin); with ``open_shell=True`` they stay separate.  Run on the card
from a checkout::

    python3 sqd_tpu_torch/examples/03_open_closed_shell.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch import bitstring_matrix_to_ci_strs, solve_fermion
from sqd_tpu_torch.models.hubbard import hubbard_integrals
from sqd_tpu_torch.utils.device import checked_device


def main(device="cuda"):
    device = checked_device(device)
    norb = 6
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(40):
        row = np.zeros(2 * norb, dtype=bool)
        row[norb + rng.choice(norb, 3, replace=False)] = True  # alpha: 3 electrons
        row[rng.choice(norb, 3, replace=False)] = True  # beta: 3 electrons
        rows.append(row)
    bs_mat = np.array(rows)

    strs_closed = bitstring_matrix_to_ci_strs(bs_mat, open_shell=False)
    strs_open = bitstring_matrix_to_ci_strs(bs_mat, open_shell=True)
    print(f"closed shell: |strs_a| = {len(strs_closed[0])} == |strs_b| = {len(strs_closed[1])}")
    print(f"open shell:   |strs_a| = {len(strs_open[0])},  |strs_b| = {len(strs_open[1])}")

    h1, eri = hubbard_integrals(norb, u=4.0)
    for name, open_shell in [("closed", False), ("open", True)]:
        e, state, occ, ss = solve_fermion(bs_mat, h1, eri, open_shell=open_shell, device=device)
        dim = len(state.ci_strs_a) * len(state.ci_strs_b)
        print(f"{name:>6}-shell solve: dim {dim:5d}  E = {e:.8f}  S^2 = {ss:.4f}")


if __name__ == "__main__":
    main()
