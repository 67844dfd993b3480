# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Large active spaces: the [4Fe-4S]-class (54e, 36o) machinery, scaled down.

The port of ``examples/13_large_active_space.py``.  BASELINE config 5 is a
(54 electron, 36 orbital) Fe-S cluster at 1e6-1e7 determinants.  Three
things change in that regime relative to the N2-sized workflows of the other
examples:

1. **Multiword strings** — 36 orbitals need two packed 32-bit words; every
   table and the cross-spin kernel are width-generic (no 63-orbital cliff).
2. **Table builds at high filling** — 27 electrons in 36 orbitals have
   12,880 candidate same-spin excitations per string; the intersection-
   driven build (sorting one-/two-hole intermediates) keeps the host cost
   proportional to the OUTPUT, not the candidate count.
3. **The cross-spin FLOP wall** — the (norb^2, norb^2) pair contraction is
   2*norb^4*dim FLOPs per matvec.  Physical ERIs factor as V = L^T L with
   rank X ~ 6-10x norb (``eri_factor="auto"``), and the factored operator
   can be densified to batched matrix products with no gathers
   (``matvec_strategy="dense_df"``).

This example runs the full pattern at a small size: a synthetic PSD ERI over
36 orbitals (the shape is the point), a few-hundred-determinant subspace, and
cross-validation of every strategy against the same exact solve.
:func:`problem` gives its inputs, for solves of them by other routes
(``chip_smoke.py`` phase 14 (b) solves them in f32 through the cross-spin
kernel).  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/13_large_active_space.py

or on the CPU as ``main(device="cpu")``.
"""

import os
import sys

import numpy as np

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch.fermion import solve_sci
from sqd_tpu_torch.ops import bitpack
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian, pivoted_cholesky_pairs
from sqd_tpu_torch.utils.device import checked_device


def problem():
    """The example's inputs: ``(h1, eri, strs_a, strs_b, norb, nelec)``."""
    norb, nelec = 36, (27, 27)
    rng = np.random.default_rng(7)

    # synthetic PSD integrals with a low-rank Cholesky structure, like real
    # ERIs (density-fitting rank ~ 3 x norb here)
    orb_e = np.linspace(-14.0, 4.0, norb)
    h1 = np.diag(orb_e) + 0.05 * rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(3 * norb, norb, norb)) * (0.5 / np.sqrt(3 * norb))
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)

    # a small single-excitation cluster around the HF determinant
    def excitation_strings(count, seed):
        r = np.random.default_rng(seed)
        hf = (1 << nelec[0]) - 1
        seen = {hf}
        frontier = [hf]
        while len(seen) < count:
            base = frontier[r.integers(len(frontier))]
            occ = [p for p in range(norb) if (base >> p) & 1]
            virt = [p for p in range(norb) if not (base >> p) & 1]
            new = base ^ (1 << occ[r.integers(len(occ))]) ^ (1 << virt[r.integers(len(virt))])
            if new not in seen:
                seen.add(new)
                frontier.append(new)
        return np.array(sorted(seen), dtype=np.int64)

    return h1, eri, excitation_strings(24, 1), excitation_strings(24, 2), norb, nelec


def main(device="cuda"):
    device = checked_device(device)
    h1, eri, sa, sb, norb, nelec = problem()
    pa = bitpack.pack_ints(sa, norb)
    print(f"strings are {pa.shape[1]} packed words each (36 orbitals)")

    # the ERI pair matrix factors: rank << npair = 1296
    ell = pivoted_cholesky_pairs(eri, norb)
    print(f"pivoted Cholesky rank: {ell.shape[0]} of npair = {norb * norb}")

    # the factor is attached automatically (npair > 256, PSD)
    ham = build_sci_hamiltonian(pa, bitpack.pack_ints(sb, norb), h1, eri, norb, nelec,
                                device=device)
    assert ham.eri_chol is not None

    # same subspace through both iteration engines — identical physics
    r_gather = solve_sci((sa, sb), h1, eri, norb, nelec, spin_sq=None, device=device)
    r_dense = solve_sci(
        (sa, sb), h1, eri, norb, nelec, spin_sq=None, matvec_strategy="dense_df", device=device
    )
    print(f"gather   strategy: E = {r_gather.energy:.10f}")
    print(f"dense_df strategy: E = {r_dense.energy:.10f}")
    assert abs(r_gather.energy - r_dense.energy) < 1e-8

    # high filling: 2-RDM Grams run over ~C(27,2) intermediates per string —
    # skip them when only energy/occupancies matter
    r_light = solve_sci(
        (sa, sb), h1, eri, norb, nelec, spin_sq=None, with_rdms=False, device=device
    )
    assert r_light.rdm2 is None
    assert abs(r_light.energy - r_gather.energy) < 1e-8
    occ = r_light.orbital_occupancies[0]
    print(f"lowest/highest alpha occupancies: {occ.min():.4f} / {occ.max():.4f}")
    return r_gather.energy


if __name__ == "__main__":
    main()
