"""What the drivers share to decide ``correct``: a seeded sample of the
window's solves, and the gaps between a solve's outputs and the plain
reference's (:mod:`benchmark.reference.sci`, f64 on the run's device).

Each sampled solve is held to the reference on its amplitudes (the residual
``|Hc - Ec|``), its energy, its 1- and 2-RDMs and occupancies, and to the
ground state: its energy against the subspace's lowest eigenvalue, which the
reference finds on its own by Lanczos from a random start
(``"ground": "lanczos"`` in the traffic), or, where the subspace is the
whole space and the configuration states its exact energy
(``"ground": "exact"``), the energy plus the core energy against that.

The program's energy, occupancies and RDMs are f64 by the configuration.
The control (``run.control``) runs the program's own f32-only path (no f64
refinement) and puts the reference computed in f32 in place of the
program's f64 energy and RDMs; its gaps are what the limits must separate
from the program's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.generators import seed_words
from benchmark.harness import release
from benchmark.reference import sci

GAPS = ("residual", "energy_gap", "rdm1_gap", "rdm2_gap")
GROUND = {"lanczos": "ground_gap", "exact": "exact_gap"}
details: list = []  # per solve, the last check's readings (for calibration)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``."""

    def __init__(self, k: int, seed):
        self.k, self.seen, self.items = int(k), 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, key, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, item))
        else:
            r = int(self.rng.integers(self.seen))
            if r < self.k:
                self.items[r] = (key, item)

    def kept(self) -> list:
        return [item for _, item in sorted(self.items, key=lambda ki: ki[0])]


def solver_options(traffic: dict) -> dict:
    """The traffic's ``solver_options`` as ``solve_sci`` takes them (a dtype
    is named by its ``torch`` attribute, e.g. ``"float32"``)."""
    options = dict(traffic.get("solver_options", {}))
    if "solver_dtype" in options:
        options["solver_dtype"] = getattr(torch, options["solver_dtype"])
    return options


def weight_errors(strs, n_elec: int) -> int:
    """Strings whose number of set bits is not ``n_elec``."""
    x = np.asarray(strs, dtype=np.int64)
    bits = np.unpackbits(x.astype(">u8").view(np.uint8)).reshape(-1, 64).sum(1)
    return int(np.count_nonzero(bits != n_elec))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def solve_gaps(results, prob: dict, run, ground: str, config: dict) -> dict:
    """The worst over ``results`` (``SCIResult``s) of: the residual norm
    ``|H c - E c|`` of the returned amplitudes (``E`` their f64 Rayleigh
    quotient), the gap of the returned energy to that quotient, the largest
    gaps of the 1-RDM with the occupancies and of the 2-RDM, and the gap of
    the returned energy to the ground state's (``ground``: see above)."""
    name = GROUND[ground]
    details.clear()
    if not results:  # nothing to judge is no pass
        return dict.fromkeys(GAPS + (name,), float("inf"))
    worst = dict.fromkeys(GAPS + (name,), 0.0)
    for k, r in enumerate(results):
        st = r.sci_state
        sub = sci.Subspace(st.ci_strs_a, st.ci_strs_b, prob["h1"], prob["eri"], prob["norb"],
                           device=run.device)
        ref = sub.evaluate(st.amplitudes)
        energy, rdm1, occ, rdm2 = r.energy, r.rdm1, r.orbital_occupancies, r.rdm2
        if run.control:
            low = sci.Subspace(st.ci_strs_a, st.ci_strs_b, prob["h1"], prob["eri"], prob["norb"],
                               device=run.device, dtype=torch.float32).evaluate(st.amplitudes)
            energy, rdm1, occ, rdm2 = low["energy"], low["rdm1"], (low["occ_a"], low["occ_b"]), \
                low["rdm2"]
        if ground == "lanczos":
            rng = np.random.default_rng(seed_words(run.seed, k, 8))
            lowest = sub.lowest_eigenvalue(int(rng.integers(1 << 62)))
        else:
            lowest = float(config["exact_energy_ha"]) - prob["ecore"]
        found = {
            "residual": ref["residual"],
            "energy_gap": abs(float(energy) - ref["energy"]),
            "rdm1_gap": max(_max_abs(rdm1, ref["rdm1"]), _max_abs(occ[0], ref["occ_a"]),
                            _max_abs(occ[1], ref["occ_b"])),
            "rdm2_gap": _max_abs(rdm2, ref["rdm2"]),
            name: abs(float(energy) - lowest),
        }
        details.append({"dim": [len(st.ci_strs_a), len(st.ci_strs_b)], "energy": float(energy),
                        "lowest": lowest, **found})
        for key, v in found.items():
            worst[key] = max(worst[key], v)
        del ref, sub
        release(run.device)
    return worst
