# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The benchmark's ``fe4s4_class`` configuration on the CPU: BASELINE config 5's
(54e,36o) shape, 36 orbitals and (27,27)e on the seeded integrals of
``tools/make_fe4s4_class_data.py``, two words a string.

* the committed FCIDUMP read back equals the tool's integrals bit for bit
  (and ``bench_torch.config5_problem``'s), 8-fold symmetric, PSD of rank 108;
* ``solve_sci`` at 40 x 40 excitation-walk strings against the plain
  reference (``benchmark/reference/sci.py``) in f64 and in f32 refined in
  f64, held to the cell's limits;
* a tiny cell on the configuration, added as a later change adds one (files
  and entries), is correct on the CPU and its control is not;
* the Davidson's ``unconverged`` counter, the span that wraps the f64
  operator, and the two readers of this configuration's new metrics.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import generators, harness  # noqa: E402
from benchmark.data.fcidump import read_fcidump  # noqa: E402
from benchmark.reference import sci  # noqa: E402
from benchmark.tests.conftest import add_cell, measure  # noqa: E402
from sqd_tpu_torch import fermion  # noqa: E402
from sqd_tpu_torch.ops import davidson  # noqa: E402
from tools.make_fe4s4_class_data import NORB, NELEC, PATH, integrals  # noqa: E402

torch.set_num_threads(2)

CELL = "fe4s4_class.solve_1e6"
SEED = 2147483647 + 17
TINY = {"driver": "solve_sci", "subspace": "excitation_walk", "strings_per_spin": 24,
        "pool": 2, "solver_options": {"solver_dtype": "float32"}, "check_solves": 2,
        "ground": "lanczos"}


@pytest.fixture(scope="module")
def dump():
    return read_fcidump(PATH)


@pytest.fixture(scope="module")
def limits():
    return harness.load_json(os.path.join(ROOT, "benchmark", "limits", CELL + ".json"))


def test_fcidump_is_the_tools_integrals(dump):
    h1, eri = integrals()
    assert dump["norb"] == NORB and dump["nelec"] == NELEC and dump["ecore"] == 0.0
    assert np.array_equal(dump["h1e"], h1) and np.array_equal(dump["eri"], eri)
    import bench_torch

    h1_bench, eri_bench, _ = bench_torch.config5_problem(strings=1)
    assert np.array_equal(h1, h1_bench) and np.array_equal(eri, eri_bench)
    for perm in ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1)):
        assert np.array_equal(eri, eri.transpose(perm))
    w = np.linalg.eigvalsh(eri.reshape(NORB**2, NORB**2))
    assert w[0] > -1e-12 * w[-1]
    assert int(np.count_nonzero(w > 1e-10 * w[-1])) == 3 * NORB


@pytest.mark.parametrize("solver_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32_refined"])
def test_solve_sci_against_the_reference(dump, limits, solver_dtype):
    """Two-word strings of 27 of 36 orbitals; each number within the cell's
    limit of the reference's."""
    strs = tuple(generators.excitation_strings(40, NORB, 27, [SEED, k]) for k in (0, 1))
    assert strs[0].max() >= 1 << 32  # past one 32-bit word
    out = fermion.solve_sci(strs, dump["h1e"], dump["eri"], NORB, NELEC, device="cpu",
                            solver_dtype=solver_dtype)
    sub = sci.Subspace(*strs, dump["h1e"], dump["eri"], NORB, device="cpu")
    ref = sub.evaluate(out.sci_state.amplitudes)
    found = {
        "residual": ref["residual"],
        "energy_gap": abs(out.energy - ref["energy"]),
        "rdm1_gap": max(np.abs(out.rdm1 - ref["rdm1"]).max(),
                        np.abs(out.orbital_occupancies[0] - ref["occ_a"]).max(),
                        np.abs(out.orbital_occupancies[1] - ref["occ_b"]).max()),
        "rdm2_gap": np.abs(out.rdm2 - ref["rdm2"]).max(),
        "ground_gap": abs(out.energy - sub.lowest_eigenvalue(SEED)),
    }
    assert set(found) == set(limits)
    for key, value in found.items():
        assert value <= limits[key], (key, value, limits[key])


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` with a tiny cell on
    ``fe4s4_class`` added by files and entries alone."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "benchmark", "traffic", "tiny_fe4s4.json"), "w") as f:
        json.dump(TINY, f)
    add_cell(root, "tiny.fe4s4", "fe4s4_class", "tiny_fe4s4", CELL, "solve_s")
    return root


def test_tiny_cell_is_correct_and_its_control_is_not(tiny_root):
    sound = measure(tiny_root, "tiny.fe4s4", seed=SEED)
    control = measure(tiny_root, "tiny.fe4s4", seed=SEED, control=True)
    assert sound["correct"], sound["checks"]
    assert not control["correct"]
    failed = {k for k, c in control["checks"].items() if c["value"] > c["limit"]}
    assert {"energy_gap", "rdm1_gap", "rdm2_gap", "ground_gap"} <= failed


def _dense_problem(dim=60, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim))
    h = torch.as_tensor((a + a.T) / 2 + np.diag(np.arange(dim, dtype=float)))
    return h, torch.diagonal(h).clone(), torch.ones(dim, dtype=torch.float64)


def _matvec(h, x):
    return h @ x


@pytest.mark.parametrize("segmented, capped", [(False, True), (False, False), (True, True),
                                               (True, False)],
                         ids=["plain_capped", "plain_converged", "segmented_capped",
                              "segmented_converged"])
def test_unconverged_counter(segmented, capped):
    """One count for a lowest-pair solve that stops at its cap short of its
    tolerance, segments and all; none for one that converges."""
    h, hdiag, v0 = _dense_problem()
    kwargs = dict(tol=1e-13 if capped else 1e-8, max_subspace=8)
    before = davidson.davidson_ground_state.unconverged
    if segmented:
        res = davidson.davidson_ground_state_segmented(
            _matvec, h, hdiag, v0, max_iterations=12 if capped else 200,
            segment_iterations=4, **kwargs)
    else:
        res = davidson.davidson_ground_state(_matvec, h, hdiag, v0,
                                             max_iterations=3 if capped else 200, **kwargs)
    assert res.converged is not capped
    assert davidson.davidson_ground_state.unconverged - before == int(capped)


def _recorded(monkeypatch, stage=None):
    """Wrap ``fermion.davidson_ground_state`` (through ``stage`` if given);
    returns the list of each call's ``(dtype, iterations, converged)``."""
    calls, real = [], fermion.davidson_ground_state
    stage = stage or real

    def recorded(matvec, operator, hdiag, v0, **kwargs):
        res = stage(matvec, operator, hdiag, v0, **kwargs)
        calls.append((v0.dtype, res.iterations, res.converged))
        return res

    monkeypatch.setattr(fermion, "davidson_ground_state", recorded)
    return calls


def test_f64_span_wraps_every_exact_application(dump, monkeypatch):
    """In an f32 solve refined in f64, the span's calls are each refinement
    call's start and iterations and the energy's one; the counter advances
    once, for the refinement stopped at its cap of 1 short of its tolerance,
    which then goes on to converge."""
    from benchmark.probe import Probe

    strs = tuple(generators.excitation_strings(24, NORB, 27, [SEED, k]) for k in (2, 3))
    spans = {"f64_matvec": harness.load_json(os.path.join(ROOT, "benchmark", "spans",
                                                          "f64_matvec.json"))}
    calls = _recorded(monkeypatch)
    before = davidson.davidson_ground_state.unconverged
    with Probe(torch.device("cpu"), spans, {}) as probe:
        fermion.solve_sci(strs, dump["h1e"], dump["eri"], NORB, NELEC, device="cpu",
                          solver_dtype=torch.float32, refine_iterations=1)
    assert [(dt, conv) for dt, _, conv in calls] == [
        (torch.float32, True), (torch.float64, False), (torch.float64, True)]
    assert len(probe.calls["f64_matvec"]) == sum(1 + it for _, it, _ in calls[1:]) + 1
    assert davidson.davidson_ground_state.unconverged - before == 1


def test_refinement_reaches_the_ground_state_from_an_excited_one(dump, monkeypatch):
    """The f32 stage made to stop at the first excited state (its ground state
    shifted up by 10 Ha): the refinement falls below it, runs past
    ``refine_iterations`` and ends at the subspace's lowest eigenvalue."""
    real = fermion.davidson_ground_state

    def excited_f32(matvec, operator, hdiag, v0, **kwargs):
        if v0.dtype != torch.float32:
            return real(matvec, operator, hdiag, v0, **kwargs)
        g = real(matvec, operator, hdiag, v0, **kwargs).vector
        g = g / g.norm()

        def shifted(op, x):
            return matvec(op, x) + 10.0 * g * (g @ x)

        return real(shifted, operator, hdiag, v0 - (g @ v0) * g, **kwargs)

    # strings on which the f32 stage's shifted solve stops at the first
    # excited state, 3.1 Ha above the ground state
    strs = tuple(generators.excitation_strings(40, NORB, 27, [7, k]) for k in (0, 1))
    calls = _recorded(monkeypatch, excited_f32)
    out = fermion.solve_sci(strs, dump["h1e"], dump["eri"], NORB, NELEC, device="cpu",
                            solver_dtype=torch.float32, with_rdms=False)
    lowest = sci.Subspace(*strs, dump["h1e"], dump["eri"], NORB,
                          device="cpu").lowest_eigenvalue(SEED)
    assert [(dt, it, conv) for dt, it, conv in calls[1:2]] == [(torch.float64, 6, False)]
    assert calls[-1][2] and abs(out.energy - lowest) < 1e-8


def _reader(name):
    return harness.load_module(os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
                               "benchmark_metric_test_fe4s4_" + name)


def test_f64_matvec_ms_reader():
    read = _reader("f64_matvec_ms").read
    record = {"calls": {"f64_matvec": [{"seconds": 0.1}, {"seconds": 0.3}]}}
    assert read(record) == pytest.approx(200.0)
    assert read({}) is None  # not traced
    assert read({"calls": {"f64_matvec": []}}) is None  # no application in the window


def test_davidson_unconverged_reader(monkeypatch):
    reader = _reader("davidson_unconverged")
    assert reader.COUNTERS == ("davidson_unconverged",) and "solve" in reader.SPANS
    solves = [{"seconds": 1.0, "counters": {"davidson_unconverged": n}} for n in (1, 0, 1, 1)]
    assert reader.read({"calls": {"solve": solves}}) == pytest.approx(0.75)
    assert reader.read({}) is None
    assert reader.read({"calls": {"solve": [{"seconds": 1.0, "counters": {}}]}}) is None
    # a program without the counter (an earlier one): the reader names none
    monkeypatch.delattr(davidson.davidson_ground_state, "unconverged")
    assert _reader("davidson_unconverged").COUNTERS == ()
