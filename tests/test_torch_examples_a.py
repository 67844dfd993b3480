# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's guide examples (``sqd_tpu_torch/examples``) against ``sqd_tpu``'s.

Each port example runs ``main(device="cpu")`` (``07`` and ``14`` at the CPU
tests' smaller size, as ``tests/test_examples.py`` runs them) with
``sqd_tpu``'s Gumbel noise injected into configuration recovery
(``test_torch_configuration_recovery.jax_gumbel_noise``), and prints the
lines ``tools/make_example_records.py`` recorded from the ``sqd_tpu``
example (``sqd_tpu_torch/data/example_records.json``): the same lines in the
same order, their text equal with the numbers masked, each number within
1e-7 (one unit of the last printed decimal where fewer than seven are
printed), integers exact; time, device and path lines are not compared
(``sqd_tpu_torch.examples.records.compare``).  The energies an example prints
from a variational solve lie no lower than its exact energy less 1e-8 Ha.
The examples keep their own asserts, which run too.  They are split over
``test_torch_examples_{a,b,c}.py`` so that ``--dist loadfile`` spreads them.

This file also holds the examples' device rule (with no card, ``main()``
raises) and the record's consistency, and runs ``sqd_tpu``'s ``02`` live
against its record.
"""

import json
import os

import pytest
import torch

from test_torch_configuration_recovery import jax_gumbel_noise
from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import configuration_recovery
from sqd_tpu_torch.examples import records

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = records.load_records()


def size_of(name: str) -> str:
    """The size the CPU tests run: the smaller ``"test"`` size where there is one."""
    return "test" if "test" in records.SIZES[name] else "guide"


def run_port_example(name, monkeypatch, tmp_path) -> list[str]:
    """The port example's lines at the test size, on the CPU, with
    ``sqd_tpu``'s recovery noise; files it writes go to ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(configuration_recovery, "_gumbel_noise", jax_gumbel_noise)
    module = records.load_example(name)
    lines, _ = records.run_calls(module, records.SIZES[name][size_of(name)], device="cpu",
                                 **records.PORT_KWARGS.get(name, {}))
    return lines


def check_example(name, monkeypatch, tmp_path) -> None:
    lines = run_port_example(name, monkeypatch, tmp_path)
    assert records.compare(name, RECORDS[name][size_of(name)]["lines"], lines) == []
    assert records.variational_violations(name, lines) == []


def run_sqd_tpu_example(name, monkeypatch, tmp_path) -> list[str]:
    """``sqd_tpu``'s example ``examples/<name>.py``, run live at the guide size."""
    monkeypatch.chdir(tmp_path)
    module = records.load_example(name, os.path.join(ROOT, "examples"))
    lines, _ = records.run_calls(module, records.SIZES[name]["guide"])
    return lines


@pytest.mark.parametrize("name", ["01_quickstart", "02_pauli_projection", "03_open_closed_shell",
                                  "04_orbital_optimization", "05_mesh_scale_out",
                                  "06_checkpoint_resume"])
def test_example_matches_record(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)


def test_sqd_tpu_02_matches_its_record(monkeypatch, tmp_path):
    """The committed record is current: ``sqd_tpu``'s ``02`` prints it now."""
    name = "02_pauli_projection"
    lines = run_sqd_tpu_example(name, monkeypatch, tmp_path)
    assert records.compare(name, RECORDS[name]["guide"]["lines"], lines) == []


@pytest.mark.parametrize("name", records.EXAMPLES)
def test_example_without_a_card_raises(name, monkeypatch):
    """``main()`` defaults to the card and has no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = records.load_example(name)
    with pytest.raises(RuntimeError, match="is_available"):
        module.main()


def test_record_covers_every_example_and_size():
    assert list(RECORDS) == list(records.EXAMPLES)
    with open(records.RECORDS_PATH) as f:
        raw = json.load(f)
    for name in records.EXAMPLES:
        assert set(RECORDS[name]) == set(records.SIZES[name])
        for size, entry in RECORDS[name].items():
            calls = [(fn, args, kwargs) for fn, args, kwargs in entry["calls"]]
            assert calls == records.SIZES[name][size]
            # the file holds the printed lines alone; their kinds come from
            # records.classify when loaded
            assert raw[name][size]["lines"] == [t for _, t in entry["lines"]]
            assert all(isinstance(t, str) for t in raw[name][size]["lines"])
    # the kinds the card's phase 14 relies on
    assert [k for k, _ in RECORDS["11_real_molecule_n2"]["guide"]["lines"]].count("loop") >= 5
    assert {k for k, _ in RECORDS["07_benchmark_pauli_projection"]["guide"]["lines"]} == {
        "exact", "time"}
    assert RECORDS["05_mesh_scale_out"]["guide"]["lines"][0][0] == "device"
    assert RECORDS["08_fcidump_workflow"]["guide"]["lines"][0][0] == "path"


def test_compare_finds_differences():
    """The comparison is not vacuous: a changed number, a changed word, a
    missing line and a lower-than-exact energy are all reported."""
    name = "01_quickstart"
    rec = RECORDS[name]["guide"]["lines"]
    lines = [t for _, t in rec]
    assert records.compare(name, rec, lines) == []
    bumped = lines[0].replace(lines[0].split()[-1], f"{float(lines[0].split()[-1]) + 2e-7:.8f}")
    assert records.compare(name, rec, [bumped] + lines[1:])
    assert records.compare(name, rec, [lines[0].replace("exact", "exakt")] + lines[1:])
    assert records.compare(name, rec, lines[:-1])
    low = f"SQD energy:   {float(lines[0].split()[-1]) - 1e-6:.8f}"
    assert records.variational_violations(name, lines[:-2] + [low])
    # a loop line may differ when the loops ran on other noise; an exact one not
    assert records.compare(name, rec, lines[:-1] + ["error vs FCI: 9.99e-01"],
                           all_lines=False) == []
