"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added by files and ``BENCHMARK.json`` entries alone, as a later change
would add them."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAFFIC = {
    "tiny_loop": {"driver": "sqd_loop", "shot_sets": 2, "shots": 3000, "strings_per_spin": 60,
                  "loop": {"samples_per_batch": 400, "num_batches": 2, "max_iterations": 2,
                           "max_dim": 40, "symmetrize_spin": False},
                  "solver_options": {"solver_dtype": "float32"}, "check_solves": 3,
                  "ground": "lanczos"},
    "tiny_solve": {"driver": "solve_sci", "subspace": "excitation_walk", "strings_per_spin": 40,
                   "pool": 3, "solver_options": {"solver_dtype": "float32"}, "check_solves": 2,
                   "ground": "lanczos"},
}
TINY_CELLS = {"tiny.loop": ("tiny_loop", "n2_631g.sqd_loop", "iteration_s"),
              "tiny.solve": ("tiny_solve", "n2_631g.solve_1e6", "solve_s")}


def add_cell(root: str, name: str, config: str, traffic: str, limits_of: str,
             end_to_end: str) -> None:
    """Add a cell to the copy at ``root`` the way a later change would: new
    files and new entries, every file already there left as it was."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a CPU test's tiny cell"})
    group = "loop" if end_to_end == "iteration_s" else "solve"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and (m["name"] == end_to_end or m["name"].endswith("." + group)):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    shutil.copy(os.path.join(root, "benchmark", "limits", limits_of + ".json"),
                os.path.join(root, "benchmark", "limits", name + ".json"))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` with the tiny cells."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(root, "benchmark", "traffic", name + ".json"), "w") as f:
            json.dump(traffic, f)
    for cell, (traffic, limits_of, e2e) in TINY_CELLS.items():
        add_cell(root, cell, "n2_631g", traffic, limits_of, e2e)
    return root


def measure(root: str, workload: str, *, seed: int = 2147483647 + 12, seconds: float = 1.0,
            trace: bool = False, control: bool = False) -> dict:
    """One run of a cell of the copy at ``root`` on the CPU: the rest of a
    run with the harness's look for a card skipped."""
    import time

    import torch

    from benchmark import harness
    from benchmark.run import measure as run_measure

    cell = harness.load_cell(workload, root=root)
    return run_measure(cell, seed, seconds, trace, torch.device("cpu"), control=control,
                       t_start=time.perf_counter())
