"""The harness on the CPU at a tiny size: cells, traffic, configurations and
metrics added as files, each cell's result, the traced run's record."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.tests.conftest import add_cell, measure

E2E = {"tiny.loop": "iteration_s", "tiny.solve": "solve_s"}


def _files(top: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(top):
        for name in names:
            if not name.endswith(".pyc"):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, top)] = f.read()
    return out


@pytest.mark.parametrize("workload", ["tiny.loop", "tiny.solve"])
def test_tiny_cells_run_and_are_correct(tiny_root, workload):
    out = measure(tiny_root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) >= {"setup_s", E2E[workload]}
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", ["tiny.loop", "tiny.solve"])
def test_traced_run_reads_the_per_layer_metrics(tiny_root, workload):
    out = measure(tiny_root, workload, trace=True)
    assert out["correct"]
    for name in ("tables_s", "davidson_s", "rdm_s"):
        group = "loop" if workload == "tiny.loop" else "solve"
        assert out["metrics"][f"{name}.{group}"]["value"] > 0
    assert "breakdown" in out and out["device"]["window_s"] > 0
    # no kernel of the card ran: its roofline finds nothing to read
    assert not any(k.startswith("cross_spin_roofline") for k in out["metrics"])


def test_spans_are_the_cells_own(tiny_root):
    """A traced cell wraps only the spans that its per-layer readers name: a
    span file added for another cell changes nothing in it."""
    from benchmark import harness

    with open(os.path.join(tiny_root, "benchmark", "spans", "extra.json"), "w") as f:
        json.dump({"targets": [["sqd_tpu_torch.fermion", "expectation_value"]]}, f)
    cell = harness.load_cell("tiny.solve", root=tiny_root)
    spans, counters = harness.spans_and_counters(cell)
    assert set(spans) == {"solve", "tables", "davidson", "rdm"}
    assert set(counters) == {"cross_spin_launches"}
    loop = harness.load_cell("tiny.loop", root=tiny_root)
    assert "samples" in harness.spans_and_counters(loop)[0]


def test_same_seed_same_inputs(tiny_root):
    from benchmark import harness

    cell = harness.load_cell("tiny.solve", root=tiny_root)
    driver = harness.driver_of(cell)
    pools = []
    for _ in range(2):
        import torch

        state = driver.setup(harness.Run(cell, 99, torch.device("cpu")))
        pools.append([tuple(map(tuple, sub)) for sub in state.pool])
    assert pools[0] == pools[1]


def test_new_config_traffic_cell_and_metric_by_files_alone(tiny_root):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric with new files and entries only."""
    bench_dir = os.path.join(tiny_root, "benchmark")
    before = _files(bench_dir)
    with open(os.path.join(bench_dir, "configs", "n2_631g.json")) as f:
        config = json.load(f)
    config["name"] = "n2_631g_copy"
    with open(os.path.join(bench_dir, "configs", "n2_631g_copy.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "traffic", "tiny_solve_2.json"), "w") as f:
        json.dump({"driver": "solve_sci", "subspace": "excitation_walk", "strings_per_spin": 30,
                   "pool": 2, "check_solves": 1, "ground": "lanczos"}, f)
    with open(os.path.join(bench_dir, "metrics", "requests_done.solve.py"), "w") as f:
        f.write("def read(record):\n    return len(record['requests']) or None\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "n2_631g_copy", "source": "x",
                             "file": "benchmark/configs/n2_631g_copy.json", "reduced": [],
                             "why": "x"})
    bench["per_layer"].append({"name": "requests_done.solve", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "solve_s",
                               "workloads": ["new.cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    add_cell(tiny_root, "new.cell", "n2_631g_copy", "tiny_solve_2", "n2_631g.solve_1e6",
             "solve_s")
    out = measure(tiny_root, "new.cell", trace=True)
    assert out["correct"]
    assert out["metrics"]["requests_done.solve"]["value"] >= 1
    after = _files(bench_dir)
    assert all(after[p] == before[p] for p in before)
