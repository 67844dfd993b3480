"""What the benchmark may load: nothing of JAX or the JAX package where it
runs on the card, nothing of the program in the reference; and no result
without a card."""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def loaded_top_levels(code: str, cwd: str = ROOT) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    script = code + ("\nimport sys, json\n"
                     "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    files = [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
             if os.sep + "tests" + os.sep not in p]
    code = "\n".join([
        "import importlib.util, sys",
        f"sys.path.insert(0, {ROOT!r})",
        "import benchmark.run, benchmark.calibrate, benchmark.probe",
        "import sqd_tpu_torch, sqd_tpu_torch.fermion",
        f"for i, p in enumerate({files!r}):",
        "    spec = importlib.util.spec_from_file_location(f'm{i}', p)",
        "    sys.modules[f'm{i}'] = m = importlib.util.module_from_spec(spec)",
        "    spec.loader.exec_module(m)",
    ])
    loaded = loaded_top_levels(code)
    assert "sqd_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sqd_tpu"}


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    code = "\n".join([
        "import importlib.util, sys",
        f"for i, p in enumerate({files!r}):",
        "    spec = importlib.util.spec_from_file_location(f'r{i}', p)",
        "    sys.modules[f'r{i}'] = m = importlib.util.module_from_spec(spec)",
        "    spec.loader.exec_module(m)",
    ])
    loaded = loaded_top_levels(code, cwd=os.path.join(BENCH, "reference"))
    assert not loaded & {"sqd_tpu_torch", "sqd_tpu", "jax", "jaxlib", "flax"}


def run_py(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "n2_631g.solve_1e6", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_card_no_result():
    """Here there is no CUDA card: the run exits with an error and prints no
    result; it never falls back to the CPU."""
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark")
    out = run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert any(os.path.exists(os.path.join(BENCH, "metrics", n + ".py"))
                   for n in (m["name"], m["name"].split(".")[0]))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one in each
        reported = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024
