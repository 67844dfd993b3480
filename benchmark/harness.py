"""The benchmark's harness: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix, span, counter or
metric lives in a file of its own, found by the name ``BENCHMARK.json`` gives
it:

* ``BENCHMARK.json``'s ``configs`` entry names the configuration's file
  (``benchmark/configs/<name>.json``: the problem, its integrals' file under
  ``benchmark/data/``, its precision);
* ``benchmark/traffic/<traffic>.json`` holds the mix's parameters and names
  its driver, ``benchmark/drivers/<driver>.py``, which makes the inputs from
  the seed, issues one request, and judges the kept outputs against the
  plain reference (``benchmark/reference/``);
* ``benchmark/metrics/<metric>.py`` reads one metric from the run's record;
  a metric ``<reader>.<group>`` with no file of its own is read by
  ``benchmark/metrics/<reader>.py`` (``davidson_s.loop`` and
  ``davidson_s.solve`` by ``davidson_s.py``).  A reader names the spans and
  counters it reads (``SPANS``, ``COUNTERS``);
* ``benchmark/spans/<span>.json`` and ``benchmark/counters/<counter>.json``
  name the program's functions and counters the traced run wraps and reads:
  only those that the cell's per-layer readers name;
* ``benchmark/limits/<workload>.json`` holds the limit of every number the
  cell's comparison reports.

A run is a closed loop with one client: set-up (inputs, one warm request),
then requests back to back until ``seconds`` have passed; the request in
flight completes and every rate divides by the true window.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sqd_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: str = ROOT

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s ``BENCHMARK.json``, with
    its configuration, traffic and limits read from their files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = load_json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", workload + ".json"))
    return Cell(
        name=workload, entry=entry, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root,
    )


def problem(cell: Cell) -> dict:
    """The configuration's integrals, read by the benchmark's own reader, with
    the configuration's ``frozen_core`` lowest orbitals frozen."""
    from benchmark.data.fcidump import read_fcidump
    from benchmark.data.frozen_core import freeze_core

    dump = read_fcidump(cell.path("benchmark", "data", cell.config["fcidump"]))
    norb, nelec = int(cell.config["norb"]), tuple(cell.config["nelec"])
    ncore = int(cell.config.get("frozen_core", 0))
    if dump["norb"] != norb + ncore or tuple(dump["nelec"]) != (nelec[0] + ncore,
                                                                nelec[1] + ncore):
        raise ValueError(f"{cell.config['fcidump']} holds {dump['norb']} orbitals and "
                         f"{dump['nelec']} electrons, the configuration states {norb}, {nelec} "
                         f"with {ncore} frozen")
    h1, eri, ecore = dump["h1e"], dump["eri"], dump["ecore"]
    if ncore:
        h1, eri, ecore = freeze_core(h1, eri, ecore, ncore)
    return {"h1": h1, "eri": eri, "ecore": ecore, "norb": norb, "nelec": nelec}


def driver_of(cell: Cell):
    return load_module(cell.path("benchmark", "drivers", cell.traffic["driver"] + ".py"),
                       "benchmark_driver_" + cell.traffic["driver"])


@dataclass
class Run:
    """What a driver gets: the cell, the seed, the device and the mode."""

    cell: Cell
    seed: int
    device: object
    control: bool = False


def synchronize(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def run_window(run: Run, driver, state, seconds: float, probe=None) -> dict:
    """Requests back to back for ``seconds``; the one in flight completes.

    Returns the window's record: its seconds, each request's start, end and
    units of work, and the requests attempted and failed."""
    requests, failed = [], 0
    synchronize(run.device)
    t0 = time.perf_counter()
    with probe.span("window") if probe else contextlib.nullcontext():
        j = 0
        while True:
            start = time.perf_counter()
            try:
                with probe.span("request") if probe else contextlib.nullcontext():
                    units = driver.request(state, j)
                    synchronize(run.device)
            except Exception:  # a failed request counts and ends the window
                traceback.print_exc(file=sys.stderr)
                failed += 1
                break
            end = time.perf_counter()
            requests.append({"start": start - t0, "end": end - t0, "units": units})
            j += 1
            if end - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "requests": requests,
            "attempted": len(requests) + failed, "failed": failed}


def release(device) -> None:
    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.empty_cache()


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when all are within."""
    missing = sorted(set(limits) - set(numbers))
    extra = sorted(set(numbers) - set(limits))
    if missing or extra:
        raise ValueError(f"compared numbers {sorted(numbers)} do not match the limits "
                         f"{sorted(limits)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    return all(numbers[k] <= limits[k] for k in numbers), checks


def reader_of(cell: Cell, name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py`` or, where
    there is none, the file of the name's part before its first dot."""
    path = cell.path("benchmark", "metrics", name + ".py")
    if not os.path.exists(path):
        name = name.split(".")[0]
        path = cell.path("benchmark", "metrics", name + ".py")
    return load_module(path, "benchmark_metric_" + name.replace(".", "_"))


def read_metrics(cell: Cell, metrics: list, record: dict) -> dict:
    """Each metric's reader applied to the run's record; a reader that
    finds nothing to read returns ``None`` and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader_of(cell, m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def spans_and_counters(cell: Cell) -> tuple[dict, dict]:
    """The span and counter files (``benchmark/spans``, ``benchmark/counters``)
    that the cell's per-layer readers name, by name: a span added for
    another cell wraps nothing here."""
    spans, counters = set(), set()
    for m in cell.per_layer:
        reader = reader_of(cell, m["name"])
        spans.update(getattr(reader, "SPANS", ()))
        counters.update(getattr(reader, "COUNTERS", ()))

    def files(kind, names):
        return {n: load_json(cell.path("benchmark", kind, n + ".json")) for n in sorted(names)}
    return files("spans", spans), files("counters", counters)


def resolve(module: str, attr: str):
    """``(owner, name)`` of a dotted attribute of an imported module."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, name
