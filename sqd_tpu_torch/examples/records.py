# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The examples' printed lines against ``sqd_tpu``'s record of them.

``sqd_tpu_torch/data/example_records.json`` (``tools/make_example_records.py``)
holds, for each example and size, the calls made and the lines that the
``sqd_tpu`` example of the same name printed.  :func:`load_records` marks
each line with its kind by :func:`classify`, whose per-example rules are the
one place that knows an example's print format:

* ``exact`` — numbers that no recovery noise touches: dense-oracle and exact
  energies, mean fields, solves on fixed strings, a loop's first iteration;
* ``loop`` — numbers that follow the loop's recovery noise (later
  iterations, the loop's result);
* ``time`` — a line of timings: the port's line may go on past the
  record's (the device it ran on);
* ``device`` / ``path`` — a line that names a device or a file: not compared.

:func:`compare` holds a port example's lines to the record: every line (the
same lines in the same order) when the loops ran on ``sqd_tpu``'s noise, and
the ``exact`` and ``time`` lines alone when they ran on the port's own.  A
number agrees within ``TOL`` (absolute), an integer exactly; a number
printed with fewer than seven decimals cannot resolve ``TOL``, so there one
unit of its last printed decimal is allowed (the two values rounded to
either side of a rounding boundary).  Times (a number followed by ``s`` or
``ms``) are never compared.  :func:`variational_violations` checks
that each energy an example prints from a variational solve lies no lower
than the exact energy it prints, less ``VARIATIONAL_SLACK``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import sys

__all__ = [
    "EXAMPLES",
    "RECORDS_PATH",
    "SIZES",
    "TOL",
    "capture",
    "classify",
    "compare",
    "load_example",
    "load_records",
    "run_calls",
    "variational_violations",
]

TOL = 1e-7  # Ha, and any other printed number
VARIATIONAL_SLACK = 1e-8  # Ha
EXAMPLES_DIR = os.path.dirname(os.path.abspath(__file__))
RECORDS_PATH = os.path.join(os.path.dirname(EXAMPLES_DIR), "data", "example_records.json")

EXAMPLES = (
    "01_quickstart",
    "02_pauli_projection",
    "03_open_closed_shell",
    "04_orbital_optimization",
    "05_mesh_scale_out",
    "06_checkpoint_resume",
    "07_benchmark_pauli_projection",
    "08_fcidump_workflow",
    "09_choose_subspace_dimension",
    "10_excitation_augmentation",
    "11_real_molecule_n2",
    "12_excited_states",
    "13_large_active_space",
    "14_ccpvdz_n2",
    "15_multiprocess_cluster",
    "16_open_shell_rohf",
)

# the calls of each size: (function, positional arguments, keyword arguments).
# "guide" is the guide's own size (the card's); "test" is the CPU tests' size
# where it is smaller (as tests/test_examples.py runs 07 and 14)
SIZES = {name: {"guide": [("main", [], {})]} for name in EXAMPLES}
SIZES["07_benchmark_pauli_projection"]["test"] = [("run", [40, [20_000]], {}),
                                                  ("run", [70, [20_000]], {})]
SIZES["14_ccpvdz_n2"]["test"] = [
    ("main", [], {"n_shots": 1_500, "samples_per_batch": 40, "max_iterations": 2})]
# keyword arguments only the port's example takes: 05 sizes num_batches from
# the world size, sqd_tpu's from its 8 virtual CPU devices
PORT_KWARGS = {"05_mesh_scale_out": {"num_batches": 8}}

EXACT, LOOP, TIME, DEVICE, PATH = "exact", "loop", "time", "device", "path"
_ITERATION, _INHERIT = "iteration", "inherit"  # resolved to exact or loop by position

# per example: (pattern, kind), the first match decides; unmatched lines are exact.
# An "iteration" line opens an iteration's block: the first block is exact
# (iteration 0 postselects and subsamples on the loop's NumPy stream only),
# later ones follow the noise; "inherit" lines belong to the open block.
_RULES = {
    "01_quickstart": [(r"^iteration \d+:", _ITERATION), (r"^(SQD energy|error vs FCI)", LOOP)],
    "05_mesh_scale_out": [(r"^devices:", DEVICE), (r"^SQD energy", LOOP)],
    "06_checkpoint_resume": [(r"^  (checkpointed at|resumed final|uninterrupted) E", LOOP)],
    "07_benchmark_pauli_projection": [(r"^n=", TIME)],
    "08_fcidump_workflow": [(r"^wrote ", PATH), (r"^(electronic|total) energy", LOOP)],
    "09_choose_subspace_dimension": [(r"^\s+\d+\s+\d+ x \d+", LOOP)],
    "11_real_molecule_n2": [(r"^Iteration \d+", _ITERATION), (r"^  ", _INHERIT),
                            (r"^Final SQD energy", LOOP)],
    "14_ccpvdz_n2": [(r"^  iteration \d+:", _ITERATION),
                     (r"^(SQD energy|Correlation captured)", LOOP)],
    "16_open_shell_rohf": [(r"^  iteration \d+:", _ITERATION), (r"^SQD energy", LOOP)],
}

# per example: (pattern of the exact energy, patterns of variational energies),
# each with one group capturing the number
_VARIATIONAL = {
    "01_quickstart": (r"^exact ground-state energy: (\S+)",
                      [r"^iteration \d+: best energy (\S+)", r"^SQD energy:\s+(\S+)"]),
    "04_orbital_optimization": (r"^exact FCI .*:\s+(\S+)",
                                [r"^truncated-subspace energy .*: (\S+)",
                                 r"^after orbital optimization:\s+(\S+)"]),
    "05_mesh_scale_out": (r"^exact:\s+(\S+)", [r"^SQD energy .*: (\S+)"]),
    "09_choose_subspace_dimension": (r"^full CI: .* E = (\S+)",
                                     [r"^\s+\d+\s+\d+ x \d+\s+(\S+)"]),
    "10_excitation_augmentation": (r"^exact:\s+E = (\S+)", [r"-> E = (\S+)"]),
    "15_multiprocess_cluster": (r"^dense oracle:\s+(\S+)", [r"^rank \d energy: (\S+)"]),
    "16_open_shell_rohf": (r"^dense CAS.*: (\S+) Ha",
                           [r"^  iteration \d+: E = (\S+)", r"^SQD energy: (\S+)"]),
}

_PATH = re.compile(r"(?<![\w.])/[^\s()]+")
_NUMBER = re.compile(r"[-+]?(?:\d{1,3}(?:,\d{3})+|\d+)(?:\.\d+)?(?:[eE][-+]?\d+)?")
_TIME_UNIT = re.compile(r"\s*(ms|s)\b")


def load_example(name: str, directory: str = EXAMPLES_DIR):
    """The example ``name`` (``"01_quickstart"``) as a module, loaded by path
    from ``directory`` (the port's examples by default)."""
    path = os.path.join(directory, name + ".py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(spec.name, None)
    return module


def load_records(path: str = RECORDS_PATH) -> dict:
    """The record, each size's ``lines`` as ``(kind, line)`` pairs."""
    with open(path) as f:
        out = json.load(f)
    for name, sizes in out.items():
        for entry in sizes.values():
            entry["lines"] = list(zip(classify(name, entry["lines"]), entry["lines"]))
    return out


def capture(fn, *args, **kwargs) -> tuple[list[str], object]:
    """``fn``'s printed lines (its standard output) and its result."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    return buf.getvalue().splitlines(), result


def run_calls(module, calls, **extra) -> tuple[list[str], list]:
    """The lines that ``module``'s calls (a size's list from :data:`SIZES`)
    print, each call given ``extra`` keyword arguments too, and the calls'
    results."""
    lines, results = [], []
    for fn_name, args, kwargs in calls:
        out, result = capture(getattr(module, fn_name), *args, **kwargs, **extra)
        lines += out
        results.append(result)
    return lines, results


def classify(name: str, lines: list[str]) -> list[str]:
    """Each line's kind (see the module's docstring)."""
    rules = [(re.compile(p), kind) for p, kind in _RULES.get(name, [])]
    kinds, block, first_block = [], EXACT, None
    for line in lines:
        kind = next((k for pattern, k in rules if pattern.search(line)), EXACT)
        if kind == _ITERATION:
            number = re.search(r"\d+", line).group()
            first_block = number if first_block is None else first_block
            block = kind = EXACT if number == first_block else LOOP
        elif kind == _INHERIT:
            kind = block
        elif first_block is not None:
            block = LOOP  # a line past an iteration's block closes it
        kinds.append(kind)
    return kinds


def _split(line: str):
    """The line's text with paths and numbers masked, and its numbers as
    ``(text, is_time)`` pairs."""
    line = _PATH.sub("<path>", line)
    numbers = []
    for match in _NUMBER.finditer(line):
        numbers.append((match.group(), bool(_TIME_UNIT.match(line, match.end()))))
    # a run of spaces counts as one: widths padded to the number printed
    return re.sub(r"\s+", " ", _NUMBER.sub("#", line)), numbers


def _number_error(ours: str, theirs: str) -> str | None:
    a, b = float(ours.replace(",", "")), float(theirs.replace(",", ""))
    if re.fullmatch(r"[-+]?[\d,]+", theirs):
        return None if a == b else f"{ours} != {theirs}"
    decimals = len(theirs.split(".")[1]) if "." in theirs and "e" not in theirs.lower() else None
    tol = TOL if decimals is None or decimals >= 7 else max(TOL, 10.0 ** -decimals * (1 + 1e-9))
    if abs(a - b) <= tol:
        return None
    return f"{ours} vs {theirs} (|diff| {abs(a - b):.3e} > {tol:.1e})"


def _line_errors(ours: str, theirs: str, kind: str) -> list[str]:
    text_o, nums_o = _split(ours)
    text_t, nums_t = _split(theirs)
    if kind == TIME:  # the port's line may go on (the device it ran on)
        text_o, nums_o = text_o[: len(text_t)], nums_o[: len(nums_t)]
    if text_o != text_t or len(nums_o) != len(nums_t):
        return [f"line {ours!r} is not {theirs!r}"]
    errors = []
    for (a, time_a), (b, _) in zip(nums_o, nums_t):
        if time_a:
            continue
        err = _number_error(a, b)
        if err:
            errors.append(f"{err} in {ours!r}")
    return errors


def compare(name: str, recorded: list[list[str]], lines: list[str], *, all_lines=True) -> list[str]:
    """The differences of a port example's printed ``lines`` from the record's
    ``(kind, line)`` pairs: every line when ``all_lines``, else the ``exact``
    and ``time`` lines alone (the loops ran on other noise).  Empty when they
    agree."""
    kinds = classify(name, lines)
    pairs = [(k, t) for k, t in recorded]
    ours = list(zip(kinds, lines))
    if not all_lines:
        pairs = [(k, t) for k, t in pairs if k in (EXACT, TIME)]
        ours = [(k, t) for k, t in ours if k in (EXACT, TIME)]
    if len(pairs) != len(ours):
        return [f"{len(ours)} lines where the record has {len(pairs)}: {[t for _, t in ours]}"]
    errors = []
    for (k_o, line_o), (k_t, line_t) in zip(ours, pairs):
        if k_o != k_t:
            errors.append(f"line {line_o!r} is {k_o}, the record's {line_t!r} {k_t}")
        elif k_t not in (DEVICE, PATH):
            errors += _line_errors(line_o, line_t, k_t)
    return errors


def variational_violations(name: str, lines: list[str]) -> list[str]:
    """The printed variational energies that lie below the printed exact
    energy less ``VARIATIONAL_SLACK`` (empty where the example prints none)."""
    if name not in _VARIATIONAL:
        return []
    exact_pattern, patterns = _VARIATIONAL[name]
    exact = [float(m.group(1)) for line in lines if (m := re.search(exact_pattern, line))]
    if len(exact) != 1:
        return [f"{len(exact)} exact energies printed"]
    found = [(float(m.group(1)), line) for line in lines for p in patterns
             if (m := re.search(p, line))]
    if not found:
        return ["no variational energy printed"]
    return [f"{line!r} lies below the exact {exact[0]}" for e, line in found
            if e < exact[0] - VARIATIONAL_SLACK]
