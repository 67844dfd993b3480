# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port stands alone: no JAX and no ``sqd_tpu`` behind it, no CPU fallback
for a CUDA request, and ``chip_smoke.py`` fails without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sqd_tpu_torch import configuration_recovery, fermion, qubit, subsampling
from sqd_tpu_torch.ops import pauli_proj
from sqd_tpu_torch.primitives import BitArray, SparsePauliOp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
import sqd_tpu_torch
for info in pkgutil.walk_packages(sqd_tpu_torch.__path__, "sqd_tpu_torch."):
    __import__(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sqd_tpu"))
print(",".join(sorted(m for m in sys.modules if m.startswith("sqd_tpu_torch"))), bad)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_import_pulls_in_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=120, check=True,
    )
    names, bad = proc.stdout.strip().split(" ", 1)
    names = set(names.split(","))
    assert len(names) >= 20  # the package, its subpackages and modules
    for module in ("counts", "primitives", "subsampling", "configuration_recovery",
                   "ops.sampling", "ops.table_cache", "utils.deprecation", "utils.device",
                   "qubit", "ops.pauli_proj", "models.heisenberg", "ops.dense_df"):
        assert f"sqd_tpu_torch.{module}" in names
    assert bad == "[]"


_IMPORT_PACKAGE = """
import sys
import sqd_tpu_torch
import torch
from sqd_tpu_torch import build
names = ("solve_sci", "diagonalize_fermionic_hamiltonian", "rotate_integrals", "qubit",
         "BitArray", "recover_configurations", "subsample", "counts_to_arrays")
print(all(hasattr(sqd_tpu_torch, n) for n in names),
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sqd_tpu")),
      build.build_seconds, torch.cuda.is_initialized())
"""


def test_package_import_reexports_without_jax_build_or_device():
    """``import sqd_tpu_torch`` alone gives the re-exported API, and imports no
    JAX, builds or loads no native library and initialises no device."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_PACKAGE], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert proc.stdout.strip() == "True [] {} False"


def test_cuda_request_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    strs = np.array([0b111, 0b1011])
    with pytest.raises(RuntimeError, match="cuda"):
        fermion.solve_sci((strs, strs), np.eye(4), np.zeros((4,) * 4), 4, (3, 3), device="cuda")


_H1, _ERI = np.eye(4), np.zeros((4,) * 4)
_STRS = np.array([0b111, 0b1011])
_ROWS = np.array([[0, 1, 1, 1, 0, 1, 1, 1]] * 4, dtype=bool)
_HAM = SparsePauliOp.from_list([("XXII", 1.0), ("ZIIZ", 0.5)])
_PACKED = np.array([[0b0111], [0b1011]], dtype=np.uint32)
ENTRY_POINTS = {
    "solve_sci": lambda: fermion.solve_sci((_STRS, _STRS), _H1, _ERI, 4, (3, 3)),
    "SCIState": lambda: fermion.SCIState(np.zeros((2, 2)), _STRS, _STRS, 4, (3, 3)),
    "solve_sci_batch": lambda: fermion.solve_sci_batch([(_STRS, _STRS)], _H1, _ERI, 4, (3, 3)),
    "solve_fermion": lambda: fermion.solve_fermion((_STRS, _STRS), _H1, _ERI),
    "diagonalize_fermionic_hamiltonian": lambda: fermion.diagonalize_fermionic_hamiltonian(
        _H1, _ERI, BitArray.from_bool_array(_ROWS), 2, 4, (3, 3)),
    "recover_configurations": lambda: configuration_recovery.recover_configurations(
        _ROWS, np.full(4, 0.25), (np.full(4, 0.75), np.full(4, 0.75)), 3, 3),
    "subsample_device": lambda: subsampling.subsample_device(
        np.eye(8, dtype=bool), np.full(8, 0.125), 2, 3, torch.Generator()),
    "solve_qubit_device": lambda: qubit.solve_qubit_device(_ROWS[:, :4], _HAM),
    "solve_qubit": lambda: qubit.solve_qubit(_ROWS[:, :4], _HAM),
    "project_operator_to_subspace": lambda: qubit.project_operator_to_subspace(_ROWS[:, :4], _HAM),
    "matrix_elements_from_pauli": lambda: qubit.matrix_elements_from_pauli(
        _ROWS[:, :4], _HAM.paulis[0]),
    "build_projected_operator": lambda: pauli_proj.build_projected_operator(
        _PACKED, _HAM.paulis, _HAM.coeffs),
    "pauli_term_table": lambda: pauli_proj.pauli_term_table(_PACKED, _HAM.paulis[0]),
}


@pytest.mark.parametrize("entry_point", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, entry_point):
    """Called with no device and no card, every entry point raises: none falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry_point]()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """From the repo root, and as a lone file in an empty directory."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = tmp_path
    else:
        cwd = ROOT
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
