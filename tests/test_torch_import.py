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

from sqd_tpu_torch import fermion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
import sqd_tpu_torch
for info in pkgutil.walk_packages(sqd_tpu_torch.__path__, "sqd_tpu_torch."):
    __import__(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sqd_tpu"))
print(len([m for m in sys.modules if m.startswith("sqd_tpu_torch")]), bad)
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
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 12  # the package, its subpackages and modules
    assert bad == "[]"


def test_cuda_request_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    strs = np.array([0b111, 0b1011])
    with pytest.raises(RuntimeError, match="cuda"):
        fermion.solve_sci((strs, strs), np.eye(4), np.zeros((4,) * 4), 4, (3, 3), device="cuda")


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
