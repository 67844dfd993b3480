# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's small host modules against ``sqd_tpu``'s on the CPU:
``models.hubbard`` (equal arrays), ``models.fcidump.write_fcidump`` (the same
file text as ``sqd_tpu``'s writer, read back by both readers within 1e-15
relative: 17 significant digits), ``utils.tracing.IterationLogger`` (the same
history) and ``profile_trace`` (a Chrome trace holding the traced ops)."""

import json
import logging

import numpy as np
import pytest
import torch

from sqd_tpu.models import fcidump as jax_fcidump
from sqd_tpu.models import hubbard as jax_hubbard
from sqd_tpu.utils import tracing as jax_tracing

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion
from sqd_tpu_torch.models import fcidump, hubbard
from sqd_tpu_torch.utils import tracing

torch.set_num_threads(2)


@pytest.mark.parametrize("nsites,u,t,periodic", [(2, 4.0, 1.0, True), (6, 2.5, 0.7, True),
                                                 (5, 1.0, 1.0, False)])
def test_hubbard_chain_matches(nsites, u, t, periodic):
    ours = hubbard.hubbard_integrals(nsites, u, t=t, periodic=periodic)
    theirs = jax_hubbard.hubbard_integrals(nsites, u, t=t, periodic=periodic)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nx,ny,periodic", [(2, 3, False), (3, 3, True), (4, 2, True)])
def test_hubbard_2d_matches(nx, ny, periodic):
    ours = hubbard.hubbard_2d_integrals(nx, ny, 3.0, t=0.5, periodic=periodic)
    theirs = jax_hubbard.hubbard_2d_integrals(nx, ny, 3.0, t=0.5, periodic=periodic)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _symmetric_integrals(norb, seed):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    eri = rng.normal(size=(norb,) * 4)
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    eri[np.abs(eri) < 0.3] = 0.0  # some elements below the writer's tolerance
    return (h1 + h1.T) / 2, eri / 8


@pytest.mark.parametrize("nelec,ecore", [((3, 2), -7.25), (4, 0.0)])
def test_write_fcidump_round_trip(tmp_path, nelec, ecore):
    h1, eri = _symmetric_integrals(5, 9)
    fcidump.write_fcidump(tmp_path / "ours", h1, eri, nelec=nelec, ecore=ecore)
    jax_fcidump.write_fcidump(tmp_path / "theirs", h1, eri, nelec=nelec, ecore=ecore)
    assert (tmp_path / "ours").read_text() == (tmp_path / "theirs").read_text()
    expected_nelec = nelec if isinstance(nelec, tuple) else (2, 2)
    for reader in (fcidump.read_fcidump, jax_fcidump.read_fcidump):
        back = reader(tmp_path / "ours")
        assert back["norb"] == 5 and back["nelec"] == expected_nelec
        assert back["ecore"] == ecore
        np.testing.assert_allclose(back["h1e"], h1, rtol=1e-15, atol=0)
        np.testing.assert_allclose(back["eri"], eri, rtol=1e-15, atol=0)


class _Result:
    """What the logger reads of an ``SCIResult``."""

    def __init__(self, energy, dims, occ):
        self.energy = energy
        self.sci_state = type("State", (), {"ci_strs_a": np.arange(dims[0]),
                                            "ci_strs_b": np.arange(dims[1])})()
        self.orbital_occupancies = occ


def test_iteration_logger_matches(caplog):
    iterations = [
        [_Result(-1.5, (3, 4), (np.ones(2), np.zeros(2))),
         _Result(-1.75, (5, 5), (np.zeros(2), np.ones(2)))],
        [_Result(-1.8, (6, 2), (np.full(2, 0.5), np.full(2, 0.25)))],
    ]
    ours, theirs = tracing.IterationLogger(), jax_tracing.IterationLogger(log_level=None)
    with caplog.at_level(logging.INFO, logger="sqd_tpu_torch"):
        for results in iterations:
            ours(results)
            theirs(results)
    assert tracing.logger.name == "sqd_tpu_torch"
    assert [r.getMessage().split(",")[0] for r in caplog.records] == [
        "SQD iteration 0: best energy -1.7500000000", "SQD iteration 1: best energy -1.8000000000"]
    assert ours.energies == theirs.energies == [-1.75, -1.8]
    for a, b in zip(ours.history, theirs.history):
        for key in ("iteration", "best_energy", "energies", "subspace_dims"):
            assert a[key] == b[key]
        for x, y in zip(a["occupancies"], b["occupancies"]):
            np.testing.assert_array_equal(x, y)
        assert a["wall_seconds"] >= 0


def test_iteration_logger_in_the_loop():
    strs = np.array([0b011, 0b101, 0b110])
    rows = np.array([[(s >> 2) & 1, (s >> 1) & 1, s & 1] * 2 for s in strs], dtype=bool)
    h1, eri = hubbard.hubbard_integrals(3, 2.0)
    from sqd_tpu_torch.primitives import BitArray

    log = tracing.IterationLogger(log_level=None)
    best = fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, BitArray.from_bool_array(rows), 3, 3, (2, 2), max_iterations=2, seed=1,
        callback=log, device="cpu")
    assert [h["iteration"] for h in log.history] == list(range(len(log.history)))
    assert min(log.energies) == best.energy


def test_profile_trace_writes_chrome_trace(tmp_path):
    a = torch.ones(64, 64, dtype=torch.float64)
    with tracing.profile_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
