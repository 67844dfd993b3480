# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where ``sqd_tpu`` runs ``davidson_ground_state_segmented``, the port runs
its own, with the same arguments: ``solve_sci(matvec_strategy="dense_df")``,
both stages of ``solve_qubit_device`` and ``bench_torch.py``'s config-5
section.

Each segment restarts the Krylov space from the current Ritz vector, so a
segmented solve takes other iterations than an unsegmented one, and at
config 5 in f32 it converges where the unsegmented one stalls at its cap.
The segments are counted by wrapping ``davidson_ground_state`` where each
package reaches it by name.  In f64 the two packages take the same
iterations segment by segment; in f32 their rounding differs, so there the
port's solve must converge through 25-iteration segments, and its f64
energy agree with ``sqd_tpu``'s.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sqd_tpu.ops.davidson as jax_davidson
from sqd_tpu import fermion as jax_fermion
from sqd_tpu import qubit as jax_qubit
from sqd_tpu.models.heisenberg import heisenberg_ring as jax_heisenberg_ring
from sqd_tpu.ops import bitpack as jax_bitpack
from sqd_tpu.ops import dense_df as jax_dense_df
from sqd_tpu.ops import dense_fci
from sqd_tpu.ops import hamiltonian as jax_ham

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion, qubit
from sqd_tpu_torch.models.heisenberg import heisenberg_ring
from sqd_tpu_torch.ops import davidson

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT = 25  # davidson_ground_state_segmented's default, and sqd_tpu's f64 stage's below 1.2e6
TOL_ENERGY = 1e-10  # Ha, f64 solves of the same operator to the same residual
TOL_CONFIG5 = 2e-8  # Ha, as tests/test_torch_bench.py: both f32 solves stop at r < 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record_segments(monkeypatch, *owners):
    """Wrap ``davidson_ground_state`` in each of ``owners`` that holds it;
    returns the list of ``(bits, iterations, converged)`` of every call."""
    calls = []
    for owner in owners:
        fn = getattr(owner, "davidson_ground_state", None)
        if fn is None:
            continue

        def wrapper(matvec, operator, hdiag, v0, _fn=fn, **kwargs):
            out = _fn(matvec, operator, hdiag, v0, **kwargs)
            calls.append((8 * v0.dtype.itemsize, int(out.iterations), bool(out.converged)))
            return out

        monkeypatch.setattr(owner, "davidson_ground_state", wrapper)
    return calls


def _iterations(calls):
    return [(bits, its) for bits, its, _ in calls]


def _assert_segmented(calls):
    """Every segment but the last of a run ran its full 25 iterations, and the
    run converged."""
    assert calls and calls[-1][2]
    assert all(its == SEGMENT and not done for _, its, done in calls[:-1])
    assert calls[-1][1] <= SEGMENT


def test_solve_sci_dense_df_segments_as_sqd_tpu(monkeypatch):
    """``tests/test_torch_dense_df.py``'s 17-orbital problem in f64 at tol
    1e-10: two segments, the same iterations in each as ``sqd_tpu``'s."""
    norb, nelec = 17, (3, 3)
    rng = np.random.default_rng(21)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    ch = rng.normal(size=(3 * norb, norb, norb)) * (0.4 / np.sqrt(3 * norb))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    all_s = dense_fci.all_hamming_strings(norb, 3)
    strs = (np.sort(rng.choice(all_s, 25, replace=False)),
            np.sort(rng.choice(all_s, 25, replace=False)))
    theirs = _record_segments(monkeypatch, jax_davidson, jax_fermion)
    ref = jax_fermion.solve_sci(strs, h1, eri, norb, nelec, matvec_strategy="dense_df", tol=1e-10)
    ours = _record_segments(monkeypatch, davidson, fermion)
    got = fermion.solve_sci(strs, h1, eri, norb, nelec, matvec_strategy="dense_df", tol=1e-10,
                            device="cpu")
    assert len(theirs) >= 2 and _iterations(ours) == _iterations(theirs)
    _assert_segmented(ours)
    assert abs(got.energy - ref.energy) < TOL_ENERGY


@pytest.fixture(scope="module")
def ring():
    """A real 12-site Heisenberg ring (J_xy 1, J_z 0.8, h_z 0.3) on the 1581
    unique strings of 2000 draws (seed 3), as a bool matrix."""
    n = 12
    ints = np.unique(np.random.default_rng(3).integers(0, 1 << n, size=2000, dtype=np.int64))
    mat = ((ints[:, None] >> np.arange(n - 1, -1, -1)) & 1).astype(bool)
    return mat, heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3), jax_heisenberg_ring(n, 1.0, 1.0, 0.8, 0.3)


def test_solve_qubit_device_f64_stage_segments_as_sqd_tpu(monkeypatch, ring):
    """The f64 stage alone (``dtype=float64``): three segments, the same
    iterations in each as ``sqd_tpu``'s."""
    mat, op, jop = ring
    theirs = _record_segments(monkeypatch, jax_davidson)
    e_ref, _, _ = jax_qubit.solve_qubit_device(mat, jop, dtype=jnp.float64)
    ours = _record_segments(monkeypatch, davidson, qubit)
    energy, _, _ = qubit.solve_qubit_device(mat, op, dtype=torch.float64, device="cpu")
    assert len(theirs) >= 2 and _iterations(ours) == _iterations(theirs)
    _assert_segmented(ours)
    assert abs(energy - e_ref) < TOL_ENERGY


def test_solve_qubit_device_two_stages_are_segmented(monkeypatch, ring):
    """The default f32 then f64 solve: each stage converges in 25-iteration
    segments (the f32 stage needs more than one), and the energy is
    ``sqd_tpu``'s."""
    mat, op, jop = ring
    e_ref, _, _ = jax_qubit.solve_qubit_device(mat, jop)
    calls = _record_segments(monkeypatch, davidson, qubit)
    energy, vec, _ = qubit.solve_qubit_device(mat, op, device="cpu")
    coarse = [c for c in calls if c[0] == 32]
    fine = [c for c in calls if c[0] == 64]
    assert calls == coarse + fine and len(coarse) >= 2
    _assert_segmented(coarse)
    _assert_segmented(fine)
    assert abs(energy - e_ref) < 1e-8 and abs(np.linalg.norm(vec) - 1.0) < 1e-10


def test_config5_section_converges_as_sqd_tpu(monkeypatch):
    """``bench_torch.config5_section`` at 96 x 96 strings: converged below
    tol 1e-4 in 25-iteration segments, far under the 200-iteration cap where
    the unsegmented f32 solve stalls, its f64 energy within 2e-8 Ha of
    ``bench.py``'s segmented solve through ``sqd_tpu``."""
    bench_torch = _load("bench_torch")
    calls = _record_segments(monkeypatch, davidson, bench_torch)
    got = bench_torch.config5_section("cpu", 96)
    assert got["residual_norm"] < 1e-4 and got["iterations"] < 200
    half = len(calls) // 2  # the warm-up solve, then the timed one
    assert calls[:half] == calls[half:] and sum(c[1] for c in calls[half:]) == got["iterations"]
    _assert_segmented(calls[half:])
    h1, eri, strs = bench_torch.config5_problem(96)
    packed = jax_bitpack.pack_ints(strs, 36)
    ham64 = jax_ham.build_sci_hamiltonian(packed, packed, h1, eri, 36, (27, 27),
                                          dtype=jnp.float64)
    hd32 = ham64.hdiag.astype(jnp.float32).reshape(-1)
    res = jax_davidson.davidson_ground_state_segmented(
        jax_dense_df.dense_df_matvec_flat, jax_dense_df.densify(ham64, dtype=jnp.float32), hd32,
        jax_davidson.davidson_initial_guess(hd32, jnp.float32), tol=1e-4, max_subspace=12,
        max_iterations=200)
    assert bool(res.converged)
    e64 = float(jax_ham.expectation_value(ham64, res.vector))
    assert abs(got["energy_f64_eval"] - e64) < TOL_CONFIG5
