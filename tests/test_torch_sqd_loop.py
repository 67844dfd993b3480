# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's SQD loop against ``sqd_tpu.fermion.diagonalize_fermionic_hamiltonian``.

* With ``jax.random``'s Gumbel noise injected into configuration recovery
  (the port's ``_gumbel_noise`` replaced), the port follows ``sqd_tpu``'s
  string sets in every iteration, with batch energies within 1e-8 Ha and
  final occupancies within 1e-6, on the 6-orbital random system of
  ``tests/test_fermion_workflow.py``.
* With its own ``torch`` noise it reproduces the quickstart energy
  −107.652521 Ha within 5e-7 in at most 8 iterations.
* Its error messages equal ``sqd_tpu``'s.
* On ``chip_smoke.py``'s phase-6 problem, iteration 0 gives the strings that
  ``tools/make_sqd_loop_data.py`` recorded from ``sqd_tpu`` (host work only:
  a recording solver stub stands in for the solves).
* On phase 8's N2/cc-pVDZ problem (28 orbitals), iteration 0 gives, in both
  packages, the strings ``tools/make_ccpvdz_data.py`` recorded, and the
  port's solve of the recorded sub-batch gives ``sqd_tpu``'s energy.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.chem import Molecule, active_space_integrals, rhf
from sqd_tpu.ops import dense_fci
from sqd_tpu.primitives import BitArray as JaxBitArray

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import configuration_recovery, fermion
from sqd_tpu_torch.counts import generate_bit_array_uniform
from sqd_tpu_torch.models.fcidump import read_fcidump
from sqd_tpu_torch.primitives import BitArray

from test_torch_configuration_recovery import jax_gumbel_noise

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORB, NELEC = 6, (3, 3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def system():
    """``tests/test_fermion_workflow.py``'s random system and its samples:
    10k shots from the exact ground state plus 2k uniform-noise shots."""
    rng = np.random.default_rng(42)
    h1 = rng.normal(size=(NORB, NORB))
    h1 = (h1 + h1.T) / 2
    eri = rng.normal(size=(NORB,) * 4) * 0.2
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    eri = eri / 8
    strs = dense_fci.all_hamming_strings(NORB, NELEC[0])
    _, evecs = np.linalg.eigh(dense_fci.build_dense_hamiltonian(strs, strs, h1, eri))
    rng = np.random.default_rng(7)
    n = len(strs)
    probs = evecs[:, 0] ** 2
    draws = rng.choice(n * n, size=10_000, p=probs / probs.sum())
    shifts = np.arange(NORB - 1, -1, -1)
    rows = np.hstack([(strs[draws % n][:, None] >> shifts) & 1,
                      (strs[draws // n][:, None] >> shifts) & 1]).astype(bool)
    rows = np.vstack([rows, rng.integers(0, 2, size=(2_000, 2 * NORB)).astype(bool)])
    return {"h1": h1, "eri": eri, "strs": strs, "rows": rows}


def _loop_cases(strs):
    return {
        "plain": dict(samples_per_batch=60, num_batches=2, max_iterations=4, seed=12),
        "symmetrize_include": dict(
            samples_per_batch=40, num_batches=2, max_iterations=3, seed=5,
            symmetrize_spin=True, include_configurations=[int(strs[0]), int(strs[1])]),
        "max_dim_initial_occupancies": dict(
            samples_per_batch=60, num_batches=2, max_iterations=3, seed=3, max_dim=(12, 10),
            initial_occupancies=(np.full(NORB, 0.5), np.full(NORB, 0.5))),
        "include_pair_max_dim": dict(
            samples_per_batch=30, max_iterations=3, seed=1, max_dim=9,
            include_configurations=([int(strs[2])], [int(strs[3]), int(strs[4])])),
    }


@pytest.mark.parametrize("case", list(_loop_cases(np.arange(5))))
def test_injected_noise_follows_sqd_tpu(system, monkeypatch, case):
    monkeypatch.setattr(configuration_recovery, "_gumbel_noise", jax_gumbel_noise)
    kwargs = _loop_cases(system["strs"])[case]
    ref_history, history = [], []
    ref = jax_fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], JaxBitArray.from_bool_array(system["rows"]),
        norb=NORB, nelec=NELEC, callback=ref_history.append, **kwargs)
    out = fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], BitArray.from_bool_array(system["rows"]),
        norb=NORB, nelec=NELEC, callback=history.append, device="cpu", **kwargs)
    assert len(history) == len(ref_history) >= 2
    for batches, ref_batches in zip(history, ref_history):
        assert len(batches) == len(ref_batches)
        for res, ref_res in zip(batches, ref_batches):
            np.testing.assert_array_equal(res.sci_state.ci_strs_a, ref_res.sci_state.ci_strs_a)
            np.testing.assert_array_equal(res.sci_state.ci_strs_b, ref_res.sci_state.ci_strs_b)
            assert abs(res.energy - ref_res.energy) <= 1e-8
    assert abs(out.energy - ref.energy) <= 1e-8
    for o, r in zip(out.orbital_occupancies, ref.orbital_occupancies):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
    if kwargs.get("symmetrize_spin"):
        np.testing.assert_array_equal(out.sci_state.ci_strs_a, out.sci_state.ci_strs_b)


def test_quickstart_with_own_noise():
    """Uniform samples -> the port's loop -> the exact FCI energy
    (``tests/test_real_molecule_workflow.py``, quickstart cell 6)."""
    mf = rhf(Molecule([("N", (0, 0, 0)), ("N", (0, 0, 1.09768))], basis="sto-3g"))
    h1, eri, ecore = active_space_integrals(mf, ncas=8, nelecas=10)
    bit_array = generate_bit_array_uniform(10_000, 16, rand_seed=np.random.default_rng(24))
    energies = []
    result = fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, bit_array, samples_per_batch=50, norb=8, nelec=(5, 5),
        occupancies_tol=1e-7, max_iterations=30, symmetrize_spin=True,
        callback=lambda results: energies.append(min(r.energy for r in results) + ecore),
        seed=np.random.default_rng(32), device="cpu",
    )
    assert abs(result.energy + ecore - (-107.652521)) < 5e-7, energies
    assert len(energies) <= 8
    occ_a, occ_b = result.orbital_occupancies
    assert abs(occ_a.sum() - 5) < 1e-8 and abs(occ_b.sum() - 5) < 1e-8


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(max_iterations=0),
        dict(symmetrize_spin=True, nelec=(4, 2)),
        dict(symmetrize_spin=True, max_dim=(5, 6)),
        dict(rows="all_ones"),
    ],
    ids=["iterations", "symmetrize_nelec", "symmetrize_max_dim", "no_valid_rows"],
)
def test_error_messages_match(system, kwargs):
    kwargs = dict(kwargs)
    rows = system["rows"]
    if kwargs.pop("rows", None) == "all_ones":
        rows = np.ones((50, 2 * NORB), dtype=bool)
    kwargs = {"samples_per_batch": 10, "norb": NORB, "nelec": NELEC, "seed": 0, **kwargs}
    with pytest.raises(ValueError) as ref:
        jax_fermion.diagonalize_fermionic_hamiltonian(
            system["h1"], system["eri"], JaxBitArray.from_bool_array(rows), **kwargs)
    with pytest.raises(ValueError) as ours:
        fermion.diagonalize_fermionic_hamiltonian(
            system["h1"], system["eri"], BitArray.from_bool_array(rows), device="cpu", **kwargs)
    assert str(ours.value) == str(ref.value)


def test_solve_fermion_and_ci_strs_match(system):
    rows = system["rows"][:10_000:400]  # ground-state shots: valid weights
    for open_shell in (False, True):
        for o, r in zip(fermion.bitstring_matrix_to_ci_strs(rows, open_shell),
                        jax_fermion.bitstring_matrix_to_ci_strs(rows, open_shell)):
            np.testing.assert_array_equal(o, r)
    sel = np.sort(np.random.default_rng(1).choice(system["strs"], 8, replace=False))
    for inputs in ((sel, sel), rows):
        energy, state, occ, s2 = fermion.solve_fermion(
            inputs, system["h1"], system["eri"], device="cpu")
        ref_energy, ref_state, ref_occ, ref_s2 = jax_fermion.solve_fermion(
            inputs, system["h1"], system["eri"])
        assert abs(energy - ref_energy) < 1e-9 and abs(s2 - ref_s2) < 1e-8
        np.testing.assert_array_equal(state.ci_strs_a, ref_state.ci_strs_a)
        for o, r in zip(occ, ref_occ):
            np.testing.assert_allclose(o, r, atol=1e-6)


def test_card_record_iteration_zero():
    """``chip_smoke.py`` phase 6, iteration 0, with a recording stub solver:
    the batch strings hash to ``sqd_tpu``'s recorded digests."""
    smoke = _chip_smoke()
    with open(smoke.LOOP_DATA) as f:
        record = json.load(f)
    assert record["settings"] == dict(smoke.LOOP_SETTINGS, max_iterations=1)
    dump = read_fcidump(smoke.DATA_STEM + ".fcidump")
    seen = []

    def stub_solver(ci_strings, h1, h2, norb, nelec):
        seen.extend(ci_strings)
        return [
            fermion.SCIResult(0.0, fermion.SCIState(
                np.zeros((len(a), len(b))), a, b, norb, nelec, device="cpu"),
                orbital_occupancies=(np.zeros(norb), np.zeros(norb)))
            for a, b in ci_strings
        ]

    fermion.diagonalize_fermionic_hamiltonian(
        dump["h1e"], dump["eri"], BitArray.from_bool_array(smoke.loop_shots()), norb=16,
        nelec=(5, 5), sci_solver=stub_solver, device="cpu", **record["settings"])
    assert len(seen) == len(record["batches"]) == 3
    for (strs_a, strs_b), batch in zip(seen, record["batches"]):
        assert (len(strs_a), len(strs_b)) == (batch["n_alpha"], batch["n_beta"])
        assert min(len(strs_a), len(strs_b)) >= 900  # ~10^6 determinants per solve
        assert smoke.strings_digest(strs_a) == batch["sha256_alpha"]
        assert smoke.strings_digest(strs_b) == batch["sha256_beta"]


def _ccpvdz_record(smoke):
    with open(smoke.CCPVDZ_STEM + ".json") as f:
        return json.load(f)


def _recording_solver(seen, state_cls, result_cls, **state_kwargs):
    def solver(ci_strings, h1, h2, norb, nelec):
        seen.extend(ci_strings)
        return [
            result_cls(0.0, state_cls(np.zeros((len(a), len(b))), a, b, norb, nelec,
                                      **state_kwargs),
                       orbital_occupancies=(np.zeros(norb), np.zeros(norb)))
            for a, b in ci_strings
        ]
    return solver


def test_ccpvdz_record_iteration_zero():
    """``chip_smoke.py`` phase 8, iteration 0: the port's and ``sqd_tpu``'s
    batch strings both hash to the digests ``tools/make_ccpvdz_data.py``
    recorded, and every batch is past the sparse same-spin threshold."""
    smoke = _chip_smoke()
    record = _ccpvdz_record(smoke)
    assert record["settings"] == dict(smoke.CCPVDZ_SETTINGS, max_iterations=1)
    dump = read_fcidump(smoke.CCPVDZ_STEM + ".fcidump")
    shots = smoke.ccpvdz_shots()
    assert shots.shape == (smoke.CCPVDZ_SHOTS, 56)
    seen_port, seen_jax = [], []
    fermion.diagonalize_fermionic_hamiltonian(
        dump["h1e"], dump["eri"], BitArray.from_bool_array(shots), norb=28, nelec=(7, 7),
        sci_solver=_recording_solver(seen_port, fermion.SCIState, fermion.SCIResult,
                                     device="cpu"),
        device="cpu", **record["settings"])
    jax_fermion.diagonalize_fermionic_hamiltonian(
        dump["h1e"], dump["eri"], JaxBitArray.from_bool_array(shots), norb=28, nelec=(7, 7),
        sci_solver=_recording_solver(seen_jax, jax_fermion.SCIState, jax_fermion.SCIResult),
        **record["settings"])
    assert len(seen_port) == len(seen_jax) == len(record["batches"]) == 2
    for (strs_a, strs_b), (ref_a, ref_b), batch in zip(seen_port, seen_jax, record["batches"]):
        np.testing.assert_array_equal(strs_a, ref_a)
        np.testing.assert_array_equal(strs_b, ref_b)
        assert (len(strs_a), len(strs_b)) == (batch["n_alpha"], batch["n_beta"])
        assert min(len(strs_a), len(strs_b)) > 877  # past 4M same-spin probes
        assert smoke.strings_digest(strs_a) == batch["sha256_alpha"]
        assert smoke.strings_digest(strs_b) == batch["sha256_beta"]


def test_ccpvdz_data_and_sub_batch_energy():
    """The committed cc-pVDZ FCIDUMP equals ``sqd_tpu.chem``'s integrals
    (``<= 1e-11``: the active-space transform is symmetric only to ~1e-12),
    ``"auto"`` declines to factor them as in ``sqd_tpu`` (rank 365 >
    784 // 3), and the port's f64 ``solve_sci`` on the recorded sub-batch is
    within 1e-8 Ha of ``sqd_tpu``'s recorded energy."""
    from sqd_tpu_torch.ops.hamiltonian import pivoted_cholesky_pairs

    smoke = _chip_smoke()
    record = _ccpvdz_record(smoke)
    mf = rhf(Molecule([("N", (0, 0, 0)), ("N", (1.0977, 0, 0))], basis="cc-pvdz"))
    h1, eri, ecore = active_space_integrals(mf, ncas=28, nelecas=14)
    dump = read_fcidump(smoke.CCPVDZ_STEM + ".fcidump")
    assert dump["norb"] == 28 and dump["nelec"] == (7, 7)
    np.testing.assert_allclose(dump["h1e"], h1, rtol=0, atol=1e-11)
    np.testing.assert_allclose(dump["eri"], eri, rtol=0, atol=1e-11)
    assert abs(dump["ecore"] - ecore) <= 1e-12 and record["ecore"] == dump["ecore"]
    assert abs(record["rhf_energy"] - mf.e_tot) <= 1e-10
    assert record["cholesky_rank_auto"] is None
    assert pivoted_cholesky_pairs(dump["eri"], 28, max_rank=28 * 28 // 3) is None
    factor = pivoted_cholesky_pairs(dump["eri"], 28)
    assert factor.shape == (record["cholesky_rank_uncapped"], 784)

    seen = []
    fermion.diagonalize_fermionic_hamiltonian(
        dump["h1e"], dump["eri"], BitArray.from_bool_array(smoke.ccpvdz_shots()), norb=28,
        nelec=(7, 7), sci_solver=_recording_solver(seen, fermion.SCIState, fermion.SCIResult,
                                                   device="cpu"),
        device="cpu", **record["settings"])
    sub = tuple(s[: smoke.CCPVDZ_SUB_BATCH] for s in seen[0])
    out = fermion.solve_sci(sub, dump["h1e"], dump["eri"], 28, (7, 7), device="cpu")
    assert abs(out.energy - record["sub_batch"]["energy"]) <= 1e-8
    assert out.energy + dump["ecore"] < record["rhf_energy"]
