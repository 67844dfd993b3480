# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``SCIState`` files and SQD-loop checkpoints of the port against
``sqd_tpu``'s on the CPU.

* A state file and a loop checkpoint written by either package load in the
  other, equal field for field, in both layouts: int64 CI strings below 63
  orbitals, packed uint32 words from 63 up.
* A port loop stopped after iteration 1 and resumed equals the same loop run
  uninterrupted, bit for bit (energies, strings, occupancies); a resumed
  loop with nothing left to run returns the saved best with its RDMs
  reattached (within 1e-12 of the solve's own).
* The port resumes from a checkpoint ``sqd_tpu`` wrote.
"""

import numpy as np
import pytest
import torch

from sqd_tpu import fermion as jax_fermion
from sqd_tpu.primitives import BitArray as JaxBitArray
from sqd_tpu.utils import checkpoint as jax_checkpoint

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion
from sqd_tpu_torch.primitives import BitArray
from sqd_tpu_torch.utils import checkpoint

from test_torch_sqd_loop import NELEC, NORB, system  # noqa: F401  (fixture)

torch.set_num_threads(2)

LOOP = dict(samples_per_batch=60, num_batches=2, max_iterations=3, seed=12)


def _strings(norb, count, seed):
    """``count`` distinct CI strings of ``norb`` bits and 2 electrons; object
    ints from 63 orbitals up, as the packages keep them."""
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < count:
        p, q = sorted(rng.choice(norb, 2, replace=False))
        pairs.add((1 << int(p)) | (1 << int(q)))
    return np.array(sorted(pairs), dtype=object if norb >= 63 else np.int64)


@pytest.mark.parametrize("norb", [10, 70])
def test_scistate_file_crosses_packages(tmp_path, norb):
    strs_a, strs_b = _strings(norb, 5, 1), _strings(norb, 4, 2)
    amps = np.random.default_rng(3).normal(size=(5, 4))
    ours = fermion.SCIState(amps, strs_a, strs_b, norb, (2, 2), device="cpu")
    theirs = jax_fermion.SCIState(amps, strs_a, strs_b, norb, (2, 2))
    ours.save(tmp_path / "ours.npz")
    theirs.save(tmp_path / "theirs.npz")
    with np.load(tmp_path / "ours.npz", allow_pickle=False) as a, \
            np.load(tmp_path / "theirs.npz", allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        assert ("ci_strs_a_packed" in a.files) == (norb >= 63)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    for loaded in (jax_fermion.SCIState.load(tmp_path / "ours.npz"),
                   fermion.SCIState.load(tmp_path / "theirs.npz", device="cpu"),
                   fermion.SCIState.load(tmp_path / "ours.npz", device="cpu")):
        np.testing.assert_array_equal(loaded.amplitudes, amps)
        assert list(loaded.ci_strs_a) == list(strs_a)
        assert list(loaded.ci_strs_b) == list(strs_b)
        assert int(loaded.norb) == norb and tuple(int(x) for x in loaded.nelec) == (2, 2)
    back = fermion.SCIState.load(tmp_path / "theirs.npz", device="cpu")
    assert back.device == torch.device("cpu")
    np.testing.assert_allclose(back.rdm(rank=1), ours.rdm(rank=1), rtol=0, atol=1e-15)


def _loop_checkpoint(module, norb):
    strs_a, strs_b = _strings(norb, 6, 4), _strings(norb, 3, 5)
    rng = np.random.default_rng(6)
    rng.random(10)
    return module.LoopCheckpoint(
        iteration=2,
        rng_state=rng.bit_generator.state,
        current_occupancies=(rng.random(norb), rng.random(norb)),
        carryover_strings_a=strs_a[:4],
        carryover_strings_b=strs_b[:0],
        best_energy=-1.25,
        best_state_blob={"amplitudes": rng.normal(size=(6, 3)),
                         "strs_a_packed": module_bitpack(module).pack_ints(strs_a, norb),
                         "strs_b_packed": module_bitpack(module).pack_ints(strs_b, norb)},
        best_occupancies=(rng.random(norb), rng.random(norb)),
        current_energy=-1.0,
        norb=norb,
    )


def module_bitpack(module):
    if module is checkpoint:
        from sqd_tpu_torch.ops import bitpack
    else:
        from sqd_tpu.ops import bitpack
    return bitpack


def _assert_checkpoints_equal(a, b):
    assert (a.iteration, a.best_energy, a.current_energy, a.norb) == (
        b.iteration, b.best_energy, b.current_energy, b.norb)
    assert a.rng_state == b.rng_state
    for x, y in zip(a.current_occupancies + a.best_occupancies,
                    b.current_occupancies + b.best_occupancies):
        np.testing.assert_array_equal(x, y)
    assert list(a.carryover_strings_a) == list(b.carryover_strings_a)
    assert list(a.carryover_strings_b) == list(b.carryover_strings_b)
    assert sorted(a.best_state_blob) == sorted(b.best_state_blob)
    for key in a.best_state_blob:
        np.testing.assert_array_equal(a.best_state_blob[key], b.best_state_blob[key])


@pytest.mark.parametrize("norb", [12, 66])
def test_loop_checkpoint_file_crosses_packages(tmp_path, norb):
    ours, theirs = _loop_checkpoint(checkpoint, norb), _loop_checkpoint(jax_checkpoint, norb)
    checkpoint.save_loop_state(tmp_path / "ours.npz", ours)
    jax_checkpoint.save_loop_state(tmp_path / "theirs.npz", theirs)
    for loaded in (jax_checkpoint.load_loop_state(tmp_path / "ours.npz"),
                   checkpoint.load_loop_state(tmp_path / "theirs.npz"),
                   checkpoint.load_loop_state(tmp_path / "ours.npz")):
        _assert_checkpoints_equal(loaded, ours)
    empty = checkpoint.load_loop_state(tmp_path / "ours.npz").carryover_strings_b
    assert len(empty) == 0 and empty.dtype == (object if norb >= 63 else np.int64)


def _run_loop(system, **kwargs):
    history = []
    best = fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], BitArray.from_bool_array(system["rows"]),
        norb=NORB, nelec=NELEC, callback=history.append, device="cpu", **{**LOOP, **kwargs})
    return best, history


def _summary(history):
    return [[(r.energy, list(r.sci_state.ci_strs_a), list(r.sci_state.ci_strs_b))
             for r in results] for results in history]


def test_resumed_loop_equals_uninterrupted(system, tmp_path):  # noqa: F811
    path = tmp_path / "loop.npz"
    best, history = _run_loop(system)
    assert len(history) == LOOP["max_iterations"]
    _, first = _run_loop(system, max_iterations=1, checkpoint_path=path)
    assert jax_checkpoint.load_loop_state(path).iteration == 0  # sqd_tpu reads it
    resumed, rest = _run_loop(system, checkpoint_path=path, resume=True)
    assert checkpoint.load_loop_state(path).iteration == LOOP["max_iterations"] - 1
    assert _summary(first + rest) == _summary(history)
    assert resumed.energy == best.energy
    assert list(resumed.sci_state.ci_strs_a) == list(best.sci_state.ci_strs_a)
    np.testing.assert_array_equal(resumed.sci_state.amplitudes, best.sci_state.amplitudes)
    for x, y in zip(resumed.orbital_occupancies, best.orbital_occupancies):
        np.testing.assert_array_equal(x, y)
    # resume=False starts again from iteration 0 and overwrites the file
    again, history_again = _run_loop(system, checkpoint_path=path, resume=False)
    assert _summary(history_again) == _summary(history) and again.energy == best.energy


def test_resume_reattaches_rdms(system, tmp_path):  # noqa: F811
    path = tmp_path / "loop.npz"
    best, _ = _run_loop(system, max_iterations=1, checkpoint_path=path)
    restored, history = _run_loop(system, max_iterations=1, checkpoint_path=path)
    assert history == []  # nothing left to run
    assert restored.energy == best.energy
    np.testing.assert_allclose(restored.rdm1, best.rdm1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(restored.rdm2, best.rdm2, rtol=0, atol=1e-12)
    assert restored.sci_state.device == torch.device("cpu")


def test_port_resumes_sqd_tpu_checkpoint(system, tmp_path):  # noqa: F811
    path = tmp_path / "loop.npz"
    jax_best = jax_fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], JaxBitArray.from_bool_array(system["rows"]),
        norb=NORB, nelec=NELEC, checkpoint_path=str(path), **{**LOOP, "max_iterations": 1})
    best, history = _run_loop(system, checkpoint_path=path)
    assert len(history) == LOOP["max_iterations"] - 1
    assert best.energy <= jax_best.energy + 1e-12
