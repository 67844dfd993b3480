# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.parallel`` at world size 1 against ``sqd_tpu.parallel``.

Every port entry point runs in this process inside a one-rank gloo process
group (a ``FileStore`` under ``tmp_path``, destroyed after each test), so its
collectives run; the ``sqd_tpu`` counterpart runs on the conftest's 8
virtual CPU devices.  Same seeded inputs, f64 solves at ``tol=1e-8``:
energies within 1e-8 Ha of ``sqd_tpu``'s same mode and of the port's
``solve_sci``, occupancies within 1e-6; with a spin penalty the energy is
the bare Hamiltonian's.  ``tests/test_torch_parallel_multiprocess.py`` runs
the same modes on 4 ranks.
"""

from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu import parallel as jax_par
from sqd_tpu.ops import dense_fci
from sqd_tpu.primitives import BitArray as JaxBitArray

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import configuration_recovery, fermion, parallel
from sqd_tpu_torch.ops import davidson
from sqd_tpu_torch.ops.hamiltonian import build_sci_hamiltonian, sci_matvec_flat
from sqd_tpu_torch.parallel import distributed, mesh as port_mesh
from sqd_tpu_torch.primitives import BitArray

from test_torch_configuration_recovery import jax_gumbel_noise
from test_torch_sqd_loop import NELEC as LOOP_NELEC, NORB as LOOP_NORB, system  # noqa: F401

torch.set_num_threads(2)

TOL_E = 1e-8
TOL_OCC = 1e-6
SOLVE = {"solver_dtype": torch.float64, "tol": 1e-8}
JAX_SOLVE = {"solver_dtype": jnp.float64, "tol": 1e-8}
SPIN = {"bare": {}, "spin_penalty": {"spin_sq": 0.0, "shift": 0.4}}


def _sym_eri(rng, norb):
    eri = rng.normal(size=(norb,) * 4) * 0.2
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return eri / 8


def six_orbitals():
    """``tests/test_parallel.py``'s ``system`` integrals, 15 x 13 strings."""
    rng = np.random.default_rng(0)
    norb = 6
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    eri = _sym_eri(rng, norb)
    rng = np.random.default_rng(31)
    strs = dense_fci.all_hamming_strings(norb, 3)
    ci = (np.sort(rng.choice(strs, 15, replace=False)), np.sort(rng.choice(strs, 13, replace=False)))
    return {"h1": h1, "eri": eri, "norb": norb, "nelec": (3, 3), "ci": ci, "factor": None}


def eight_orbitals():
    """8 orbitals (npair 64) with PSD integrals of rank 16 and their factor;
    24 x 20 strings (M padded to 24 or 32: a multiple of 4)."""
    rng = np.random.default_rng(5)
    norb = 8
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2 + np.diag(np.linspace(-3.0, 1.0, norb))
    chol = rng.normal(size=(16, norb, norb)) * 0.25
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    strs = dense_fci.all_hamming_strings(norb, 3)
    ci = (np.sort(rng.choice(strs, 24, replace=False)), np.sort(rng.choice(strs, 20, replace=False)))
    return {"h1": h1, "eri": eri, "norb": norb, "nelec": (3, 3), "ci": ci,
            "factor": chol.reshape(16, norb * norb)}


SYSTEMS = {"norb6": six_orbitals, "norb8": eight_orbitals}


@pytest.fixture(scope="module")
def systems():
    return {name: make() for name, make in SYSTEMS.items()}


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group for the test."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _args(s):
    return s["ci"], s["h1"], s["eri"], s["norb"], s["nelec"]


def assert_same(res, ref, local=None):
    """Energy within TOL_E of ``ref`` (and of ``local``), occupancies within
    TOL_OCC, the same strings."""
    assert abs(res.energy - ref.energy) <= TOL_E
    if local is not None:
        assert abs(res.energy - local.energy) <= TOL_E
    np.testing.assert_allclose(np.ravel(res.orbital_occupancies),
                               np.ravel(ref.orbital_occupancies), rtol=0, atol=TOL_OCC)
    np.testing.assert_array_equal(res.sci_state.ci_strs_a, ref.sci_state.ci_strs_a)
    np.testing.assert_array_equal(res.sci_state.ci_strs_b, ref.sci_state.ci_strs_b)


def _local(s, **spin):
    return fermion.solve_sci(s["ci"], s["h1"], s["eri"], s["norb"], s["nelec"], device="cpu",
                             tol=1e-10, **spin)


def _batches(s, count, seed):
    rng = np.random.default_rng(seed)
    strs = dense_fci.all_hamming_strings(s["norb"], s["nelec"][0])
    return [(np.sort(rng.choice(strs, rng.integers(6, 12), replace=False)),
             np.sort(rng.choice(strs, rng.integers(6, 12), replace=False))) for _ in range(count)]


@pytest.mark.parametrize("spin", list(SPIN))
def test_batch_sharded_matches(systems, group, spin):
    """Five batches (not a multiple of sqd_tpu's 8 devices), in input order."""
    s = systems["norb6"]
    batches = _batches(s, 5, seed=1)
    args = (s["h1"], s["eri"], s["norb"], s["nelec"])
    ref = jax_par.solve_sci_batch_sharded(batches, *args, pad_bucket=8, **JAX_SOLVE, **SPIN[spin])
    out = parallel.solve_sci_batch_sharded(batches, *args, pad_bucket=8, device="cpu",
                                           **SOLVE, **SPIN[spin])
    assert len(out) == len(ref) == 5
    for res, r, cs in zip(out, ref, batches):
        local = fermion.solve_sci(cs, *args, device="cpu", tol=1e-10, **SPIN[spin])
        assert_same(res, r, local)
        np.testing.assert_array_equal(res.sci_state.ci_strs_a, np.unique(cs[0]))


def test_batch_sharded_rdms_and_f32(systems, group):
    """The default f32 Davidson (the kernel wrapper, its plain version on the
    CPU) with RDMs attached, against the port's f64 ``solve_sci``."""
    s = systems["norb6"]
    batches = _batches(s, 2, seed=2)
    args = (s["h1"], s["eri"], s["norb"], s["nelec"])
    out = parallel.solve_sci_batch_sharded(batches, *args, with_rdms=True, device="cpu")
    for res, cs in zip(out, batches):
        local = fermion.solve_sci(cs, *args, device="cpu", tol=1e-10)
        assert res.sci_state.amplitudes.shape == local.sci_state.amplitudes.shape
        assert abs(res.energy - local.energy) <= 1e-7  # an f32 Davidson at tol 1e-6
        np.testing.assert_allclose(res.rdm1, local.rdm1, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.rdm2, local.rdm2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spin", list(SPIN))
def test_distributed_matches(systems, group, spin):
    s = systems["norb8"]  # npair 64 over sqd_tpu's 8 devices
    ref = jax_par.solve_sci_distributed(*_args(s), **JAX_SOLVE, **SPIN[spin])
    out = parallel.solve_sci_distributed(*_args(s), device="cpu", **SOLVE, **SPIN[spin])
    assert_same(out, ref, _local(s, **SPIN[spin]))


@pytest.mark.parametrize("spin", list(SPIN))
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_rowsharded_matches(systems, group, name, spin):
    s = systems[name]
    ref = jax_par.solve_sci_rowsharded(*_args(s), **JAX_SOLVE, **SPIN[spin])
    out = parallel.solve_sci_rowsharded(*_args(s), device="cpu", **SOLVE, **SPIN[spin])
    assert_same(out, ref, _local(s, **SPIN[spin]))


def test_rowsharded_f32_refined(systems, group):
    """An f32 solve with the f64 polish; the f32 channel is the kernel
    wrapper on row-restricted operands (its plain version on the CPU)."""
    s = systems["norb8"]
    out = parallel.solve_sci_rowsharded(*_args(s), device="cpu", with_rdms=True)
    local = fermion.solve_sci(*_args(s), device="cpu", tol=1e-10)
    assert abs(out.energy - local.energy) <= TOL_E
    np.testing.assert_allclose(out.rdm2, local.rdm2, rtol=0, atol=1e-5)


def test_batch_rowsharded_seam(systems, group):
    s = systems["norb6"]
    batches = _batches(s, 2, seed=3)
    out = parallel.solve_sci_batch_rowsharded(batches, s["h1"], s["eri"], s["norb"], s["nelec"],
                                              device="cpu", **SOLVE)
    ref = jax_par.solve_sci_batch_rowsharded(batches, s["h1"], s["eri"], s["norb"], s["nelec"],
                                             **JAX_SOLVE)
    for res, r in zip(out, ref):
        assert_same(res, r)


@pytest.mark.parametrize("spin", list(SPIN))
def test_gridsharded_matches(systems, group, spin):
    s = systems["norb6"]
    mesh = jax_par.default_grid_mesh()
    assert mesh.devices.shape == (2, 4)
    ref = jax_par.solve_sci_gridsharded(*_args(s), mesh=mesh, **JAX_SOLVE, **SPIN[spin])
    out = parallel.solve_sci_gridsharded(*_args(s), device="cpu", **SOLVE, **SPIN[spin])
    assert_same(out, ref, _local(s, **SPIN[spin]))


def test_dfsharded_matches(systems, group):
    s = systems["norb8"]
    ref = jax_par.solve_sci_dfsharded(*_args(s), eri_factor=s["factor"], **JAX_SOLVE)
    out = parallel.solve_sci_dfsharded(*_args(s), eri_factor=s["factor"], device="cpu", **SOLVE)
    assert_same(out, ref, _local(s))
    assert out.rdm2 is not None
    np.testing.assert_allclose(out.rdm2, ref.rdm2, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="PSD"):
        parallel.solve_sci_dfsharded(*_args(s), device="cpu")  # npair 64: no "auto" factor


def test_loop_through_the_seam(system, group, monkeypatch):  # noqa: F811
    """The SQD loop with the batch-sharded solver in both packages (the
    port's recovery fed ``jax.random``'s noise): the same strings in every
    iteration, batch energies within 1e-8 Ha."""
    monkeypatch.setattr(configuration_recovery, "_gumbel_noise", jax_gumbel_noise)
    kwargs = dict(samples_per_batch=60, num_batches=3, max_iterations=3, seed=12)
    ref_history, history = [], []
    ref = jax_fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], JaxBitArray.from_bool_array(system["rows"]),
        norb=LOOP_NORB, nelec=LOOP_NELEC, callback=ref_history.append,
        sci_solver=partial(jax_par.solve_sci_batch_sharded, pad_bucket=8, **JAX_SOLVE), **kwargs)
    out = fermion.diagonalize_fermionic_hamiltonian(
        system["h1"], system["eri"], BitArray.from_bool_array(system["rows"]),
        norb=LOOP_NORB, nelec=LOOP_NELEC, callback=history.append, device="cpu",
        sci_solver=partial(parallel.solve_sci_batch_sharded, pad_bucket=8, device="cpu",
                           **SOLVE), **kwargs)
    assert len(history) == len(ref_history) >= 2
    for batches, ref_batches in zip(history, ref_history):
        assert len(batches) == len(ref_batches) == 3
        for res, r in zip(batches, ref_batches):
            assert_same(res, r)
    assert abs(out.energy - ref.energy) <= TOL_E


@pytest.mark.parametrize("k", [1, 3])
def test_group_davidson_equals_ungrouped(systems, group, k):
    """At world size 1 the group's reductions are sums of one term: the
    grouped solvers give the ungrouped results bit for bit."""
    s = systems["norb6"]
    from sqd_tpu_torch.fermion import _strings_to_packed

    pa, pb = (_strings_to_packed(x, s["norb"]) for x in s["ci"])
    ham = build_sci_hamiltonian(pa, pb, s["h1"], s["eri"], s["norb"], s["nelec"], device="cpu")
    hd = ham.hdiag.reshape(-1)
    if k == 1:
        v0 = davidson.davidson_initial_guess_sharded(hd, group)
        assert torch.equal(v0, davidson.davidson_initial_guess(hd))
        runs = [davidson.davidson_ground_state(sci_matvec_flat, ham, hd, v0, tol=1e-9,
                                               max_subspace=6, group=g) for g in (None, group)]
        assert runs[0].theta == runs[1].theta and runs[0].iterations == runs[1].iterations
        assert torch.equal(runs[0].vector, runs[1].vector)
    else:
        v0 = davidson.davidson_initial_guess_k(hd, k)
        runs = [davidson.davidson_lowest_k(sci_matvec_flat, ham, hd, v0, k=k, tol=1e-9,
                                           max_subspace=10, group=g) for g in (None, group)]
        assert torch.equal(runs[0].thetas, runs[1].thetas)
        assert torch.equal(runs[0].vectors, runs[1].vectors)


def test_no_process_group_runs_alone(systems):
    """Without a process group a solver runs as one rank, communicating nothing."""
    assert not dist.is_initialized()
    s = systems["norb6"]
    out = parallel.solve_sci_rowsharded(*_args(s), device="cpu", **SOLVE)
    assert abs(out.energy - _local(s).energy) <= TOL_E
    assert port_mesh.batch_sharding(None)(5) == range(5)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_batch_sharding_blocks(size):
    """Contiguous blocks of ceil(length / size) in rank order, covering every index once."""
    for length in range(10):
        blocks = [port_mesh._rank_range(size, rank, length) for rank in range(size)]
        assert [i for b in blocks for i in b] == list(range(length))
        assert all(len(b) <= -(-length // size) for b in blocks)


def test_mesh_helpers(group):
    mesh = port_mesh.default_mesh("row", device_type="cpu")
    axis = port_mesh.mesh_axis(mesh, "row")
    assert (axis.size, axis.rank) == (1, 0)
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(axis.all_gather(t), t) and torch.equal(axis.reduce_scatter(t), t)
    assert torch.equal(axis.all_reduce(t), t) and axis.all_gather_object("x") == ["x"]
    assert port_mesh.batch_sharding(mesh)(7) == range(7)
    grid = parallel.default_grid_mesh(device_type="cpu")
    assert grid.mesh_dim_names == ("row", "col") and tuple(grid.mesh.shape) == (1, 1)
    assert port_mesh.flat_axis(grid).size == 1
    assert tuple(parallel.global_mesh("a", "b", device_type="cpu").mesh.shape) == (1, 1)
    assert parallel.global_mesh(device_type="cpu").mesh_dim_names == ("batch",)
    with pytest.raises(ValueError, match="does not cover"):
        parallel.global_mesh("a", "b", axis_sizes=(2, 1), device_type="cpu")
    with pytest.raises(ValueError, match="axis_sizes"):
        parallel.global_mesh("a", "b", "c", device_type="cpu")
    np.testing.assert_array_equal(distributed.replicate_to_host(t, mesh), t.numpy())
    np.testing.assert_array_equal(distributed.replicate_to_host(t, None), t.numpy())
    assert distributed.host_local(t) is t and not parallel.is_distributed()


def _clear_env(monkeypatch):
    for name in ("SQD_TPU_COORDINATOR", "SQD_TPU_NUM_PROCESSES", "SQD_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)


def test_init_distributed_from_environment(monkeypatch):
    from sqd_tpu_torch.parallel.dryrun import _free_port

    _clear_env(monkeypatch)
    assert parallel.init_distributed() is False and not dist.is_initialized()
    with pytest.raises(ValueError, match="world size"):
        parallel.init_distributed("127.0.0.1:1", platform="cpu")
    monkeypatch.setenv("SQD_TPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("SQD_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("SQD_TPU_PROCESS_ID", "7")  # the explicit argument wins
    try:
        assert parallel.init_distributed(process_id=0, platform="cpu") is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert parallel.init_distributed() is True  # idempotent
        assert not parallel.is_distributed()
    finally:
        dist.destroy_process_group()


def test_init_distributed_raced(monkeypatch):
    """A raced initialisation: the group reporting initialised after the
    raise wins, the message is the fallback, anything else re-raises."""
    _clear_env(monkeypatch)
    reports = iter([False, True])

    def raise_twice(*args, **kwargs):
        raise ValueError("trying to initialize the default process group twice!")

    monkeypatch.setattr(dist, "init_process_group", raise_twice)
    monkeypatch.setattr(dist, "is_initialized", lambda: next(reports))
    assert parallel.init_distributed("127.0.0.1:7778", 1, 0, platform="cpu") is True
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert parallel.init_distributed("127.0.0.1:7778", 1, 0, platform="cpu") is True

    def raise_other(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", raise_other)
    with pytest.raises(RuntimeError, match="connection refused"):
        parallel.init_distributed("127.0.0.1:7778", 1, 0, platform="cpu")
