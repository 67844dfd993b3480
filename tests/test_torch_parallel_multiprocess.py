# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.parallel`` on 4 CPU ranks against ``sqd_tpu.parallel``.

One module-scoped launch of 4 rank processes, joined by gloo over a
``FileStore``: every rank runs every sharded mode (the grid at 2 x 2) and one
iteration of the SQD loop through the ``sci_solver`` seam (3 batches over 4
ranks: one rank solves none), on inputs this process writes from seeded
numpy, and writes its results to ``tmp_path``.  The tests hold each rank's
results to ``sqd_tpu``'s same mode (the conftest's 8 virtual CPU devices)
and to the port's ``solve_sci``: energies within 1e-8 Ha, occupancies within
1e-6, every rank the same.  The launch is cut after ``LAUNCH_TIMEOUT``
seconds, its processes killed, and the tests fail.
"""

import json
import os
import pickle
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu import fermion as jax_fermion
from sqd_tpu import parallel as jax_par
from sqd_tpu.primitives import BitArray as JaxBitArray

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch import fermion

from test_torch_parallel import SPIN, TOL_E, TOL_OCC, _batches, eight_orbitals, six_orbitals
from test_torch_sqd_loop import NELEC as LOOP_NELEC, NORB as LOOP_NORB, system  # noqa: F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAUNCH_TIMEOUT = 240
LOOP = dict(samples_per_batch=60, num_batches=3, max_iterations=1, seed=12)
SOLVE64 = {"tol": 1e-8}

# One rank: read the inputs, run every mode, write {case: result}.  Results
# carry the energy, the occupancies and the strings of each solve.
RANK = r"""
import pickle, sys
from functools import partial
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sqd_tpu_torch import fermion, parallel
from sqd_tpu_torch.primitives import BitArray

rank, world, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
with open(f"{workdir}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
f64 = dict(solver_dtype=torch.float64, tol=1e-8, device="cpu")

def keep(res):
    return {"energy": res.energy, "occ": [o.tolist() for o in res.orbital_occupancies],
            "strs": [res.sci_state.ci_strs_a.tolist(), res.sci_state.ci_strs_b.tolist()]}

out = {}
s6, s8, spin = inp["norb6"], inp["norb8"], inp["spin"]
a6 = (s6["ci"], s6["h1"], s6["eri"], s6["norb"], s6["nelec"])
a8 = (s8["ci"], s8["h1"], s8["eri"], s8["norb"], s8["nelec"])
out["batch"] = [keep(r) for r in parallel.solve_sci_batch_sharded(
    inp["batches"], *a6[1:], pad_bucket=8, **f64)]
for name, kw in spin.items():
    out[f"distributed-{name}"] = keep(parallel.solve_sci_distributed(*a8, **f64, **kw))
    out[f"grid-{name}"] = keep(parallel.solve_sci_gridsharded(*a6, **f64, **kw))
    for sys_name, args in (("norb6", a6), ("norb8", a8)):
        out[f"row-{sys_name}-{name}"] = keep(parallel.solve_sci_rowsharded(*args, **f64, **kw))
out["df"] = keep(parallel.solve_sci_dfsharded(*a8, eri_factor=s8["factor"], **f64))
grid = parallel.default_grid_mesh(device_type="cpu")
out["grid-mesh"] = list(grid.mesh.shape)
loop, history = inp["loop"], []
best = fermion.diagonalize_fermionic_hamiltonian(
    loop["h1"], loop["eri"], BitArray.from_bool_array(loop["rows"]), norb=loop["norb"],
    nelec=loop["nelec"], callback=history.append, device="cpu",
    sci_solver=partial(parallel.solve_sci_batch_sharded, pad_bucket=8, **f64), **loop["kwargs"])
out["loop"] = {"best": keep(best), "batches": [keep(r) for r in history[0]]}
dist.barrier()
dist.destroy_process_group()
with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def inputs(system):  # noqa: F811
    return {
        "norb6": six_orbitals(), "norb8": eight_orbitals(), "spin": SPIN,
        "batches": _batches(six_orbitals(), 5, seed=1),
        "loop": {"h1": system["h1"], "eri": system["eri"], "rows": system["rows"],
                 "norb": LOOP_NORB, "nelec": LOOP_NELEC, "kwargs": LOOP},
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's results, after one launch of ``WORLD`` rank processes."""
    workdir = tmp_path_factory.mktemp("ranks")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(WORLD),
                               str(workdir / "store"), str(workdir)],
                              env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} ranks did not finish within {LAUNCH_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited with {p.returncode}:\n"
                        + (workdir / f"rank{r}.log").read_text()[-4000:])
    out = []
    for r in range(WORLD):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _args(s):
    return s["ci"], s["h1"], s["eri"], s["norb"], s["nelec"]


def _check(got, ref, local=None):
    assert abs(got["energy"] - ref.energy) <= TOL_E
    if local is not None:
        assert abs(got["energy"] - local.energy) <= TOL_E
    np.testing.assert_allclose(np.ravel(got["occ"]), np.ravel(ref.orbital_occupancies),
                               rtol=0, atol=TOL_OCC)
    assert got["strs"][0] == ref.sci_state.ci_strs_a.tolist()
    assert got["strs"][1] == ref.sci_state.ci_strs_b.tolist()


def _local(s, **kw):
    return fermion.solve_sci(*_args(s), device="cpu", tol=1e-10, **kw)


JAX64 = {"solver_dtype": jnp.float64, "tol": 1e-8}


def test_every_rank_returns_the_same(ranks):
    for other in ranks[1:]:
        assert json.dumps(other, sort_keys=True) == json.dumps(ranks[0], sort_keys=True)
    assert ranks[0]["grid-mesh"] == [2, 2]


def test_batch_sharded(ranks, inputs):
    """Five batches over four ranks (blocks of 2, 2, 1, 0), in input order."""
    s = inputs["norb6"]
    args = (s["h1"], s["eri"], s["norb"], s["nelec"])
    ref = jax_par.solve_sci_batch_sharded(inputs["batches"], *args, pad_bucket=8, **JAX64)
    assert len(ranks[0]["batch"]) == len(ref) == 5
    for got, r, cs in zip(ranks[0]["batch"], ref, inputs["batches"]):
        _check(got, r, fermion.solve_sci(cs, *args, device="cpu", tol=1e-10))


@pytest.mark.parametrize("spin", list(SPIN))
def test_distributed(ranks, inputs, spin):
    s = inputs["norb8"]
    ref = jax_par.solve_sci_distributed(*_args(s), **JAX64, **SPIN[spin])
    _check(ranks[0][f"distributed-{spin}"], ref, _local(s, **SPIN[spin]))


@pytest.mark.parametrize("spin", list(SPIN))
@pytest.mark.parametrize("name", ["norb6", "norb8"])
def test_rowsharded(ranks, inputs, name, spin):
    s = inputs[name]
    ref = jax_par.solve_sci_rowsharded(*_args(s), **JAX64, **SPIN[spin])
    _check(ranks[0][f"row-{name}-{spin}"], ref, _local(s, **SPIN[spin]))


@pytest.mark.parametrize("spin", list(SPIN))
def test_gridsharded(ranks, inputs, spin):
    s = inputs["norb6"]
    ref = jax_par.solve_sci_gridsharded(*_args(s), **JAX64, **SPIN[spin])
    _check(ranks[0][f"grid-{spin}"], ref, _local(s, **SPIN[spin]))


def test_dfsharded(ranks, inputs):
    """The factor's 16 rows, 4 on each rank."""
    s = inputs["norb8"]
    ref = jax_par.solve_sci_dfsharded(*_args(s), eri_factor=s["factor"], **JAX64)
    _check(ranks[0]["df"], ref, _local(s))


def test_loop_through_the_seam(ranks, inputs):
    """Iteration 0 of the SQD loop: ``sqd_tpu``'s strings, its batch energies
    within 1e-8 Ha and its best result."""
    loop = inputs["loop"]
    history = []
    ref = jax_fermion.diagonalize_fermionic_hamiltonian(
        loop["h1"], loop["eri"], JaxBitArray.from_bool_array(loop["rows"]), norb=loop["norb"],
        nelec=loop["nelec"], callback=history.append,
        sci_solver=partial(jax_par.solve_sci_batch_sharded, pad_bucket=8, **JAX64),
        **loop["kwargs"])
    got = ranks[0]["loop"]
    assert len(got["batches"]) == len(history[0]) == 3
    for g, r in zip(got["batches"], history[0]):
        _check(g, r)
    _check(got["best"], ref)


def test_dryrun_multichip(capsys):
    """The dry run's two spawned ranks agree with each other and, mode by
    mode, with the port's ``solve_sci`` on the same system."""
    from sqd_tpu_torch.parallel.dryrun import dryrun_multichip

    ranks = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK: 2 ranks (gloo, cpu)" in capsys.readouterr().out
    assert ranks[0] == ranks[1] and len(ranks[0]["batch"]) == 2
    for mode in ("distributed", "row", "grid", "df"):
        assert abs(ranks[0][mode] - ranks[0]["local"]) <= 1e-6


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """With no card, the default ``device="cuda"`` raises before any rank
    process is started: no quiet run on the CPU."""
    from sqd_tpu_torch.parallel import dryrun

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank process was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun.multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(1)
