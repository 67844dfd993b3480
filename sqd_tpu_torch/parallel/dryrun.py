# (C) 2026. Licensed under the Apache License, Version 2.0.
"""A multi-rank dry run of the five sharded modes (the counterpart of
``sqd_tpu``'s ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` starts ``world_size`` rank processes (spawned),
joins them through :func:`~.distributed.init_distributed` (gloo on the CPU,
NCCL with one rank per card on the GPU) and runs on every rank:

* ``"batch"``: :func:`~.batch_solver.solve_sci_batch_sharded` over one batch
  per rank of the 6-site Hubbard ring, (2, 2) electrons, 8 strings each;
* ``"distributed"``, ``"row"``, ``"grid"`` and ``"df"``: the pair-, row-,
  grid- and factor-sharded solves of ``_small_problem``'s system (the 8-site
  Hubbard ring at U = 4, (3, 3) electrons, its 56 x 56 determinants), beside
  the port's ``solve_sci`` on the same system (``"local"``).

It prints one line, the batch energies and then each mode's energy beside
the local one, and returns every rank's results.  Run it as::

    python -c "from sqd_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

on the cards, or with ``dryrun_multichip(4, device="cpu")`` on the CPU.
"""

from __future__ import annotations

import itertools
import multiprocessing
import queue
import socket
import traceback

import numpy as np
import torch

from ..utils.device import checked_device

__all__ = ["dryrun_multichip"]

MODES = ("batch", "distributed", "row", "grid", "df")
SOLVE = {"tol": 1e-7, "max_cycle": 80}  # as sqd_tpu's dry run
RANK_TIMEOUT = 600  # seconds the parent waits for each rank's result


def _strings(norb: int, nelec: int) -> np.ndarray:
    return np.array(sorted(sum(1 << p for p in occ)
                           for occ in itertools.combinations(range(norb), nelec)))


def _small_problem(norb=8, nelec=(3, 3), m=64, n=64, seed=0):
    """``_small_problem``'s system: Hubbard integrals and ``m`` x ``n`` strings
    drawn from every string (here all 56 per spin)."""
    from ..models.hubbard import hubbard_integrals

    rng = np.random.default_rng(seed)
    h1, eri = hubbard_integrals(norb, u=4.0)
    all_strs = _strings(norb, nelec[0])
    strs_a = np.sort(rng.choice(all_strs, size=min(m, len(all_strs)), replace=False))
    strs_b = np.sort(rng.choice(all_strs, size=min(n, len(all_strs)), replace=False))
    return h1, eri, strs_a, strs_b


def _run_modes(world: int, device: torch.device) -> dict:
    """Every mode on this rank: energies (and the batch list)."""
    from ..fermion import solve_sci
    from ..models.hubbard import hubbard_integrals
    from . import (solve_sci_batch_sharded, solve_sci_dfsharded, solve_sci_distributed,
                   solve_sci_gridsharded, solve_sci_rowsharded)

    out = {}
    h1, eri = hubbard_integrals(6, u=4.0)
    rng = np.random.default_rng(0)
    all_strs = _strings(6, 2)
    batches = []
    for _ in range(world):
        sel = np.sort(rng.choice(all_strs, size=8, replace=False))
        batches.append((sel, sel))
    results = solve_sci_batch_sharded(batches, h1, eri, 6, (2, 2), pad_bucket=8, tol=1e-5,
                                      max_subspace=12, max_cycle=60, device=device)
    out["batch"] = [r.energy for r in results]
    norb, nelec = 8, (3, 3)
    h1, eri, strs_a, strs_b = _small_problem(norb, nelec)
    ci = (strs_a, strs_b)
    out["local"] = solve_sci(ci, h1, eri, norb, nelec, tol=1e-8, device=device).energy
    if (norb * norb) % world == 0:  # else the pair axis does not split (as sqd_tpu's)
        out["distributed"] = solve_sci_distributed(ci, h1, eri, norb, nelec, device=device,
                                                   **SOLVE).energy
    out["row"] = solve_sci_rowsharded(ci, h1, eri, norb, nelec, device=device, **SOLVE).energy
    out["grid"] = solve_sci_gridsharded(ci, h1, eri, norb, nelec, device=device, **SOLVE).energy
    # the Hubbard pair matrix is U on the (pp|pp) entries: its factor has one
    # row per site
    factor = np.zeros((norb, norb * norb))
    factor[np.arange(norb), np.arange(norb) * (norb + 1)] = np.sqrt(eri[0, 0, 0, 0])
    out["df"] = solve_sci_dfsharded(ci, h1, eri, norb, nelec, eri_factor=factor,
                                    device=device, **SOLVE).energy
    return out


def _rank_main(rank, world, coordinator, backend, device_type, results):
    """One rank: join the group, run the modes, send the results (or the
    traceback) to the parent."""
    import torch.distributed as dist

    from .distributed import init_distributed

    try:
        device = torch.device("cpu")
        torch.set_num_threads(1)  # CPU ranks share the host's cores
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        init_distributed(coordinator, world, rank,
                         local_device_ids=[device.index] if device.index is not None else None,
                         platform="cpu" if backend == "gloo" else None)
        out = _run_modes(world, device)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # the parent reports it; this process exits
        results.put((rank, None, traceback.format_exc()))
        raise


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(world_size: int, *, device="cuda", backend: str | None = None
                     ) -> list[dict]:
    """Run the modes on ``world_size`` spawned ranks; print the summary line.

    ``device``: ``"cuda"`` (the ranks compute on the cards, ``rank % card
    count``; with no card the call raises before any rank is spawned) or
    ``"cpu"``.  ``backend``: ``"nccl"`` (one rank per card; the default on
    the cards) or ``"gloo"`` (the default on the CPU; on the cards gloo
    carries the collectives of CUDA tensors).  Returns each rank's results,
    in rank order.  Raises ``RuntimeError`` with a rank's traceback if any
    rank fails, and when ``RANK_TIMEOUT`` seconds pass without every rank's
    result; no rank process outlives the call.
    """
    device_type = checked_device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, coordinator, backend, device_type, results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world_size:
            try:
                rank, out, error = results.get(timeout=RANK_TIMEOUT)
            except queue.Empty:
                raise RuntimeError(f"dryrun_multichip: no result from ranks "
                                   f"{sorted(set(range(world_size)) - set(got))} "
                                   f"in {RANK_TIMEOUT} s")
            if error is not None:
                raise RuntimeError(f"dryrun_multichip: rank {rank} failed:\n{error}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [got[r] for r in range(world_size)]
    r0 = ranks[0]
    modes_line = ", ".join(f"{name} E={r0[name]:.6f}" for name in MODES[1:] if name in r0)
    skipped = "" if "distributed" in r0 else f" (pair-sharded solve skipped: 64 % {world_size} != 0)"
    print(f"dryrun_multichip OK: {world_size} ranks ({backend}, {device_type}), batch energies "
          f"{r0['batch']}, {modes_line} (local {r0['local']:.6f}){skipped}", flush=True)
    return ranks
