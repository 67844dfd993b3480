# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Example 15: multi-process cluster execution (the Dice/MPI replacement).

The port of ``examples/15_multiprocess_cluster.py``.  The reference's
cluster scale-out story is swapping its eigensolver for an MPI-launched
external C++ program (docs/guides/integrate_dice_solver.ipynb).  Here it is
one process per rank: every process runs the same program, joins the
``torch.distributed`` process group with
:func:`sqd_tpu_torch.parallel.init_distributed`, and the sharded solvers
run their collectives over the group — NCCL with one card per rank, gloo on
the CPU, and gloo too where the ranks share one card.

On a cluster each process is started with ``SQD_TPU_COORDINATOR``
(``host:port`` of rank 0), ``SQD_TPU_NUM_PROCESSES`` and
``SQD_TPU_PROCESS_ID`` set.  For a self-contained demo, ``main()`` plays the
launcher itself: it starts TWO worker processes and checks that both ranks
return the identical, oracle-exact energy through a determinant-row-sharded
solve.  No worker outlives the call.  Run on the card from a checkout::

    python3 sqd_tpu_torch/examples/15_multiprocess_cluster.py

or on the CPU as ``main(device="cpu")``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

try:
    import sqd_tpu_torch  # noqa: F401
except ImportError:  # run as a script from a checkout: the repository root on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from sqd_tpu_torch.ops.dense_fci import all_hamming_strings, build_dense_hamiltonian
from sqd_tpu_torch.utils.device import checked_device

_WORKER = """
import json, os, sys
sys.path.insert(0, os.environ["SQD_REPO"])
import numpy as np
import torch
import torch.distributed as dist
import sqd_tpu_torch.parallel as par

rank = int(os.environ["SQD_TPU_PROCESS_ID"])
device = torch.device(sys.argv[1])
nccl = sys.argv[2] == "nccl"
if device.type == "cuda":  # a card per rank where there are enough, else all share one
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
else:
    torch.set_num_threads(1)  # the ranks share the host's cores
# join the process group (SQD_TPU_* variables): NCCL, or gloo on the CPU and
# for ranks that share a card
par.init_distributed(platform=None if nccl else "cpu")
mesh = par.global_mesh("rows", device_type=device.type)

from sqd_tpu_torch.ops.dense_fci import all_hamming_strings

rng = np.random.default_rng(21)
norb = 6
h1 = rng.normal(size=(norb, norb)); h1 = (h1 + h1.T) / 2
chol = rng.normal(size=(8, norb, norb)) * 0.3
chol = (chol + chol.transpose(0, 2, 1)) / 2
eri = np.einsum("xpq,xrs->pqrs", chol, chol)
strs = all_hamming_strings(norb, 3)

res = par.solve_sci_rowsharded((strs, strs), h1, eri, norb, (3, 3), mesh=mesh, tol=1e-8,
                               device=device)
print(json.dumps({"rank": rank, "energy": res.energy}), flush=True)
dist.destroy_process_group()
"""


def main(device="cuda") -> None:
    device = checked_device(device)
    nccl = device.type == "cuda" and torch.cuda.device_count() >= 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.update(SQD_REPO=repo, SQD_TPU_COORDINATOR=f"127.0.0.1:{port}", SQD_TPU_NUM_PROCESSES="2")
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, device.type, "nccl" if nccl else "gloo"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**env, "SQD_TPU_PROCESS_ID": str(rank)},
        )
        for rank in range(2)
    ]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=540)
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    e0, e1 = (o["energy"] for o in sorted(outs, key=lambda o: o["rank"]))
    print(f"rank 0 energy: {e0:.12f}")
    print(f"rank 1 energy: {e1:.12f}")
    assert e0 == e1, "SPMD ranks must agree bit-for-bit"

    # oracle check, in this (launcher) process
    rng = np.random.default_rng(21)
    norb = 6
    h1 = rng.normal(size=(norb, norb)); h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(8, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    strs = all_hamming_strings(norb, 3)
    e_exact = np.linalg.eigvalsh(build_dense_hamiltonian(strs, strs, h1, eri))[0]
    print(f"dense oracle:  {e_exact:.12f}  (|err| = {abs(e0 - e_exact):.2e})")
    assert abs(e0 - e_exact) < 1e-7


if __name__ == "__main__":
    main()
