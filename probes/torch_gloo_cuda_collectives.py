# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Which collectives gloo serves for CUDA tensors, with two ranks on one card.

NCCL takes one rank per card, so two ranks on a one-card machine can only
join through gloo.  This probe spawns two processes, both on ``cuda:0``,
joins them with gloo over a ``FileStore``, and tries on CUDA tensors each
collective the sharded solvers of ``sqd_tpu_torch.parallel`` use:
``all_reduce`` (sum and min, f32 and f64, a scalar), the all-gather and the
reduce-scatter into one tensor (``all_gather_into_tensor`` /
``reduce_scatter_tensor``, or their newer names), ``all_gather_object``, and
1-D and 2-D ``DeviceMesh`` construction with ``device_type="cuda"``.  Each
result is checked against the expected values.  Prints one JSON line per
rank-0 run: ``{"torch": ..., "collectives": {name: "ok" or the error}}``.

Run from the repository root: ``python3 probes/torch_gloo_cuda_collectives.py``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _cases(rank: int, world: int):
    from torch.distributed.device_mesh import init_device_mesh

    from sqd_tpu_torch.parallel.mesh import _all_gather_into, _reduce_scatter_into

    dev = torch.device("cuda", 0)

    def all_reduce(dtype, op, want):
        def run():
            t = torch.full((3, 5), float(rank + 1), dtype=dtype, device=dev)
            dist.all_reduce(t, op=op)
            return bool((t == want).all())
        return run

    def scalar():
        t = torch.tensor(float(rank + 1), dtype=torch.float64, device=dev)
        dist.all_reduce(t)
        return float(t) == world * (world + 1) / 2

    def gather():
        t = torch.full((2, 3), float(rank), device=dev)
        out = torch.empty((2 * world, 3), device=dev)
        _all_gather_into(out, t, None)
        return bool((out[::2, 0] == torch.arange(world, device=dev)).all())

    def scatter():
        t = torch.arange(2 * world * 3, dtype=torch.float32, device=dev).reshape(2 * world, 3)
        out = torch.empty((2, 3), device=dev)
        _reduce_scatter_into(out, t, None)
        return bool((out == world * t[2 * rank : 2 * rank + 2]).all())

    def objects():
        out = [None] * world
        dist.all_gather_object(out, {"rank": rank})
        return out == [{"rank": r} for r in range(world)]

    def mesh_1d():
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("row",))
        t = torch.ones(4, device=dev)
        dist.all_reduce(t, group=mesh.get_group("row"))
        return bool((t == world).all())

    def mesh_2d():
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("row", "col"))
        t = torch.ones(4, device=dev)
        dist.all_reduce(t, group=mesh.get_group("col"))
        return bool((t == world).all())

    return {
        "all_reduce_sum_f32": all_reduce(torch.float32, dist.ReduceOp.SUM, world * (world + 1) / 2),
        "all_reduce_sum_f64": all_reduce(torch.float64, dist.ReduceOp.SUM, world * (world + 1) / 2),
        "all_reduce_min_f32": all_reduce(torch.float32, dist.ReduceOp.MIN, 1.0),
        "all_reduce_scalar_f64": scalar,
        "all_gather_into_tensor": gather,
        "reduce_scatter_tensor": scatter,
        "all_gather_object": objects,
        "device_mesh_1d": mesh_1d,
        "device_mesh_2d": mesh_2d,
    }


def _rank(rank: int, world: int, store: str, out_path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    results = {}
    for name, run in _cases(rank, world).items():
        try:
            results[name] = "ok" if run() else "wrong values"
        except Exception as exc:  # the probe records what fails and goes on
            results[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.json")
        mp.start_processes(_rank, args=(2, os.path.join(tmp, "store"), out_path), nprocs=2,
                           start_method="spawn")
        with open(out_path) as f:
            results = json.load(f)
    print(json.dumps({"torch": torch.__version__, "device": torch.cuda.get_device_name(0),
                      "collectives": results}), flush=True)


if __name__ == "__main__":
    main()
