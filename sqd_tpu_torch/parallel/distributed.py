# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Multi-process initialisation (port of ``sqd_tpu.parallel.distributed``).

``sqd_tpu`` wires its host processes into one JAX runtime and runs its
``shard_map`` solvers over a global mesh.  The port runs one process per
rank (one per card on the GPU), joined into one ``torch.distributed``
process group; every rank runs the same program, and the sharded solvers of
:mod:`sqd_tpu_torch.parallel` run their collectives over the group::

    import sqd_tpu_torch.parallel as par
    par.init_distributed()                      # no-op without a configuration
    mesh = par.global_mesh("batch")             # every rank of the group
    results = par.solve_sci_batch_sharded(..., mesh=mesh)

A single process without configuration is the degenerate case:
:func:`init_distributed` returns ``False`` without touching anything and
the solvers run alone, communicating nothing.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .mesh import mesh_axis

__all__ = ["global_mesh", "host_local", "init_distributed", "is_distributed",
           "replicate_to_host"]


def is_distributed() -> bool:
    """True when more than one process takes part in the process group."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    platform: str | None = None,
) -> bool:
    """Join this process into the ranks' process group (idempotent).

    Each argument defaults, in order of precedence, to the explicit value,
    then its ``SQD_TPU_*`` variable:

    * ``SQD_TPU_COORDINATOR`` — ``host:port`` of rank 0's store;
    * ``SQD_TPU_NUM_PROCESSES`` — world size;
    * ``SQD_TPU_PROCESS_ID`` — this process's rank.

    ``platform="cpu"`` selects the gloo backend (the counterpart of
    ``sqd_tpu``'s gloo CPU collectives); otherwise the backend is NCCL, and
    this rank takes the card ``local_device_ids[0]``, by default its rank
    modulo the host's card count.

    Returns ``True`` if the process group was (or already had been)
    initialised, ``False`` when no coordinator is configured, in which case
    nothing was changed and every solver runs alone.
    """
    if dist.is_initialized():
        # our own earlier call, or the caller wired the group directly
        return True
    coordinator_address = coordinator_address or os.environ.get("SQD_TPU_COORDINATOR")
    if num_processes is None and "SQD_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SQD_TPU_NUM_PROCESSES"])
    if process_id is None and "SQD_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SQD_TPU_PROCESS_ID"])
    if coordinator_address is None:
        return False  # single process: the degenerate case, nothing to do
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the world size and this process's rank "
                         "(num_processes/process_id or SQD_TPU_NUM_PROCESSES/_PROCESS_ID)")
    backend = "gloo" if platform == "cpu" else "nccl"
    if backend == "nccl":
        card = (local_device_ids[0] if local_device_ids is not None
                else process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    except (RuntimeError, ValueError) as exc:
        # raced: the group was initialised between the check above and this
        # call.  The primary signal is that it now reports initialised; the
        # message ("twice") is the fallback for versions where it lags.
        if not (dist.is_initialized() or "twice" in str(exc).lower()):
            raise
    return True


def host_local(value):
    """Host (numpy) copy of a tensor when several processes run, else as is.

    ``sqd_tpu`` needs it before placing a value on a mesh that spans other
    processes; here it gives every rank the same host value to start from.
    """
    if is_distributed() and isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def replicate_to_host(value: torch.Tensor, mesh: DeviceMesh | None,
                      axis_name: str | None = None) -> np.ndarray:
    """Host copy of a global array of which ``value`` is this rank's block
    along dim 0 over ``mesh``'s ``axis_name`` (a 1-D mesh's only dimension by
    default), on every rank: one all-gather, then a copy to the host.
    Without a mesh, ``value`` is the whole array."""
    if mesh is not None:
        value = mesh_axis(mesh, axis_name or mesh.mesh_dim_names[0]).all_gather(value)
    return value.detach().cpu().numpy()


def global_mesh(*axis_names: str, axis_sizes: tuple[int, ...] | None = None,
                device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the process group.

    One name gives a 1-D mesh over all ranks.  Several names take their
    factorisation from ``axis_sizes``; by default the first axis counts the
    hosts (the world over the host's card count) and the second the cards
    of one host, so that collectives along the trailing axis stay on one
    host, as ``sqd_tpu`` keeps them within a slice.
    """
    world = dist.get_world_size()
    if not axis_names:
        axis_names = ("batch",)
    if len(axis_names) == 1:
        return init_device_mesh(device_type, (world,), mesh_dim_names=axis_names)
    if axis_sizes is None:
        if len(axis_names) != 2:
            raise ValueError("pass axis_sizes for meshes with more than two axes")
        per_host = torch.cuda.device_count() if device_type == "cuda" else world
        per_host = per_host if per_host and world % per_host == 0 else world
        axis_sizes = (world // per_host, per_host)
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"axis_sizes {axis_sizes} does not cover {world} ranks")
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=axis_names)
