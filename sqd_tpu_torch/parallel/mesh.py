# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Process-group meshes for sharded SQD execution (port of ``sqd_tpu.parallel.mesh``).

The port runs one process per rank, the PyTorch idiom, where ``sqd_tpu`` runs
one controller over a JAX mesh.  A JAX mesh axis becomes a named dimension
of a :class:`torch.distributed.device_mesh.DeviceMesh`, and the dimension's
process group carries the collectives that ``lax.psum``/``all_gather``/
``psum_scatter`` name in ``sqd_tpu``.  The solvers reach those collectives
through :class:`MeshAxis`.  Without an initialised process group there is no
mesh: a solver then runs alone, as one rank, and communicates nothing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["MeshAxis", "batch_sharding", "default_mesh", "flat_axis", "mesh_axis"]


def default_mesh(axis_name: str = "batch", devices=None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over the ranks ``devices`` of the default
    process group (which must be initialised:
    :func:`~.distributed.init_distributed`), every rank when ``None``.  Every
    rank of the group calls it; one outside ``devices`` holds no coordinate."""
    if devices is None:
        return init_device_mesh(device_type, (dist.get_world_size(),),
                                mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, group_ranks(devices), mesh_dim_names=(axis_name,))


def group_ranks(devices) -> list[int]:
    """``devices`` as a list of distinct ranks of the default process group
    (``sqd_tpu``'s mesh takes a subset of devices; the port's a subset of
    ranks); raises on a rank outside the group or a repeated one."""
    world = dist.get_world_size()
    ranks = [int(r) for r in devices]
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"devices {ranks} must be distinct ranks of the process group "
                         f"(world size {world})")
    return ranks


def _rank_range(size: int, rank: int, length: int) -> range:
    step = -(-length // size)
    return range(min(rank * step, length), min((rank + 1) * step, length))


def batch_sharding(mesh: DeviceMesh | None, axis_name: str = "batch"):
    """How a leading (batch) axis splits over ``mesh``'s ``axis_name``: a
    function from the axis' length to the index range this rank holds.

    The ranges are contiguous blocks of ``ceil(length / size)``, the split
    of ``torch.chunk`` and of a ``[Shard(0)]`` placement, in rank order; the
    last ranks may hold fewer entries or none.  With ``mesh=None`` (no
    process group) the one rank holds everything.
    """
    axis = mesh_axis(mesh, axis_name)
    return functools.partial(_rank_range, axis.size, axis.rank)


def _all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    # torch renamed the collective after 2.11 and deprecated the old name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)


def _reduce_scatter_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, t, group=group)


@dataclass(frozen=True)
class MeshAxis:
    """One mesh dimension as a solver uses it: its process group (``None``:
    no process group, one rank), its size and this rank's coordinate.

    Every collective completes along dim 0 of its operand and returns a new
    tensor; without a group it returns the operand itself.
    """

    group: object
    size: int
    rank: int

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the axis (the same on every rank)."""
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 0, in rank order."""
        if self.group is None:
            return t
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        _all_gather_into(out, t.contiguous(), self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block (dim 0 cut in ``size`` equal blocks) of the ranks'
        ``t`` summed."""
        if self.group is None:
            return t
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        _reduce_scatter_into(out, t.contiguous(), self.group)
        return out

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def mesh_axis(mesh: DeviceMesh | None, axis_name: str) -> MeshAxis:
    """``mesh``'s dimension ``axis_name`` (a 1-D mesh's only dimension,
    whatever its name); the one-rank axis for ``mesh=None``."""
    if mesh is None:
        return MeshAxis(None, 1, 0)
    if mesh.ndim == 1:
        return MeshAxis(mesh.get_group(), mesh.size(), mesh.get_local_rank())
    return MeshAxis(mesh.get_group(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name)),
                    mesh.get_local_rank(axis_name))


def resolve_mesh(mesh: DeviceMesh | None, axis_name: str, device: torch.device):
    """The 1-D mesh a solver runs on: ``mesh`` itself when it is 1-D, ``mesh``
    flattened when it has several dimensions (``sqd_tpu`` flattens and
    renames), :func:`default_mesh` when ``mesh`` is ``None`` and a process
    group exists, else ``None`` (one rank, no communication)."""
    if mesh is None:
        return default_mesh(axis_name, device_type=device.type) if dist.is_initialized() else None
    if mesh.ndim == 1:
        return mesh
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1), mesh_dim_names=(axis_name,))


def flat_axis(mesh: DeviceMesh | None) -> MeshAxis:
    """Every rank of ``mesh`` as one axis (``sqd_tpu`` reduces over all of a
    mesh's axis names at once); the one-rank axis for ``mesh=None``."""
    if mesh is None or mesh.ndim == 1:
        return mesh_axis(mesh, "")
    flat = DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1), mesh_dim_names=("flat",))
    return mesh_axis(flat, "flat")
