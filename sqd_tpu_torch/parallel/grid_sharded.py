# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One solve with the (alpha x beta) amplitude grid sharded in 2-D (port of
``sqd_tpu.parallel.grid_sharded``).

The mesh has two dimensions, ``"row"`` x ``"col"``: each rank owns an
``(M / nr, N / nc)`` block of the amplitudes, of the Krylov buffers and of
the diagonal, and no rank ever holds the whole direction.  A matvec makes
three collectives, none of them scaled by the ``norb^2`` pair axis:

* an all-gather over ``"row"``: the column panel ``(M, Nc)`` (the alpha
  gathers read any row at the local columns);
* an all-gather over ``"col"``: the row panel ``(Mr, N)`` (the same-spin
  beta neighbours read any column at the local rows);
* one reduce-scatter over ``"col"`` of an ``(Mr, N)`` partial: the beta pick
  ``sigma[i, j] += sign_b[pq, j] * g[pq, i, src_b[pq, j]]`` is computed by
  the rank that owns column ``src_b[pq, j]`` of ``g`` (a clamped reverse
  table: sources outside the local columns carry weight 0), and the
  contributions to each column are summed and sent to its owner.

The spin penalty's mixed term rides through the ERI matrix
(``SCIHamiltonian.penalty_folded_eri``), so one partial carries both.
Torch ops in every dtype (``sqd_tpu`` leaves this path to XLA), in row chunks
of at most ``cross_spin.PLAIN_CHUNK_BYTES`` per intermediate.  The Davidson
completes its reductions over every rank of the mesh; an f32 solve gets a
warm-started f64 polish.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..fermion import _check_ci_strs, _result_of, _strings_to_packed
from ..ops import cross_spin
from ..ops.davidson import davidson_ground_state, davidson_initial_guess_sharded
from ..ops.hamiltonian import SCIHamiltonian, build_sci_hamiltonian
from ..ops.precision import highest_precision
from ..utils.device import checked_device
from .mesh import MeshAxis, flat_axis, group_ranks, mesh_axis

__all__ = ["default_grid_mesh", "solve_sci_gridsharded"]

_AXES = ("row", "col")


def default_grid_mesh(devices=None, device_type: str = "cuda") -> DeviceMesh:
    """A near-square ``("row", "col")`` mesh over the ranks ``devices`` of the
    process group, every rank when ``None`` (as :func:`~.mesh.default_mesh`)."""
    if devices is None:
        world = dist.get_world_size()
        return init_device_mesh(device_type, _near_square(world), mesh_dim_names=_AXES)
    ranks = torch.tensor(group_ranks(devices))
    return DeviceMesh(device_type, ranks.reshape(_near_square(len(ranks))), mesh_dim_names=_AXES)


def _near_square(size: int) -> tuple[int, int]:
    nr = next(k for k in range(math.isqrt(size), 0, -1) if size % k == 0)
    return nr, size // nr


@dataclasses.dataclass(frozen=True)
class _GridShard:
    """This rank's block of one operator, in one dtype.  ``ham`` holds the
    local rows' alpha gather tables and same-spin alpha lists, the local
    columns' same-spin beta lists and the local diagonal block; ``loc`` and
    ``w_b`` are the clamped reverse beta tables ``(npair, N)`` of the local
    columns; ``eri`` is the penalty-folded ERI matrix."""

    ham: SCIHamiltonian
    loc: torch.Tensor
    w_b: torch.Tensor
    eri: torch.Tensor
    row: MeshAxis
    col: MeshAxis


def _grid_shard(ham64, rows, cols, row, col, dtype, bare=False) -> _GridShard:
    local = dataclasses.replace(
        ham64, src_a=ham64.src_a[:, rows], sign_a=ham64.sign_a[:, rows],
        nbr_idx_a=ham64.nbr_idx_a[rows], nbr_val_a=ham64.nbr_val_a[rows],
        nbr_idx_b=ham64.nbr_idx_b[cols], nbr_val_b=ham64.nbr_val_b[cols],
        hdiag=ham64.hdiag[rows, cols],
        **({"spin_shift": 0.0, "spin_target": 0.0} if bare else {}),
    ).astype(dtype)
    loc = ham64.src_b - cols.start
    valid = (loc >= 0) & (loc < cols.stop - cols.start)
    return _GridShard(local, torch.where(valid, loc, 0), torch.where(valid, ham64.sign_b, 0).to(dtype),
                      local.penalty_folded_eri(dtype), row, col)


def _gridsharded_matvec(op: _GridShard, x: torch.Tensor) -> torch.Tensor:
    """``H`` applied to this rank's ``(Mr, Nc)`` block of the flat direction."""
    ham = op.ham
    c_loc = x.reshape(ham.hdiag.shape)
    mr, ncl = c_loc.shape
    npair, n = op.w_b.shape
    c_col = op.row.all_gather(c_loc)  # (M, Nc)
    c_row = op.col.all_gather(c_loc.T).T  # (Mr, N)
    step = max(1, min(mr, cross_spin.PLAIN_CHUNK_BYTES
                      // (npair * max(n, ncl) * c_loc.element_size())))
    partial = c_loc.new_empty((n, mr))  # transposed, so that columns scatter along dim 0
    with highest_precision():
        for i0 in range(0, mr, step):
            rows = slice(i0, i0 + step)
            d = ham.sign_a[:, rows, None].to(c_loc.dtype) * c_col[ham.src_a[:, rows]]
            g = (op.eri @ d.reshape(npair, -1)).reshape(d.shape)  # (npair, r, Nc)
            del d
            picked = torch.gather(g, 2, op.loc[:, None, :].expand(npair, g.shape[1], n))
            del g
            partial[:, rows] = (op.w_b[:, None, :] * picked).sum(dim=0).T
            del picked
        sigma = op.col.reduce_scatter(partial).T  # (Mr, Nc)
        sigma = sigma + ham.apply_samespin_alpha(c_col)
        sigma += ham.apply_samespin_beta(c_row)
        if ham.spin_shift != 0.0:
            sigma += ham.spin_shift * (ham._s2_const() - ham.spin_target) * c_loc
    return sigma.reshape(-1)


def _grid_mesh(mesh, device: torch.device):
    if mesh is None:
        return default_grid_mesh(device_type=device.type) if dist.is_initialized() else None
    if tuple(mesh.mesh_dim_names or ()) != _AXES:
        return default_grid_mesh(mesh.mesh.reshape(-1).tolist(), mesh.device_type)
    return mesh


def solve_sci_gridsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh: DeviceMesh | None = None,
    solver_dtype=torch.float32,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_cycle: int = 200,
    refine_iterations: int | None = None,
    with_rdms: bool = False,
    device="cuda",
):
    """Diagonalize ONE subspace with the amplitude grid sharded in 2-D.

    Same contract as :func:`sqd_tpu_torch.fermion.solve_sci` (fused spin
    penalty, bare-Hamiltonian f64 energy, an f64 polish after an f32 solve),
    with ``sqd_tpu``'s defaults.  ``mesh``: a ``("row", "col")``
    ``DeviceMesh`` (another mesh is replaced by :func:`default_grid_mesh`
    over its ranks);
    by default :func:`default_grid_mesh`, or this process alone when there is
    no process group.  Every rank returns the same result.
    """
    device = checked_device(device)
    mesh = _grid_mesh(mesh, device)
    row, col = mesh_axis(mesh, "row"), mesh_axis(mesh, "col")
    everyone = flat_axis(mesh)
    if refine_iterations is None:
        refine_iterations = 0 if solver_dtype == torch.float64 else 6
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa, pb = _strings_to_packed(strs_a, norb), _strings_to_packed(strs_b, norb)
    # row and column counts divisible by the mesh, in multiples of 8 and 128
    step_m, step_n = math.lcm(row.size, 8), math.lcm(col.size, 128)
    m_pad = -(-len(strs_a) // step_m) * step_m
    n_pad = -(-len(strs_b) // step_n) * step_n
    with_spin = spin_sq is not None
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec, device=device,
        spin_shift=float(shift) if with_spin else 0.0,
        spin_target=float(spin_sq) if with_spin else 0.0,
        dtype=torch.float64, pad_to=(m_pad, n_pad), col_block=0, eri_factor=None,
    )
    mr, ncl = ham64.shape[0] // row.size, ham64.shape[1] // col.size
    rows = slice(row.rank * mr, (row.rank + 1) * mr)
    cols = slice(col.rank * ncl, (col.rank + 1) * ncl)

    def shard(dtype, bare=False):
        return _grid_shard(ham64, rows, cols, row, col, dtype, bare)

    op = shard(solver_dtype)
    hdiag = op.ham.hdiag.reshape(-1)
    res = davidson_ground_state(
        _gridsharded_matvec, op, hdiag, davidson_initial_guess_sharded(hdiag, everyone.group),
        tol=tol, max_subspace=max_subspace, max_iterations=max_cycle, group=everyone.group,
    )
    del op
    vec = res.vector.to(torch.float64)
    if refine_iterations > 0 and solver_dtype != torch.float64:
        op64 = shard(torch.float64)
        vec = davidson_ground_state(
            _gridsharded_matvec, op64, op64.ham.hdiag.reshape(-1), vec,
            tol=tol, max_subspace=max_subspace, max_iterations=refine_iterations,
            group=everyone.group,
        ).vector
        del op64
    hv = _gridsharded_matvec(shard(torch.float64, bare=True), vec)
    num_den = everyone.all_reduce(torch.stack([torch.dot(vec, hv), torch.dot(vec, vec)]))
    block = vec.reshape(mr, ncl)
    vec_full = col.all_gather(row.all_gather(block).T).T  # (M, N)
    return _result_of(ham64, vec_full.reshape(-1), (strs_a, strs_b), (pa, pb), nelec, with_rdms,
                      energy=float(num_den[0] / num_den[1]))
