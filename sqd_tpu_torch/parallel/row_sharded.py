# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One solve with the alpha-row (determinant) axis sharded over the ranks
(port of ``sqd_tpu.parallel.row_sharded``).

Each rank owns ``M / size`` alpha rows of the ``(M, N)`` amplitudes, of the
Krylov buffers (the dominant memory, ``max_subspace x M x N``), of the
alpha gather tables and same-spin alpha lists, and of the diagonal.  The
Davidson completes every inner product, norm and Gram entry over the ranks
(``davidson_ground_state(group=...)``), and the matvec's one collective is an
all-gather of the direction (``M * N`` values):

* cross-spin: the local output rows' alpha gathers read GLOBAL source rows
  of the gathered direction; the pair contraction and the beta picks are
  then row-local.  This is the cross-spin CUDA kernel of the direction's
  dtype (``SCIHamiltonian.apply_cross_spin``: f32 in the solve, f64 in the
  refinement and the energy) on operands restricted to the local rows
  (:func:`~sqd_tpu_torch.ops.cross_spin.prepare` on the local columns of
  the alpha tables: the kernel's output rows are this rank's, its alpha
  sources index the gathered ``(M, N)`` direction).  ``sqd_tpu``'s einsum
  form would hold ``(npair, M / size, N)`` intermediates, which XLA fuses
  and PyTorch does not: 2 x 20 GB in f32 for the N2/6-31G CASCI on one
  rank;
* same-spin alpha: local output rows, global neighbour rows; same-spin beta
  is row-local;
* the spin penalty's mixed term rides through the ERI matrix
  (``SCIHamiltonian.penalty_folded_eri``), the rest of it is diagonal.

The f32 solve is polished by a few warm-started f64 iterations before the
energy (the bare Hamiltonian's, completed over the ranks) and the RDMs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..fermion import _check_ci_strs, _result_of, _strings_to_packed
from ..ops.davidson import davidson_ground_state, davidson_initial_guess_sharded
from ..ops.hamiltonian import SCIHamiltonian, build_sci_hamiltonian
from ..ops.precision import highest_precision
from ..utils.device import checked_device
from .mesh import MeshAxis, mesh_axis, resolve_mesh

__all__ = ["solve_sci_batch_rowsharded", "solve_sci_rowsharded"]

_AXIS = "row"


@dataclasses.dataclass(frozen=True)
class _RowShard:
    """This rank's rows of one operator: ``ham`` holds the alpha gather tables,
    same-spin alpha lists and diagonal of the local rows (sources and
    neighbours index all ``M`` rows), every beta table, and the ERI matrix,
    in one dtype."""

    ham: SCIHamiltonian
    axis: MeshAxis


def _row_shard(ham64: SCIHamiltonian, rows: slice, axis: MeshAxis, dtype,
               bare: bool = False) -> _RowShard:
    local = dataclasses.replace(
        ham64, src_a=ham64.src_a[:, rows], sign_a=ham64.sign_a[:, rows],
        nbr_idx_a=ham64.nbr_idx_a[rows], nbr_val_a=ham64.nbr_val_a[rows],
        hdiag=ham64.hdiag[rows],
        **({"spin_shift": 0.0, "spin_target": 0.0} if bare else {}),
    ).astype(dtype)
    return _RowShard(local, axis)


def _rowsharded_matvec(op: _RowShard, x: torch.Tensor) -> torch.Tensor:
    """``H`` applied to this rank's rows of the flat direction."""
    ham = op.ham
    c_loc = x.reshape(ham.hdiag.shape)
    c_full = op.axis.all_gather(c_loc)  # the one collective: (M, N)
    with highest_precision():
        sigma = ham.apply_cross_spin(c_full)
        sigma += ham.apply_samespin_alpha(c_full)
        sigma += ham.apply_samespin_beta(c_loc)
        if ham.spin_shift != 0.0:
            sigma += ham.spin_shift * (ham._s2_const() - ham.spin_target) * c_loc
    return sigma.reshape(-1)


def _sharded_energy(op: _RowShard, vec_loc: torch.Tensor, axis: MeshAxis) -> float:
    """``<v|H|v> / <v|v>`` of a vector split like ``op``'s rows (f64)."""
    hv = _rowsharded_matvec(op, vec_loc)
    num_den = axis.all_reduce(torch.stack([torch.dot(vec_loc, hv), torch.dot(vec_loc, vec_loc)]))
    return float(num_den[0] / num_den[1])


def solve_sci_rowsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh=None,
    solver_dtype=torch.float32,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_cycle: int = 200,
    refine_iterations: int | None = None,
    with_rdms: bool = False,
    device="cuda",
):
    """Diagonalize ONE subspace with the alpha-determinant axis sharded.

    Same contract as :func:`sqd_tpu_torch.fermion.solve_sci` (the fused spin
    penalty steers, the energy is the bare Hamiltonian's, and an f32 solve
    gets ``refine_iterations`` warm-started f64 iterations, 6 by default,
    before the energy, RDMs and occupancies), with ``sqd_tpu``'s defaults.
    ``mesh``: a 1-D ``DeviceMesh`` (a mesh of several dimensions is
    flattened); by default every rank of the process group, or this process
    alone when there is none.  Every rank returns the same result.
    """
    device = checked_device(device)
    axis = mesh_axis(resolve_mesh(mesh, _AXIS, device), _AXIS)
    if refine_iterations is None:
        refine_iterations = 0 if solver_dtype == torch.float64 else 6
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa, pb = _strings_to_packed(strs_a, norb), _strings_to_packed(strs_b, norb)
    # every rank gets the same row count, a multiple of 8
    step = math.lcm(axis.size, 8)
    m_pad = -(-len(strs_a) // step) * step
    with_spin = spin_sq is not None
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec, device=device,
        spin_shift=float(shift) if with_spin else 0.0,
        spin_target=float(spin_sq) if with_spin else 0.0,
        dtype=torch.float64, pad_to=(m_pad, len(strs_b)), col_block=0, eri_factor=None,
    )
    m_loc = ham64.shape[0] // axis.size
    rows = slice(axis.rank * m_loc, (axis.rank + 1) * m_loc)

    op = _row_shard(ham64, rows, axis, solver_dtype)
    hdiag = op.ham.hdiag.reshape(-1)
    res = davidson_ground_state(
        _rowsharded_matvec, op, hdiag, davidson_initial_guess_sharded(hdiag, axis.group),
        tol=tol, max_subspace=max_subspace, max_iterations=max_cycle, group=axis.group,
    )
    del op
    vec = res.vector.to(torch.float64)
    if refine_iterations > 0 and solver_dtype != torch.float64:
        # an f32-converged vector's occupancies carry ~1e-4 noise at 1e5
        # determinants and more: polish in f64, as solve_sci does
        op64 = _row_shard(ham64, rows, axis, torch.float64)
        vec = davidson_ground_state(
            _rowsharded_matvec, op64, op64.ham.hdiag.reshape(-1), vec,
            tol=tol, max_subspace=max_subspace, max_iterations=refine_iterations,
            group=axis.group,
        ).vector
        del op64
    energy = _sharded_energy(_row_shard(ham64, rows, axis, torch.float64, bare=True), vec, axis)
    vec_full = axis.all_gather(vec.reshape(m_loc, -1))
    return _result_of(ham64, vec_full.reshape(-1), (strs_a, strs_b), (pa, pb), nelec, with_rdms,
                      energy=energy)


def solve_sci_batch_rowsharded(ci_strings, one_body_tensor, two_body_tensor, norb: int, nelec,
                               **kwargs):
    """``sci_solver``-seam adapter: each batch by :func:`solve_sci_rowsharded`,
    one after another, every batch over every rank (for subspaces too large
    for one card, where :func:`~.batch_solver.solve_sci_batch_sharded` would
    put a whole batch on one).  ``kwargs`` go to :func:`solve_sci_rowsharded`."""
    return [
        solve_sci_rowsharded(cs, one_body_tensor, two_body_tensor, norb, nelec, **kwargs)
        for cs in ci_strings
    ]
