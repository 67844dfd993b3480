# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One solve with the excitation-pair axis sharded over the ranks (port of
``sqd_tpu.parallel.sharded_solve``).

Each rank holds a block of the ``norb^2`` pair axis of the cross-spin
channel: the alpha gather tables of its pairs, the beta gather tables of its
pairs and the replicated ERI matrix.  A matvec gathers the alpha side of its
pairs, contracts them with its columns of the ERI matrix for every rank's
block of output pairs, and completes each block with one ``all_reduce``
(``sqd_tpu``'s blockwise ``psum`` ring, one collective per block; the rank
that owns the block keeps it), picks the beta side of its own pairs, and
completes ``sigma`` with one more ``all_reduce``.  The amplitudes and the
Krylov buffers stay replicated, so the Davidson runs unchanged on every rank.

Per-rank memory of the per-pair intermediates drops from ``npair * M * N``
to ``npair / size * M * N``.  The spin penalty's mixed term rides through the
ERI matrix (``SCIHamiltonian.penalty_folded_eri``), so its qp-permuted beta
tables are not needed.  These are torch ops on every device: ``sqd_tpu``
leaves this path to XLA, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..fermion import _check_ci_strs, _result_of, _strings_to_packed
from ..ops.davidson import davidson_ground_state, davidson_initial_guess
from ..ops.hamiltonian import SCIHamiltonian, build_sci_hamiltonian
from ..ops.precision import highest_precision
from ..utils.device import checked_device
from .mesh import MeshAxis, mesh_axis, resolve_mesh

__all__ = ["solve_sci_distributed"]

_AXIS = "pair"


@dataclass(frozen=True)
class _PairShard:
    """This rank's pair block of one operator, in the solver's dtype."""

    ham: SCIHamiltonian  # the whole operator: same-spin lists and diagonal term
    src_a: torch.Tensor  # (npl, M) alpha gathers of my pairs
    sign_a: torch.Tensor
    src_b: torch.Tensor  # (npl, N) beta picks of my pairs
    sign_b: torch.Tensor
    eri: torch.Tensor  # (npair, npl): my columns of the (penalty-folded) ERI matrix
    axis: MeshAxis


def _pair_shard(ham: SCIHamiltonian, axis: MeshAxis, dtype) -> _PairShard:
    npl = ham.norb * ham.norb // axis.size
    mine = slice(axis.rank * npl, (axis.rank + 1) * npl)
    return _PairShard(
        ham=ham.astype(dtype),
        src_a=ham.src_a[mine], sign_a=ham.sign_a[mine].to(dtype),
        src_b=ham.src_b[mine], sign_b=ham.sign_b[mine].to(dtype),
        eri=ham.penalty_folded_eri(dtype)[:, mine].contiguous(),
        axis=axis,
    )


def _sharded_matvec(op: _PairShard, x: torch.Tensor) -> torch.Tensor:
    """The whole ``sigma`` from the replicated flat ``x``, on every rank."""
    m, n = op.ham.shape
    npl = op.src_a.shape[0]
    c = x.reshape(m, n)
    with highest_precision():
        d = (op.sign_a[:, :, None] * c[op.src_a]).reshape(npl, m * n)
        # G'[rs] = sum_pq (pq|rs) D[pq]: every rank adds its pairs' share to
        # each block of output pairs; the block's owner keeps the sum
        for r in range(op.axis.size):
            part = op.axis.all_reduce(op.eri[r * npl : (r + 1) * npl] @ d)
            if r == op.axis.rank:
                g = part.reshape(npl, m, n)
        del d, part
        picked = torch.gather(g, 2, op.src_b[:, None, :].expand(npl, m, n))
        del g
        sigma = op.axis.all_reduce((op.sign_b[:, None, :] * picked).sum(dim=0))
        del picked
        sigma += op.ham.apply_samespin_alpha(c)
        sigma += op.ham.apply_samespin_beta(c)
        if op.ham.spin_shift != 0.0:
            sigma += op.ham.spin_shift * (op.ham._s2_const() - op.ham.spin_target) * c
    return sigma.reshape(-1)


def solve_sci_distributed(
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
    tol: float = 1e-4,
    max_subspace: int = 32,
    max_cycle: int = 200,
    with_rdms: bool = False,
    device="cuda",
):
    """Diagonalize ONE subspace with the pair axis sharded over the ranks.

    Same contract as :func:`sqd_tpu_torch.fermion.solve_sci` (the fused
    ``shift * (S^2 - spin_sq)`` penalty steers; the energy is the bare
    Hamiltonian's, in f64), with ``sqd_tpu``'s defaults and no f64
    refinement.  ``mesh``: a 1-D ``DeviceMesh`` (a mesh of several
    dimensions is flattened); by default every rank of the process group, or
    this process alone when there is none.  ``norb**2`` must divide over the
    ranks.  Every rank returns the same result.
    """
    device = checked_device(device)
    axis = mesh_axis(resolve_mesh(mesh, _AXIS, device), _AXIS)
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa, pb = _strings_to_packed(strs_a, norb), _strings_to_packed(strs_b, norb)
    npair = norb * norb
    if npair % axis.size:
        raise ValueError(f"norb^2 = {npair} must divide evenly over {axis.size} ranks.")
    ham64 = build_sci_hamiltonian(pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
                                  device=device, dtype=torch.float64, col_block=0,
                                  eri_factor=None)
    steered = ham64
    if spin_sq is not None:
        steered = dataclasses.replace(ham64, spin_shift=float(shift), spin_target=float(spin_sq))
    op = _pair_shard(steered, axis, solver_dtype)
    hdiag = ham64.hdiag.reshape(-1).to(solver_dtype)
    res = davidson_ground_state(
        _sharded_matvec, op, hdiag, davidson_initial_guess(hdiag, solver_dtype),
        tol=tol, max_subspace=max_subspace, max_iterations=max_cycle,
    )
    del op
    return _result_of(ham64, res.vector, (strs_a, strs_b), (pa, pb), nelec, with_rdms)
