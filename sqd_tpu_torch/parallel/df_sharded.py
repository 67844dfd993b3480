# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One solve with the density-fitting (factor) axis sharded over the ranks
(port of ``sqd_tpu.parallel.df_sharded``).

The dense density-fitted operator (:mod:`sqd_tpu_torch.ops.dense_df`) writes
the cross-spin channel as ``sigma_ab = sum_x Wa_x @ c @ Wb_x^T``, a sum over
the factor index x.  Each rank builds only its ``X / size`` slice of the
``(M, M)`` and ``(N, N)`` factor stacks, from its rows of the factor ``L``
(the dominant memory, ``X (M^2 + N^2) / size`` values), and does its share of
the batched products; a matvec's one collective is an ``all_reduce`` of the
``(M, N)`` cross-spin sum, after which every rank adds the same-spin
products.  The Krylov state stays replicated: the inverse trade of
:mod:`.row_sharded`.

The f64 energy, the refinement and the RDMs use the exact (unfactored) f64
operator, replicated, as in ``sqd_tpu``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..fermion import _check_ci_strs, _result_of, _scaled_tol, _strings_to_packed
from ..ops.davidson import davidson_ground_state, davidson_initial_guess
from ..ops.dense_df import DenseDFOperator, _dense_samespin, _w_stack
from ..ops.hamiltonian import build_sci_hamiltonian, sci_matvec_flat
from ..ops.precision import highest_precision
from ..utils.device import checked_device
from .mesh import MeshAxis, mesh_axis, resolve_mesh

__all__ = ["solve_sci_dfsharded"]

_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class _FactorShard:
    """This rank's factor slice (``dense.wa``/``dense.wb``) with the
    replicated same-spin matrices and diagonal."""

    dense: DenseDFOperator
    axis: MeshAxis


def _dfsharded_matvec(op: _FactorShard, x: torch.Tensor) -> torch.Tensor:
    dense = op.dense
    c = x.reshape(dense.shape)
    sigma = torch.zeros_like(c)
    dense.add_cross_spin(sigma, c)
    sigma = op.axis.all_reduce(sigma)  # the one collective
    with highest_precision():
        sigma += dense.haa @ c
        sigma.addmm_(c, dense.hbb.T)
    return sigma.reshape(-1)


def solve_sci_dfsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    *,
    mesh=None,
    eri_factor="auto",
    solver_dtype=torch.float32,
    tol: float = 1e-6,
    max_subspace: int = 16,
    max_cycle: int = 200,
    refine_iterations: int | None = None,
    with_rdms: bool = True,
    device="cuda",
):
    """Ground state with the dense density-fitting factor axis sharded.

    Same result contract as :func:`sqd_tpu_torch.fermion.solve_sci` with
    ``matvec_strategy="dense_df"``: the Davidson iterates through the
    sharded dense operator (its tolerance scaled to the spectrum, as
    ``solve_sci`` scales it); the energy, the f64 refinement
    (``refine_iterations``, 6 by default after an f32 solve) and the RDMs use
    the exact f64 operator.  Needs symmetric PSD integrals with npair > 256
    (or an explicit ``eri_factor`` array).  ``mesh``: a 1-D ``DeviceMesh`` (a
    mesh of several dimensions is flattened); by default every rank of the
    process group, or this process alone when there is none.  Every rank
    returns the same result.
    """
    device = checked_device(device)
    axis = mesh_axis(resolve_mesh(mesh, _AXIS, device), _AXIS)
    if refine_iterations is None:
        refine_iterations = 0 if solver_dtype == torch.float64 else 6
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa, pb = _strings_to_packed(strs_a, norb), _strings_to_packed(strs_b, norb)
    ham64 = build_sci_hamiltonian(pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
                                  device=device, dtype=torch.float64, eri_factor=eri_factor)
    if ham64.eri_chol is None:
        raise ValueError(
            "solve_sci_dfsharded requires a PSD ERI factor — needs npair > 256 and "
            "symmetric PSD two_body_tensor, or an explicit eri_factor array"
        )
    # zero factor rows pad X to a multiple of the rank count (inert slices)
    ell = ham64.eri_chol
    x_loc = -(-ell.shape[0] // axis.size)
    ell = F.pad(ell, (0, 0, 0, x_loc * axis.size - ell.shape[0]))
    ell_loc = ell[axis.rank * x_loc : (axis.rank + 1) * x_loc]
    op = _FactorShard(
        DenseDFOperator(
            wa=_w_stack(ham64.src_a, ham64.sign_a, ell_loc, solver_dtype),
            wb=_w_stack(ham64.src_b, ham64.sign_b, ell_loc, solver_dtype),
            haa=_dense_samespin(ham64.nbr_idx_a, ham64.nbr_val_a, solver_dtype),
            hbb=_dense_samespin(ham64.nbr_idx_b, ham64.nbr_val_b, solver_dtype),
            hdiag=ham64.hdiag.to(solver_dtype),
        ),
        axis,
    )
    hd_flat = op.dense.hdiag.reshape(-1)
    result = davidson_ground_state(
        _dfsharded_matvec, op, hd_flat, davidson_initial_guess(hd_flat, solver_dtype),
        tol=_scaled_tol(hd_flat, tol), max_subspace=max_subspace, max_iterations=max_cycle,
    )
    del op  # the factor slices: freed before the f64 tail
    vec = result.vector.to(torch.float64)
    if refine_iterations > 0 and solver_dtype != torch.float64:
        vec = davidson_ground_state(
            sci_matvec_flat, ham64, ham64.hdiag.reshape(-1), vec,
            tol=tol, max_subspace=max_subspace, max_iterations=refine_iterations,
        ).vector
    return _result_of(ham64, vec, (strs_a, strs_b), (pa, pb), nelec, with_rdms)
