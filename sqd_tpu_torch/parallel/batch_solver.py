# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Batch diagonalizations dealt to the ranks — the ``sci_solver`` seam on
``torch.distributed`` (port of ``sqd_tpu.parallel.batch_solver``).

The per-iteration batch solves of the SQD loop are independent.  ``sqd_tpu``
pads every batch to one bucket shape, stacks the operators and runs one
vmapped Davidson with the batch axis sharded over the mesh.  PyTorch has no
vmap of a loop whose length depends on the data, so here each rank takes a
contiguous block of the batches (:func:`~.mesh.batch_sharding`) and solves
them one after another through the port's single-device path: the Davidson
in ``solver_dtype`` (in f32 the cross-spin CUDA kernel on the card), the
bare-Hamiltonian f64 energy and the occupancies from the exact
single-excitation gathers.  Every rank then receives every result, in input
order (``all_gather_object``), so the loop's host epilogue runs the same on
each.  ``pad_bucket`` keeps ``sqd_tpu``'s padding rule: every batch is
padded to the largest batch rounded up to it.

Drop-in usage::

    from sqd_tpu_torch.parallel import solve_sci_batch_sharded
    result = diagonalize_fermionic_hamiltonian(..., sci_solver=solve_sci_batch_sharded)
"""

from __future__ import annotations

import numpy as np
import torch

from ..fermion import SCIResult, SCIState, _check_ci_strs, _round_up, _strings_to_packed
from ..ops import rdm as rdm_ops
from ..ops.davidson import davidson_ground_state, davidson_initial_guess
from ..ops.hamiltonian import build_sci_hamiltonian, expectation_value, sci_matvec_flat
from ..utils.device import checked_device
from .mesh import batch_sharding, mesh_axis, resolve_mesh

__all__ = ["solve_sci_batch_sharded"]


def _solve_one(ham32, ham64, tol: float, max_subspace: int, max_cycle: int):
    """Davidson in the working dtype, then the f64 energy and occupancies of
    one batch; returns the energy, the f64 ``(M, N)`` amplitudes and the
    alpha and beta occupancies."""
    hd = ham32.hdiag.reshape(-1)
    res = davidson_ground_state(
        sci_matvec_flat, ham32, hd, davidson_initial_guess(hd),
        tol=tol, max_subspace=max_subspace, max_iterations=max_cycle,
    )
    vec = res.vector.to(torch.float64)
    vec = vec / torch.linalg.norm(vec)
    # the bare Hamiltonian's energy: the spin penalty only steers the iteration
    energy = expectation_value(ham64, vec, spin_penalty=False)
    rdms = rdm_ops.make_rdms(ham64, vec.reshape(ham64.shape), with_dm2=False)
    return (energy, vec.reshape(ham64.shape),
            torch.diagonal(rdms["dm1a"]).cpu().numpy(), torch.diagonal(rdms["dm1b"]).cpu().numpy())


def solve_sci_batch_sharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh=None,
    solver_dtype=torch.float32,
    tol: float = 1e-6,
    max_subspace: int = 24,
    max_cycle: int = 200,
    pad_bucket: int = 64,
    with_rdms: bool = False,
    device="cuda",
    **kwargs,
):
    """Diagonalize the batch subspaces with the batches dealt over the ranks.

    Signature-compatible with :func:`sqd_tpu_torch.fermion.solve_sci_batch`
    (see the module docstring); the arguments are ``sqd_tpu``'s plus
    ``device`` (this rank's device).

    Args:
        ci_strings: list of (strings_a, strings_b) integer arrays; every rank
            passes the same list.
        one_body_tensor / two_body_tensor: integrals (chemist convention).
        norb, nelec: orbital / electron counts.
        spin_sq / shift: optional S^2 penalty (as in ``solve_sci``).
        mesh: a 1-D ``DeviceMesh``; by default every rank of the process
            group, or this process alone when there is none.
        solver_dtype: Davidson dtype (f32 by default; the energy is f64).
        tol / max_subspace / max_cycle: Davidson controls.
        pad_bucket: padding granularity of the common batch shape.
        with_rdms: also attach the spin-summed 1- and 2-RDMs.

    Returns:
        One :class:`~sqd_tpu_torch.fermion.SCIResult` per batch, in input
        order, on every rank.
    """
    device = checked_device(device)
    mesh = resolve_mesh(mesh, "batch", device)
    axis = mesh_axis(mesh, "batch")
    checked = [_check_ci_strs(cs) for cs in ci_strings]
    m_pad = _round_up(max(len(a) for a, _ in checked), pad_bucket)
    n_pad = _round_up(max(len(b) for _, b in checked), pad_bucket)
    mine = batch_sharding(mesh, "batch")(len(checked))

    solved = []
    for i in mine:
        strs_a, strs_b = checked[i]
        pa, pb = _strings_to_packed(strs_a, norb), _strings_to_packed(strs_b, norb)
        ham64 = build_sci_hamiltonian(
            pa, pb, one_body_tensor, two_body_tensor, norb, nelec, device=device,
            spin_shift=0.0 if spin_sq is None else float(shift),
            spin_target=0.0 if spin_sq is None else float(spin_sq),
            dtype=torch.float64, pad_to=(m_pad, n_pad), eri_factor=None,
        )
        energy, vec, occ_a, occ_b = _solve_one(
            ham64.astype(solver_dtype), ham64, tol, max_subspace, max_cycle)
        rdm1 = rdm2 = None
        if with_rdms:
            rdms = rdm_ops.make_rdms(ham64, vec, pa, pb)
            rdm1 = (rdms["dm1a"] + rdms["dm1b"]).cpu().numpy()
            rdm2 = rdms["dm2"].cpu().numpy()
        amp = vec[: len(strs_a), : len(strs_b)].cpu().numpy()
        solved.append((i, energy, amp, occ_a, occ_b, rdm1, rdm2))

    by_index = {}
    for part in axis.all_gather_object(solved):
        by_index.update((entry[0], entry[1:]) for entry in part)
    results = []
    for i, (strs_a, strs_b) in enumerate(checked):
        energy, amp, occ_a, occ_b, rdm1, rdm2 = by_index[i]
        nrm = np.linalg.norm(amp)
        state = SCIState(
            amplitudes=amp / nrm if nrm > 0 else amp,
            ci_strs_a=strs_a,
            ci_strs_b=strs_b,
            norb=norb,
            nelec=tuple(int(x) for x in nelec),
            device=device,
        )
        results.append(SCIResult(float(energy), state, orbital_occupancies=(occ_a, occ_b),
                                 rdm1=rdm1, rdm2=rdm2))
    return results
