# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fermionic SQD: the fixed-subspace SCI solve and the self-consistent loop.

The port of ``sqd_tpu.fermion``.  :func:`solve_sci` applies the projected
Hamiltonian through :mod:`sqd_tpu_torch.ops.hamiltonian` (the f32
opposite-spin channel through the CUDA kernel on the card), runs the Davidson
iterations in ``solver_dtype`` (f32 above 200k determinants), refines an f32
solution with a few f64 iterations, and evaluates the energy, RDMs and
occupancies in f64.  :func:`diagonalize_fermionic_hamiltonian` is the SQD
loop around it, with ``sqd_tpu``'s control flow: postselect (iteration 0) or
recover configurations (on the device), subsample, assemble each batch's
strings, solve the batches through the ``sci_solver`` seam, keep the best,
test convergence, carry strings over.  Public results keep ``sqd_tpu``'s
layout: numpy amplitudes ``(M, N)``, numpy RDMs and occupancies.

The rest of ``sqd_tpu.fermion`` is here too: :func:`solve_sci_excited` (the
k lowest states by the block Davidson), :func:`rotate_integrals` and
:func:`optimize_orbitals` (SGD with momentum on the RDM-contracted rotated
energy, its gradient by ``torch.autograd``; on the card each step is one
replayed CUDA graph), :func:`apply_excitations` and
:func:`enlarge_batch_from_transitions` (broadcast bool tensor ops),
``SCIState.save``/``load`` and the loop's ``checkpoint_path``/``resume``
(files in ``sqd_tpu``'s layouts, readable by either package).

Every entry point runs on the card (``device="cuda"``) unless the caller
passes another device; a CUDA request without a card raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, cast

import numpy as np
import torch

from . import native
from .configuration_recovery import recover_configurations
from .counts import bit_array_to_arrays, bitstring_matrix_to_integers
from .ops import bitpack
from .ops import rdm as rdm_ops
from .ops.davidson import (
    davidson_ground_state,
    davidson_ground_state_segmented,
    davidson_initial_guess,
    davidson_initial_guess_k,
    davidson_lowest_k,
)
from .ops.dense_df import dense_df_matvec_flat, densify
from .ops.hamiltonian import (
    SCIBasis,
    build_sci_basis,
    build_sci_hamiltonian,
    expectation_value,
    sci_matvec_flat,
)
from .ops.table_cache import TableCache
from .subsampling import postselect_by_hamming_right_and_left, subsample
from .utils.checkpoint import LoopCheckpoint, load_loop_state, save_loop_state
from .utils.device import checked_device
from .utils.tracing import span

__all__ = [
    "SCIResult",
    "SCIState",
    "bitstring_matrix_to_ci_strs",
    "diagonalize_fermionic_hamiltonian",
    "enlarge_batch_from_transitions",
    "optimize_orbitals",
    "rotate_integrals",
    "solve_fermion",
    "solve_sci",
    "solve_sci_batch",
    "solve_sci_excited",
]


@dataclass(frozen=True)
class SCIState:
    """The amplitudes and determinants describing a quantum state.

    ``device`` is where :meth:`rdm`, :meth:`spin_square` and
    :meth:`orbital_occupancies` compute.
    """

    amplitudes: np.ndarray
    """``M x N`` amplitude matrix over (``ci_strs_a`` x ``ci_strs_b``)."""

    ci_strs_a: np.ndarray
    """The alpha determinants (integer CI strings, ascending)."""

    ci_strs_b: np.ndarray
    """The beta determinants."""

    norb: int
    """The number of spatial orbitals."""

    nelec: tuple[int, int]
    """The numbers of alpha and beta electrons."""

    device: torch.device = field(default="cuda", kw_only=True)
    """The device the RDM and spin queries run on."""

    def __post_init__(self):
        object.__setattr__(self, "amplitudes", np.asarray(self.amplitudes))
        if self.amplitudes.shape != (len(self.ci_strs_a), len(self.ci_strs_b)):
            raise ValueError(
                f"'amplitudes' shape must be ({len(self.ci_strs_a)}, {len(self.ci_strs_b)}) "
                f"but got {self.amplitudes.shape}"
            )
        object.__setattr__(self, "device", checked_device(self.device))

    def save(self, filename):
        """Save the state to an ``.npz`` file in ``sqd_tpu``'s layout.

        Below 63 orbitals the CI strings are int64 arrays ``ci_strs_a`` /
        ``ci_strs_b``; from 63 up (object-int strings) they are stored as
        packed uint32 words under ``ci_strs_*_packed``.
        """
        if np.asarray(self.ci_strs_a).dtype == object or np.asarray(self.ci_strs_b).dtype == object:
            pa, pb = self._packed()
            np.savez(filename, amplitudes=self.amplitudes, ci_strs_a_packed=pa,
                     ci_strs_b_packed=pb, norb=self.norb, nelec=self.nelec)
        else:
            np.savez(filename, amplitudes=self.amplitudes, ci_strs_a=self.ci_strs_a,
                     ci_strs_b=self.ci_strs_b, norb=self.norb, nelec=self.nelec)

    @classmethod
    def load(cls, filename, *, device="cuda"):
        """Load a state saved by either package (either layout); ``device`` is
        where the loaded state's RDM and spin queries run."""
        with np.load(filename) as data:
            norb = int(data["norb"])
            if "ci_strs_a_packed" in data:
                strs_a = bitpack.unpack_to_ints(data["ci_strs_a_packed"], norb)
                strs_b = bitpack.unpack_to_ints(data["ci_strs_b_packed"], norb)
            else:
                strs_a, strs_b = data["ci_strs_a"], data["ci_strs_b"]
            return cls(data["amplitudes"], strs_a, strs_b, norb=norb,
                       nelec=tuple(int(x) for x in data["nelec"]), device=device)

    def _packed(self) -> tuple[np.ndarray, np.ndarray]:
        norb = int(self.norb)
        return (
            bitpack.pack_ints(np.asarray(self.ci_strs_a), norb),
            bitpack.pack_ints(np.asarray(self.ci_strs_b), norb),
        )

    def _basis(self) -> SCIBasis:
        """Gather-table-only basis view, built once and cached on the instance."""
        cached = self.__dict__.get("_basis_cache")
        if cached is None:
            pa, pb = self._packed()
            cached = build_sci_basis(pa, pb, int(self.norb), self.nelec, device=self.device)
            object.__setattr__(self, "_basis_cache", cached)
        return cached

    def _amplitudes(self) -> torch.Tensor:
        return torch.as_tensor(self.amplitudes, dtype=torch.float64, device=self.device)

    def rdm(self, rank: int = 1, spin_summed: bool = False):
        """Compute the rank-1 or rank-2 reduced density matrix."""
        basis = self._basis()
        c = self._amplitudes()
        if rank == 1:
            dm1a, dm1b = rdm_ops.rdm1s(basis, c)
            if spin_summed:
                return (dm1a + dm1b).cpu().numpy()
            return np.stack([dm1a.cpu().numpy(), dm1b.cpu().numpy()])
        if rank == 2:
            pa, pb = self._packed()
            if spin_summed:
                return rdm_ops.rdm2_spin_summed(basis, c, pa, pb).cpu().numpy()
            return tuple(x.cpu().numpy() for x in rdm_ops.rdm2s(basis, c, pa, pb))
        raise NotImplementedError(
            f"Computing the rank {rank} reduced density matrix is currently not supported."
        )

    def spin_square(self) -> float:
        """Expectation value of total spin squared."""
        return float(self._basis().spin_square(self._amplitudes()))

    def orbital_occupancies(self) -> tuple[np.ndarray, np.ndarray]:
        """Average orbital occupancies (diagonals of the spin-resolved 1-RDMs)."""
        dm = self.rdm(rank=1, spin_summed=False)
        return np.diagonal(dm[0]).copy(), np.diagonal(dm[1]).copy()


@dataclass(frozen=True)
class SCIResult:
    """Result of an SCI calculation."""

    energy: float
    """The SCI energy."""

    sci_state: SCIState
    """The SCI state."""

    orbital_occupancies: tuple[np.ndarray, np.ndarray]
    """The average orbital occupancies."""

    rdm1: np.ndarray | None = None
    """Spin-summed 1-particle reduced density matrix."""

    rdm2: np.ndarray | None = None
    """Spin-summed 2-particle reduced density matrix."""


def _strings_to_packed(strs, norb: int) -> np.ndarray:
    arr = np.asarray(strs, dtype=object if norb >= 63 else np.int64)
    return bitpack.pack_ints(arr, norb)


def _popcounts(strs: np.ndarray) -> np.ndarray:
    """Vectorized per-string popcount (native kernel for machine ints)."""
    if strs.dtype == object or (strs.size and int(strs.min()) < 0):
        return np.fromiter(
            (abs(int(s)).bit_count() for s in strs), dtype=np.int64, count=len(strs)
        )
    return native.popcount_rows(bitpack.pack_ints(strs, 64))


def _check_ci_strs(ci_strs) -> tuple[np.ndarray, np.ndarray]:
    """Validate uniform Hamming weight per spin; return sorted unique arrays."""
    out = []
    for label, strs in zip(("up", "down"), ci_strs):
        strs = np.asarray(strs)
        counts = _popcounts(strs)
        ham0 = int(counts[0])
        bad = np.nonzero(counts != ham0)[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"Spin-{label} CI string in index 0 has hamming weight {ham0}, but CI "
                f"string in index {i} has hamming weight {int(counts[i])}."
            )
        out.append(np.sort(np.unique(strs)))
    return out[0], out[1]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def solve_sci(
    ci_strings: tuple[np.ndarray, np.ndarray],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    device="cuda",
    spin_sq: float | None = None,
    shift: float = 0.1,
    solver_dtype=None,
    tol: float = 1e-6,
    max_subspace: int = 24,
    max_cycle: int = 200,
    pad_bucket: int = 32,
    refine_iterations: int | None = None,
    table_cache=None,
    with_rdms: bool = True,
    matvec_strategy: str = "gather",
    eri_factor: np.ndarray | str | None = "auto",
    **kwargs,
) -> SCIResult:
    """Diagonalize the Hamiltonian in the subspace spanned by the CI strings.

    The arguments are those of ``sqd_tpu.fermion.solve_sci`` plus ``device``
    (``"cuda"``, the default, ``"cpu"`` or a ``torch.device``; a CUDA device
    must exist).

    Args:
        ci_strings: pair (strings_a, strings_b) of integer CI-string arrays
            whose Cartesian product spans the subspace.
        one_body_tensor / two_body_tensor: Hamiltonian integrals (chemist).
        norb: number of spatial orbitals.
        nelec: (n_alpha, n_beta).
        device: where the operator, solver and RDMs run.
        spin_sq: optional target S^2, imposed as the penalty
            ``H + shift * (S^2 - spin_sq)``; the returned energy is always
            that of the bare Hamiltonian.
        shift: penalty strength.
        solver_dtype: dtype of the Davidson iterations (``torch.float32`` or
            ``torch.float64``).  ``None`` picks f64 up to 200k determinants and
            f32 above.
        tol: Davidson residual tolerance (scaled by the hdiag magnitude).
        max_subspace / max_cycle: Krylov buffer rows / matvec budget.
        pad_bucket: if > 0, round each spin dimension up to this multiple.
        refine_iterations: f64 Davidson iterations warm-started from an f32
            solution; ``None`` resolves to 6 for f32 solves and 0 for f64.
            A refinement that has not converged by then goes on from its
            Ritz vector for up to ``max_cycle`` more iterations (``sqd_tpu``
            stops): an f32 stage stopped at an excited state is refined down
            to the ground state.
        with_rdms: attach the spin-summed 2-RDM (``rdm1`` and occupancies are
            always computed).
        matvec_strategy: ``"gather"`` (default) iterates with the gather-table
            matvec (in f32 through the cross-spin kernel); ``"dense_df"``
            iterates with the dense density-fitted operator
            (:mod:`sqd_tpu_torch.ops.dense_df`: batched matrix products, no
            gathers; needs a PSD ERI factor and no spin penalty) through
            :func:`~sqd_tpu_torch.ops.davidson.davidson_ground_state_segmented`
            with its 25-iteration segments, as ``sqd_tpu`` does.  The f64
            refinement, the energy and the RDMs come from the exact operator
            either way: on the card its f64 cross-spin kernel, which
            contracts only the in-subspace excitations; on the CPU a dense
            f64 matvec over all ``norb**2`` pairs, so consider
            ``refine_iterations=0`` there at very large ``norb``.
        table_cache: an :class:`~sqd_tpu_torch.ops.table_cache.TableCache`
            reused across solves on the same integrals (same tables, less
            host work).
        eri_factor: forwarded to :func:`build_sci_hamiltonian`: ``"auto"``
            attaches a pivoted-Cholesky factor when ``norb**2 > 256`` and
            the integrals are PSD at rank ``<= norb**2 // 3``; an explicit
            ``(X, norb**2)`` array is attached as given; ``None`` attaches
            none.  Only f32 contractions outside the CUDA kernel use it; the
            Davidson's f32 matvec on the card goes through the kernel and
            the exact integrals, and f64 always uses them.
        **kwargs: ignored extras for signature compatibility.

    Returns:
        An :class:`SCIResult` with f64 energy, state, occupancies and RDMs.
    """
    with span("solve"):
        device = checked_device(device)
        strs_a, strs_b = _check_ci_strs(ci_strings)
        norb = int(one_body_tensor.shape[0])
        pa = _strings_to_packed(strs_a, norb)
        pb = _strings_to_packed(strs_b, norb)
        m, n = len(strs_a), len(strs_b)
        if solver_dtype is None:
            solver_dtype = torch.float64 if m * n <= 200_000 else torch.float32
        if refine_iterations is None:
            refine_iterations = 0 if solver_dtype == torch.float64 else 6
        pad_to = None
        if pad_bucket:
            pad_to = (_round_up(m, pad_bucket), _round_up(n, pad_bucket))

        ham64 = build_sci_hamiltonian(
            pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
            device=device,
            spin_shift=0.0 if spin_sq is None else float(shift),
            spin_target=0.0 if spin_sq is None else float(spin_sq),
            dtype=torch.float64,
            pad_to=pad_to,
            table_cache=table_cache,
            eri_factor=eri_factor,
        )
        ham = ham64.astype(solver_dtype)
        hd_flat = ham.hdiag.reshape(-1)
        v0 = davidson_initial_guess(hd_flat, solver_dtype)
        tol_eff = _scaled_tol(hd_flat, tol)
        if matvec_strategy == "dense_df":
            if spin_sq is not None:
                raise ValueError(
                    "matvec_strategy='dense_df' does not support the fused spin "
                    "penalty (non-PSD mixed term); use spin_sq=None"
                )
            if ham64.eri_chol is None:
                raise ValueError(
                    "matvec_strategy='dense_df' requires a PSD ERI factor — "
                    "needs npair > 256 and symmetric PSD two_body_tensor "
                    "(see build_sci_hamiltonian(eri_factor=...))"
                )
            dense_op = densify(ham64, dtype=solver_dtype)
            # in segments, as sqd_tpu's route: each segment restarts from the Ritz
            # vector, which lets the f32 solve converge where the unsegmented one
            # stalls at its cap (bench_torch.py's config 5)
            with span("davidson.solver"):
                result = davidson_ground_state_segmented(
                    dense_df_matvec_flat, dense_op, hd_flat, v0,
                    tol=tol_eff, max_subspace=max_subspace, max_iterations=max_cycle,
                )
            del dense_op  # the W stacks: freed before the f64 tail
        elif matvec_strategy == "gather":
            with span("davidson.solver"):
                result = davidson_ground_state(
                    sci_matvec_flat, ham, hd_flat, v0,
                    tol=tol_eff, max_subspace=max_subspace, max_iterations=max_cycle,
                )
        else:
            raise ValueError(f"unknown matvec_strategy {matvec_strategy!r}")
        vec_flat = result.vector.to(torch.float64)
        if refine_iterations > 0 and solver_dtype != torch.float64:
            hd64 = ham64.hdiag.reshape(-1)
            with span("davidson.refine"):
                result64 = davidson_ground_state(
                    sci_matvec_flat, ham64, hd64, vec_flat,
                    tol=tol, max_subspace=max_subspace, max_iterations=refine_iterations,
                )
                if not result64.converged:
                    # the f32 stage can stop at an excited state, within its f32
                    # tolerance; the refinement then falls far below it and needs
                    # more than refine_iterations to reach the ground state
                    result64 = davidson_ground_state(
                        sci_matvec_flat, ham64, hd64, result64.vector,
                        tol=tol, max_subspace=max_subspace, max_iterations=max_cycle,
                    )
            vec_flat = result64.vector
        return _result_of(ham64, vec_flat, (strs_a, strs_b), (pa, pb), nelec, with_rdms)


def _scaled_tol(hd_flat: torch.Tensor, tol: float) -> float:
    """The residual tolerance scaled to the spectrum and the solver's dtype."""
    scale = float(torch.where(hd_flat.abs() > 1e20, 0.0, hd_flat).abs().max())
    eps = torch.finfo(hd_flat.dtype).eps
    return max(tol, 32 * eps * max(1.0, scale))


def _result_of(ham64, vec_flat, strs, packed, nelec, with_rdms=True, energy=None) -> SCIResult:
    """The :class:`SCIResult` of a padded solver vector: normalised in f64,
    its f64 RDMs and occupancies, and its bare-H energy (``energy`` when the
    caller computed it)."""
    mp, np_ = ham64.shape
    vec_pad = vec_flat.to(torch.float64).reshape(mp, np_)
    vec_pad = vec_pad / torch.linalg.norm(vec_pad)
    # f64 RDMs -> occupancies.  Padded rows/columns are exactly zero, so the
    # padded gather tables give the same RDMs as an unpadded rebuild would.
    rdms = rdm_ops.make_rdms(
        ham64, vec_pad, packed[0] if with_rdms else None, packed[1] if with_rdms else None,
        with_dm2=with_rdms,
    )
    with span("result"):
        dm1a, dm1b = rdms["dm1a"].cpu().numpy(), rdms["dm1b"].cpu().numpy()
        dm2 = rdms["dm2"].cpu().numpy() if with_rdms else None
        occupancies = (np.diagonal(dm1a).copy(), np.diagonal(dm1b).copy())
        if energy is None:
            energy = expectation_value(ham64, vec_pad.reshape(-1), spin_penalty=False)
        m, n = len(strs[0]), len(strs[1])
        sci_state = SCIState(
            amplitudes=vec_pad[:m, :n].cpu().numpy(),
            ci_strs_a=strs[0],
            ci_strs_b=strs[1],
            norb=ham64.norb,
            nelec=tuple(int(x) for x in nelec),
            device=vec_pad.device,
        )
    return SCIResult(
        energy, sci_state, orbital_occupancies=occupancies, rdm1=dm1a + dm1b, rdm2=dm2
    )


def solve_sci_excited(
    ci_strings: tuple[np.ndarray, np.ndarray],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    k: int,
    device="cuda",
    spin_sq: float | None = None,
    shift: float = 0.1,
    solver_dtype=torch.float64,
    tol: float = 1e-7,
    max_subspace: int = 32,
    max_cycle: int = 400,
    pad_bucket: int = 32,
) -> list[SCIResult]:
    """The k lowest eigenstates of the projected Hamiltonian (block Davidson).

    ``sqd_tpu.fermion.solve_sci_excited`` plus ``device``: the start block of
    :func:`~sqd_tpu_torch.ops.davidson.davidson_initial_guess_k`, then
    :func:`~sqd_tpu_torch.ops.davidson.davidson_lowest_k` with
    ``max_subspace`` raised to at least ``2k + 6``.  Returns ``k``
    :class:`SCIResult`\\ s in ascending energy order, each with its own bare-H
    f64 energy, occupancies and RDMs.
    """
    device = checked_device(device)
    strs_a, strs_b = _check_ci_strs(ci_strings)
    norb = int(one_body_tensor.shape[0])
    pa = _strings_to_packed(strs_a, norb)
    pb = _strings_to_packed(strs_b, norb)
    m, n = len(strs_a), len(strs_b)
    pad_to = None
    if pad_bucket:
        pad_to = (_round_up(m, pad_bucket), _round_up(n, pad_bucket))
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
        device=device,
        spin_shift=0.0 if spin_sq is None else float(shift),
        spin_target=0.0 if spin_sq is None else float(spin_sq),
        dtype=torch.float64,
        pad_to=pad_to,
    )
    ham = ham64.astype(solver_dtype)
    hd_flat = ham.hdiag.reshape(-1)
    res = davidson_lowest_k(
        sci_matvec_flat, ham, hd_flat, davidson_initial_guess_k(hd_flat, k, solver_dtype),
        k=k, tol=_scaled_tol(hd_flat, tol), max_subspace=max(max_subspace, 2 * k + 6),
        max_iterations=max_cycle,
    )
    return [_result_of(ham64, res.vectors[i], (strs_a, strs_b), (pa, pb), nelec)
            for i in range(k)]


# ---------------------------------------------------------------------------
# string utilities of the loop
# ---------------------------------------------------------------------------


def _hamming_of_first(strs) -> int:
    return bin(int(strs[0])).count("1")


def bitstring_matrix_to_ci_strs(
    bitstring_matrix: np.ndarray, open_shell: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Split bitstring rows into (spin-up, spin-down) integer determinants.

    The left half of each row is the spin-down (beta) configuration, the right
    half spin-up (alpha); with ``open_shell=False`` both halves are merged into
    one shared sorted set.
    """
    norb = bitstring_matrix.shape[1] // 2
    strs_left = np.unique(bitstring_matrix_to_integers(bitstring_matrix[:, :norb]))
    strs_right = np.unique(bitstring_matrix_to_integers(bitstring_matrix[:, norb:]))
    if not open_shell:
        strs_left = strs_right = np.union1d(strs_left, strs_right)
    return strs_right, strs_left


def _unique_with_order_preserved(vals: np.ndarray) -> np.ndarray:
    """Unique values keeping first-occurrence order."""
    _, indices = np.unique(vals, return_index=True)
    indices.sort()
    return vals[indices]


# ---------------------------------------------------------------------------
# batch solves and the SQD loop
# ---------------------------------------------------------------------------


def solve_sci_batch(
    ci_strings: list[tuple[np.ndarray, np.ndarray]],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    spin_sq: float | None = None,
    device="cuda",
    **kwargs,
) -> list[SCIResult]:
    """Diagonalize the Hamiltonian in each subspace of a list, one after another
    on ``device``; ``kwargs`` go to :func:`solve_sci`."""
    return [
        solve_sci(
            ci_strs, one_body_tensor, two_body_tensor, norb=norb, nelec=nelec,
            spin_sq=spin_sq, device=device, **kwargs,
        )
        for ci_strs in ci_strings
    ]


def solve_fermion(
    bitstring_matrix: tuple[np.ndarray, np.ndarray] | np.ndarray,
    /,
    hcore: np.ndarray,
    eri: np.ndarray,
    *,
    open_shell: bool = False,
    spin_sq: float | None = None,
    shift: float = 0.1,
    device="cuda",
    **kwargs,
) -> tuple[float, SCIState, tuple[np.ndarray, np.ndarray], float]:
    """Approximate the ground state in the subspace defined by sampled configurations.

    Args:
        bitstring_matrix: either a 2D bool bitstring matrix (rows
            ``[b_N..b_0, a_N..a_0]``) or a pair of integer CI-string arrays.
        hcore: one-electron integrals.
        eri: two-electron integrals (chemist convention).
        open_shell: keep the two halves' configurations separate if True;
            otherwise use their union for both spins.
        spin_sq: optional target S^2 (penalty method).
        shift: penalty level shift.
        device: where the solve runs.
        **kwargs: solver options forwarded to :func:`solve_sci`.

    Returns:
        (energy, SCIState, (occ_a, occ_b), spin_squared)
    """
    if isinstance(bitstring_matrix, tuple):
        ci_strs = bitstring_matrix
    else:
        ci_strs = bitstring_matrix_to_ci_strs(bitstring_matrix, open_shell=open_shell)
    ci_strs = _check_ci_strs(ci_strs)
    num_up = _hamming_of_first(ci_strs[0])
    num_dn = _hamming_of_first(ci_strs[1])
    result = solve_sci(
        ci_strs, hcore, eri, norb=hcore.shape[0], nelec=(num_up, num_dn),
        spin_sq=spin_sq, shift=shift, device=device, **kwargs,
    )
    spin_squared = result.sci_state.spin_square()
    return result.energy, result.sci_state, result.orbital_occupancies, spin_squared


def diagonalize_fermionic_hamiltonian(
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    bit_array,
    samples_per_batch: int,
    norb: int,
    nelec: tuple[int, int],
    *,
    num_batches: int = 1,
    energy_tol: float = 1e-8,
    occupancies_tol: float = 1e-5,
    max_iterations: int = 100,
    sci_solver: Callable[..., list[SCIResult]] | None = None,
    symmetrize_spin: bool = False,
    max_dim: int | tuple[int, int] | None = None,
    include_configurations=None,
    initial_occupancies: tuple[np.ndarray, np.ndarray] | None = None,
    carryover_threshold: float = 1e-4,
    callback: Callable[[list[SCIResult]], None] | None = None,
    seed: int | np.random.Generator | None = None,
    solver_options: dict | None = None,
    checkpoint_path=None,
    resume: bool = True,
    device="cuda",
) -> SCIResult:
    """Run sample-based quantum diagonalization (SQD) to convergence.

    ``sqd_tpu.fermion.diagonalize_fermionic_hamiltonian`` with one more
    argument, ``device``.  Each iteration postselects (iteration 0) or
    repairs on ``device`` (later iterations) the raw samples, subsamples
    ``num_batches`` batches, assembles each batch's CI strings (requested
    configurations first, then carryover, then samples in descending count
    order; order-preserving dedup; ``max_dim`` truncation; ascending sort),
    diagonalizes every batch through ``sci_solver``, keeps the best
    (lowest-energy) batch, and stops when both the energy and the occupancies
    have converged.  CI strings whose amplitude exceeds
    ``carryover_threshold`` are carried into the next iteration's subspace.
    All host randomness comes from one NumPy generator, drawn in
    ``sqd_tpu``'s order, so iteration 0 gives ``sqd_tpu``'s strings exactly.

    Args:
        one_body_tensor / two_body_tensor: Hamiltonian integrals.
        bit_array: sampled bitstrings (a :class:`sqd_tpu_torch.primitives.BitArray`
            or anything with its ``array``/``num_bits``/``num_shots``),
            layout ``[b_N..b_0, a_N..a_0]``.
        samples_per_batch: bitstrings per subsampled batch.
        norb: number of spatial orbitals.
        nelec: (n_alpha, n_beta).
        num_batches: batches per recovery iteration.
        energy_tol / occupancies_tol: joint convergence thresholds.
        max_iterations: recovery-iteration limit.
        sci_solver: batch solver ``(ci_strings, h1, h2, norb, nelec) ->
            list[SCIResult]``; defaults to :func:`solve_sci_batch` on
            ``device`` with a fresh :class:`TableCache`.
        symmetrize_spin: merge alpha/beta string sets each iteration
            (requires ``n_alpha == n_beta``).
        max_dim: per-spin subspace dimension cap (int or (a, b) pair).
        include_configurations: configurations always included, either one
            list for both spins or an (alpha, beta) pair.
        initial_occupancies: optional initial occupancy guess (skips the
            iteration-0 postselection path).
        carryover_threshold: amplitude threshold for string carryover.
        callback: called with the full batch-result list each iteration.
        seed: NumPy seed or generator.
        solver_options: extra kwargs of the default solver (ignored if
            ``sci_solver`` is given).
        checkpoint_path: if given, the whole loop state (iteration counter,
            NumPy generator state, occupancies, carryover strings, best
            result) is saved there after every iteration
            (:mod:`sqd_tpu_torch.utils.checkpoint`; ``sqd_tpu``'s layout).
        resume: when ``checkpoint_path`` exists and ``resume`` is true, the
            loop continues from the saved state: every random number of the
            loop comes from the one NumPy generator (recovery seeds its
            ``torch.Generator`` from it), so the continuation is the
            uninterrupted run's.
        device: where configuration recovery and the default solver run.

    Returns:
        The best (lowest-energy) :class:`SCIResult` seen.

    Raises:
        ValueError: invalid iteration count / spin-symmetrization setup, or
            no valid bitstrings and no ``initial_occupancies``.
    """
    if max_iterations < 1:
        raise ValueError("Maximum number of iterations must be at least 1.")

    n_alpha, n_beta = nelec
    if symmetrize_spin and n_alpha != n_beta:
        raise ValueError(
            "Spin symmetrization is only possible if the numbers of alpha and beta "
            f"electrons are equal. Instead, got {n_alpha} and {n_beta}."
        )

    if max_dim is None:
        max_dim_a = max_dim_b = None
    elif isinstance(max_dim, tuple):
        max_dim_a, max_dim_b = max_dim
    else:
        max_dim_a = max_dim_b = max_dim
    if symmetrize_spin and max_dim_a != max_dim_b:
        raise ValueError(
            "When requesting spin symmetrization, the maximum dimension must be "
            "the same for both spin alpha and spin beta. "
            f"Instead, got {max_dim_a} and {max_dim_b}"
        )
    device = checked_device(device)

    if include_configurations is None:
        include_a = np.array([], dtype=np.int64)
        include_b = np.array([], dtype=np.int64)
    elif isinstance(include_configurations, tuple):
        include_a, include_b = include_configurations
    else:
        include_a = include_b = include_configurations
    include_a = np.unique(np.asarray(include_a))
    include_b = np.unique(np.asarray(include_b))

    rng = np.random.default_rng(seed)
    current_occupancies = initial_occupancies
    best_result: SCIResult | None = None
    current_energy: float | None = None
    if sci_solver is None:
        opts = dict(solver_options or {})
        if "table_cache" not in opts:
            # reuse the set-independent per-string table halves across
            # iterations (string sets overlap heavily through carryover)
            opts["table_cache"] = TableCache()

        def sci_solver(cs, h1, h2, no, ne):
            return solve_sci_batch(cs, h1, h2, no, ne, device=device, **opts)

    str_dtype = object if norb >= 63 else np.int64
    carryover_strings_a = np.array([], dtype=str_dtype)
    carryover_strings_b = np.array([], dtype=str_dtype)
    start_iteration = 0

    if checkpoint_path is not None and resume and os.path.exists(checkpoint_path):
        ckpt = load_loop_state(checkpoint_path)
        start_iteration = ckpt.iteration + 1
        rng.bit_generator.state = ckpt.rng_state
        current_occupancies = ckpt.current_occupancies
        carryover_strings_a = ckpt.carryover_strings_a
        carryover_strings_b = ckpt.carryover_strings_b
        current_energy = ckpt.current_energy
        blob = ckpt.best_state_blob
        state = SCIState(
            amplitudes=blob["amplitudes"],
            ci_strs_a=bitpack.unpack_to_ints(blob["strs_a_packed"], norb),
            ci_strs_b=bitpack.unpack_to_ints(blob["strs_b_packed"], norb),
            norb=norb,
            nelec=tuple(int(x) for x in nelec),
            device=device,
        )
        # reattach the RDMs an uninterrupted run carries on its best result
        # (orbital optimization reads them); a one-time cost at resume
        best_result = SCIResult(
            ckpt.best_energy,
            state,
            orbital_occupancies=ckpt.best_occupancies,
            rdm1=state.rdm(rank=1, spin_summed=True),
            rdm2=state.rdm(rank=2, spin_summed=True),
        )

    raw_bitstrings, raw_probs = bit_array_to_arrays(bit_array)

    for iteration in range(start_iteration, max_iterations):
        with span("loop.iteration"):
            if current_occupancies is None:
                with span("samples.postselect"):
                    bitstrings, probs = postselect_by_hamming_right_and_left(
                        raw_bitstrings, raw_probs, hamming_right=n_alpha, hamming_left=n_beta
                    )
                if not bitstrings.size:
                    raise ValueError(
                        "The input bit array did not contain any valid bitstrings. "
                        "Either pass a bit array that contains at least one valid bitstring "
                        "(with the correct right and left Hamming weights), or specify a "
                        "value for initial_occupancies."
                    )
            else:
                with span("samples.recover"):
                    bitstrings, probs = recover_configurations(
                        raw_bitstrings, raw_probs, current_occupancies, n_alpha, n_beta,
                        rand_seed=rng, device=device,
                    )

            with span("samples.subsample"):
                subsamples = subsample(
                    bitstrings, probs, samples_per_batch=samples_per_batch,
                    num_batches=num_batches, rand_seed=rng,
                )

            with span("loop.strings"):
                ci_strings = []
                for samples in subsamples:
                    samples_a, counts_a = np.unique(
                        bitstring_matrix_to_integers(samples[:, norb:]), return_counts=True
                    )
                    samples_b, counts_b = np.unique(
                        bitstring_matrix_to_integers(samples[:, :norb]), return_counts=True
                    )
                    if symmetrize_spin:
                        merged = np.concatenate((samples_a, samples_b))
                        counts = np.concatenate((counts_a, counts_b))
                        merged = merged[np.argsort(counts)[::-1]]
                        strs = np.concatenate((include_a, include_b, carryover_strings_a, merged))
                        strs_a = strs_b = _unique_with_order_preserved(strs)[:max_dim_a]
                    else:
                        samples_a = samples_a[np.argsort(counts_a)[::-1]]
                        samples_b = samples_b[np.argsort(counts_b)[::-1]]
                        strs_a = np.concatenate((include_a, carryover_strings_a, samples_a))
                        strs_b = np.concatenate((include_b, carryover_strings_b, samples_b))
                        strs_a = _unique_with_order_preserved(strs_a)[:max_dim_a]
                        strs_b = _unique_with_order_preserved(strs_b)[:max_dim_b]
                    ci_strings.append((np.sort(strs_a), np.sort(strs_b)))

            results = sci_solver(ci_strings, one_body_tensor, two_body_tensor, norb, nelec)

            if callback is not None:
                with span("loop.callback"):
                    callback(results)

            best_result_in_batch = min(results, key=lambda result: result.energy)
            if best_result is None or best_result_in_batch.energy < best_result.energy:
                best_result = best_result_in_batch

            if (
                current_energy is not None
                and abs(current_energy - best_result_in_batch.energy) < energy_tol
                and np.linalg.norm(
                    np.ravel(current_occupancies)
                    - np.ravel(best_result_in_batch.orbital_occupancies),
                    ord=np.inf,
                )
                < occupancies_tol
            ):
                break
            current_result = best_result_in_batch
            current_energy = current_result.energy
            current_occupancies = current_result.orbital_occupancies

            # carry over CI strings attached to large-amplitude configurations
            sci_state = current_result.sci_state
            absolute_vals = np.abs(sci_state.amplitudes.reshape(-1))
            order = np.argsort(absolute_vals)
            cut = np.searchsorted(absolute_vals, carryover_threshold, sorter=order)
            kept = order[cut:]
            _, n_strings_b = sci_state.amplitudes.shape
            alpha_indices, beta_indices = np.divmod(kept, n_strings_b)
            alpha_indices = np.unique(alpha_indices)
            beta_indices = np.unique(beta_indices)
            carryover_strings_a = sci_state.ci_strs_a[alpha_indices]
            carryover_strings_b = sci_state.ci_strs_b[beta_indices]
            weights_a = np.sum(np.abs(sci_state.amplitudes[alpha_indices]) ** 2, axis=1)
            weights_b = np.sum(np.abs(sci_state.amplitudes[:, beta_indices]) ** 2, axis=0)
            if symmetrize_spin:
                merged = np.concatenate((carryover_strings_a, carryover_strings_b))
                weights = np.concatenate((weights_a, weights_b))
                merged = merged[np.argsort(weights)[::-1]]
                carryover_strings_a = carryover_strings_b = _unique_with_order_preserved(merged)
            else:
                carryover_strings_a = carryover_strings_a[np.argsort(weights_a)[::-1]]
                carryover_strings_b = carryover_strings_b[np.argsort(weights_b)[::-1]]

            if checkpoint_path is not None:
                best_state = best_result.sci_state
                pa, pb = best_state._packed()
                save_loop_state(
                    checkpoint_path,
                    LoopCheckpoint(
                        iteration=iteration,
                        rng_state=rng.bit_generator.state,
                        current_occupancies=current_occupancies,
                        carryover_strings_a=carryover_strings_a,
                        carryover_strings_b=carryover_strings_b,
                        best_energy=best_result.energy,
                        best_state_blob={"amplitudes": np.asarray(best_state.amplitudes),
                                         "strs_a_packed": pa, "strs_b_packed": pb},
                        best_occupancies=best_result.orbital_occupancies,
                        current_energy=current_energy,
                        norb=norb,
                    ),
                )

    return cast(SCIResult, best_result)


# ---------------------------------------------------------------------------
# orbital optimization
# ---------------------------------------------------------------------------

EXPM_TAYLOR_DEGREE = 18  # truncation below 1/19! ~ 8e-18 once the scaled 1-norm is <= 1
EXPM_SQUARINGS = 8  # squarings one SGD step holds: generators up to 1-norm 2**8


def _check_k_flat(k_flat, norb: int) -> None:
    num_params = (norb**2 - norb) // 2
    if len(k_flat) != num_params:
        raise ValueError(
            f"k_flat must specify the upper triangle of the transform matrix. "
            f"k_flat length is {len(k_flat)}. Expected {num_params}."
        )


def _antisymmetric_matrix_from_upper_tri(k_flat: torch.Tensor, k_dim: int) -> torch.Tensor:
    """Anti-symmetric matrix from its flattened strict upper triangle."""
    rows, cols = torch.triu_indices(k_dim, k_dim, offset=1, device=k_flat.device)
    k = k_flat.new_zeros(k_dim * k_dim).scatter(0, rows * k_dim + cols, k_flat)
    k = k.reshape(k_dim, k_dim)
    return k - k.T


def _rotate_eri(eri: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sum_pqrs eri[p,q,r,s] u[p,i] u[q,j] u[r,k] u[s,l]`` as four
    single-index contractions, O(n^5): each turns the leading index into a
    trailing one."""
    n = u.shape[0]
    for _ in range(4):
        eri = (eri.reshape(n, -1).T @ u).reshape(n, n, n, n)
    return eri


def _rotate(hcore: torch.Tensor, eri: torch.Tensor, k_flat: torch.Tensor):
    u = torch.linalg.matrix_exp(_antisymmetric_matrix_from_upper_tri(k_flat, hcore.shape[0]))
    return u.T @ hcore @ u, _rotate_eri(eri.contiguous(), u)


def rotate_integrals(
    hcore: np.ndarray, eri: np.ndarray, k_flat: np.ndarray, *, device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Similarity-transform the integrals by ``U = expm(K(k_flat))`` in f64 on
    ``device``: ``h' = U^T h U`` and each of the four ``eri`` indices rotated
    by ``U``.  ``eri`` is in whatever index convention the caller uses
    downstream (the transform is basis-covariant)."""
    _check_k_flat(k_flat, hcore.shape[0])
    device = checked_device(device)
    h_rot, eri_rot = _rotate(
        *(torch.tensor(np.asarray(x), dtype=torch.float64, device=device)
          for x in (hcore, eri, k_flat))
    )
    return h_rot.cpu().numpy(), eri_rot.cpu().numpy()


def _expm(a: torch.Tensor, squarings: int):
    """``(exp(a), s)``: scaling by ``2**-s`` and squaring of a Taylor
    polynomial, with no read-back to the host (``torch.linalg.matrix_exp``
    reads the norm back to pick its degree, which a CUDA graph cannot hold).
    ``s = ceil(log2 |a|_1)`` is clamped to ``squarings`` for the arithmetic;
    the unclamped ``s`` comes back so the caller can tell when the clamp bit."""
    with torch.no_grad():
        s = torch.clamp(torch.ceil(torch.log2(torch.linalg.matrix_norm(a, ord=1))), min=0)
    s_used = torch.clamp(s, max=squarings)
    x = a * torch.exp2(-s_used)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    p = eye
    for j in range(EXPM_TAYLOR_DEGREE, 0, -1):  # Horner: I + x (I + x/2 (I + ...))
        p = torch.addmm(eye, x, p, alpha=1.0 / j)
    for i in range(squarings):
        p = torch.where(s_used > i, p @ p, p)
    return p, s


def _rotated_energy(dm1, dm2, hcore, eri, k_flat, squarings=EXPM_SQUARINGS):
    """Energy of fixed RDMs under rotated integrals (the autograd target),
    and the squaring count its exponential asked for (see :func:`_expm`)."""
    u, s = _expm(_antisymmetric_matrix_from_upper_tri(k_flat, hcore.shape[0]), squarings)
    h_rot = u.T @ hcore @ u
    eri_rot = _rotate_eri(eri, u)
    return torch.sum(dm1 * h_rot) + 0.5 * torch.sum(dm2 * eri_rot), s


def _sgd_step(dm1, dm2, hcore, eri, k, vel, s_max, learning_rate, momentum, squarings):
    """One SGD-with-momentum step, in place on ``k`` and ``vel``; ``s_max``
    keeps the largest squaring count a generator asked for."""
    k_leaf = k.detach().requires_grad_(True)
    energy, s = _rotated_energy(dm1, dm2, hcore, eri, k_leaf, squarings)
    (grad,) = torch.autograd.grad(energy, k_leaf)
    vel.copy_(learning_rate * grad + momentum * vel)
    k.sub_(vel)
    torch.maximum(s_max, s, out=s_max)


def _sgd_eager(dm1, dm2, hcore, eri, k_flat, learning_rate, momentum, num_steps, squarings):
    """``num_steps`` steps launched one op at a time; returns ``(k, s_max)``."""
    k, vel = k_flat.clone(), torch.zeros_like(k_flat)
    s_max = k_flat.new_zeros(())
    for _ in range(num_steps):
        _sgd_step(dm1, dm2, hcore, eri, k, vel, s_max, learning_rate, momentum, squarings)
    return k, int(s_max)


def _sgd_graph(dm1, dm2, hcore, eri, k_flat, learning_rate, momentum, num_steps, squarings):
    """The same steps on the card, one step captured in a CUDA graph and
    replayed ``num_steps`` times (a step is ~200 kernels on 16 x 16
    matrices: launched one by one, their host overhead is the step's time)."""
    k, vel = k_flat.clone(), torch.zeros_like(k_flat)
    s_max = k_flat.new_zeros(())

    def step():
        _sgd_step(dm1, dm2, hcore, eri, k, vel, s_max, learning_rate, momentum, squarings)

    # warm up on a side stream (library handles and workspaces are made
    # outside the capture), then reset the state the warm-up advanced
    main, side = torch.cuda.current_stream(k.device), torch.cuda.Stream(k.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    main.wait_stream(side)
    k.copy_(k_flat)
    vel.zero_()
    s_max.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(num_steps):
        graph.replay()
    return k, int(s_max)


def _sgd_momentum_orbital_step(dm1, dm2, hcore, eri, k_flat, learning_rate, momentum,
                               num_steps: int) -> torch.Tensor:
    """``num_steps`` of SGD with momentum on the rotation parameters, on
    ``k_flat``'s device: a replayed CUDA graph on the card, eager on the CPU.
    Where a generator outgrew the squarings the step holds, the steps run
    again with more, so the result is that of an unclamped ``expm``."""
    run = _sgd_graph if k_flat.device.type == "cuda" else _sgd_eager
    squarings = EXPM_SQUARINGS
    while True:
        k, s_max = run(dm1, dm2, hcore, eri, k_flat, learning_rate, momentum, num_steps,
                       squarings)
        if s_max <= squarings:
            return k
        squarings = s_max


def optimize_orbitals(
    bitstring_matrix: tuple[np.ndarray, np.ndarray] | np.ndarray,
    /,
    hcore: np.ndarray,
    eri: np.ndarray,
    k_flat: np.ndarray,
    *,
    open_shell: bool = False,
    spin_sq: float = 0.0,
    num_iters: int = 10,
    num_steps_grad: int = 10_000,
    learning_rate: float = 0.01,
    momentum: float = 0.9,
    device="cuda",
    **kwargs,
) -> tuple[float, np.ndarray, tuple[np.ndarray, np.ndarray]]:
    """Optimize an orbital rotation to lower the SCI ground-state energy.

    ``sqd_tpu.fermion.optimize_orbitals`` plus ``device``: alternate (1)
    rotate the integrals by ``expm(K)``, (2) solve SCI in the fixed subspace
    with :func:`solve_sci`, (3) descend the RDM-contracted rotated-energy
    surface with ``num_steps_grad`` steps of SGD with momentum, the gradient
    by ``torch.autograd`` (on the card, each step a replayed CUDA graph).

    Args:
        bitstring_matrix: bitstring matrix or (strings_a, strings_b) pair.
        hcore / eri: integrals (chemist convention).
        k_flat: flattened strict upper triangle of the antisymmetric generator.
        open_shell: see :func:`bitstring_matrix_to_ci_strs`.
        spin_sq: target S^2 enforced via penalty during the solves.
        num_iters: outer alternation count.
        num_steps_grad: SGD steps per outer iteration.
        learning_rate: SGD learning rate.
        momentum: SGD momentum.
        device: where the rotations, solves and SGD steps run.
        **kwargs: solver options forwarded to :func:`solve_sci`.

    Returns:
        (energy from the last solve, optimized k_flat, (occ_a, occ_b)).
    """
    norb = hcore.shape[0]
    _check_k_flat(k_flat, norb)
    device = checked_device(device)
    if isinstance(bitstring_matrix, tuple):
        ci_strs = bitstring_matrix
    else:
        ci_strs = bitstring_matrix_to_ci_strs(bitstring_matrix, open_shell=open_shell)
    ci_strs = _check_ci_strs(ci_strs)
    nelec = (_hamming_of_first(ci_strs[0]), _hamming_of_first(ci_strs[1]))

    def on_device(x):
        return torch.tensor(np.asarray(x), dtype=torch.float64, device=device)

    k = on_device(k_flat)
    hcore_d = on_device(hcore)
    # physicist ordering for the rotation path, as sqd_tpu
    eri_phys = on_device(np.transpose(np.asarray(eri), (0, 2, 3, 1)))

    energy = 0.0
    avg_occupancy: tuple[np.ndarray, np.ndarray] = (np.zeros(norb), np.zeros(norb))
    for _ in range(num_iters):
        h_rot, eri_rot_phys = _rotate(hcore_d, eri_phys, k)
        eri_rot_chem = eri_rot_phys.permute(0, 3, 1, 2).contiguous()
        result = solve_sci(
            ci_strs, h_rot.cpu().numpy(), eri_rot_chem.cpu().numpy(),
            norb=norb, nelec=nelec, spin_sq=spin_sq, device=device, **kwargs,
        )
        energy = result.energy
        avg_occupancy = result.orbital_occupancies
        k = _sgd_momentum_orbital_step(
            on_device(result.rdm1), on_device(np.transpose(result.rdm2, (0, 2, 3, 1))),
            hcore_d, eri_phys, k, learning_rate, momentum, num_steps_grad,
        )
    return energy, k.cpu().numpy(), avg_occupancy


# ---------------------------------------------------------------------------
# excitation augmentation
# ---------------------------------------------------------------------------

# the largest (ops, samples, bits) bool block of one operator chunk; the
# legality test holds about four such blocks at once
EXCITATION_CHUNK_BYTES = 512 * 1024**2


def _transition_str_to_bool(string_rep: np.ndarray):
    """Parse transition-operator strings into (diag, create, annihilate) masks.

    Characters per mode: identity ``I``, creation ``+``, annihilation ``-``,
    number ``n``.
    """
    string_rep = np.asarray(string_rep)
    diag = np.logical_or(string_rep == "I", string_rep == "n")
    create = np.logical_or(string_rep == "+", string_rep == "n")
    annihilate = np.logical_or(string_rep == "-", string_rep == "n")
    return diag, create, annihilate


def apply_excitations(bitstring_matrix: torch.Tensor, diag: torch.Tensor,
                      create: torch.Tensor, annihilate: torch.Tensor):
    """Apply each transition operator to each bitstring, broadcast on the
    tensors' device.

    Returns (augmented rows, legality mask) of shapes
    ``(n_ops, n_samples, n_bits)`` / ``(n_ops, n_samples)``: a row is legal
    unless an operator creates on an occupied mode or annihilates an empty
    one.
    """
    bits = bitstring_matrix[None]  # (1, samples, bits)
    d, c, a = diag[:, None], create[:, None], annihilate[:, None]  # (ops, 1, bits)
    illegal = (bits & (c & ~d)) | (~bits & a)
    return bits == d, ~illegal.any(dim=-1)


def enlarge_batch_from_transitions(
    bitstring_matrix: np.ndarray, transition_operators: np.ndarray, *, device="cuda"
) -> np.ndarray:
    """Augment a configuration batch by applying transition operators.

    Every operator is applied to every sample on ``device``; illegal
    applications (creating on an occupied mode or annihilating an empty one)
    are dropped.  The rows come out operator-major, as ``sqd_tpu``'s; the
    operators go in chunks of at most ``EXCITATION_CHUNK_BYTES`` of rows.
    """
    device = checked_device(device)
    diag, create, annihilate = _transition_str_to_bool(transition_operators)
    if diag.ndim == 1:
        diag, create, annihilate = diag[None], create[None], annihilate[None]
    bits = torch.as_tensor(np.asarray(bitstring_matrix, dtype=bool), device=device)
    masks = [torch.as_tensor(x, device=device) for x in (diag, create, annihilate)]
    chunk = max(1, EXCITATION_CHUNK_BYTES // max(bits.numel(), 1))
    out = [np.zeros((0, bits.shape[1]), dtype=bool)]
    for o0 in range(0, len(diag), chunk):
        augmented, legal = apply_excitations(bits, *(x[o0:o0 + chunk] for x in masks))
        out.append(augmented[legal].cpu().numpy())
    return np.concatenate(out)
