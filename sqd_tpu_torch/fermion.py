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

Every entry point runs on the card (``device="cuda"``) unless the caller
passes another device; a CUDA request without a card raises.  Not ported yet
(ROADMAP.md), and raising ``NotImplementedError``: the loop's
``checkpoint_path``, ``SCIState.save``/``load``, :func:`solve_sci_excited`,
:func:`optimize_orbitals`, :func:`enlarge_batch_from_transitions` and the
dense density-fitted operator (``matvec_strategy="dense_df"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, cast

import numpy as np
import torch

from . import native
from .configuration_recovery import recover_configurations
from .counts import bit_array_to_arrays, bitstring_matrix_to_integers
from .ops import bitpack
from .ops import rdm as rdm_ops
from .ops.davidson import davidson_ground_state, davidson_initial_guess
from .ops.hamiltonian import (
    SCIBasis,
    build_sci_basis,
    build_sci_hamiltonian,
    expectation_value,
    sci_matvec_flat,
)
from .ops.table_cache import TableCache
from .subsampling import postselect_by_hamming_right_and_left, subsample
from .utils.device import checked_device

__all__ = [
    "SCIResult",
    "SCIState",
    "bitstring_matrix_to_ci_strs",
    "diagonalize_fermionic_hamiltonian",
    "enlarge_batch_from_transitions",
    "optimize_orbitals",
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
        raise NotImplementedError("SCIState.save is not ported yet; see ROADMAP.md")

    @classmethod
    def load(cls, filename):
        raise NotImplementedError("SCIState.load is not ported yet; see ROADMAP.md")

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
        with_rdms: attach the spin-summed 2-RDM (``rdm1`` and occupancies are
            always computed).
        matvec_strategy: only ``"gather"`` is ported; ``"dense_df"`` raises
            ``NotImplementedError``.
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
    device = checked_device(device)
    if matvec_strategy == "dense_df":
        raise NotImplementedError(
            "matvec_strategy='dense_df' is not ported yet; see ROADMAP.md"
        )
    if matvec_strategy != "gather":
        raise ValueError(f"unknown matvec_strategy {matvec_strategy!r}")
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
    mp, np_ = ham.shape
    hd_flat = ham.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd_flat, solver_dtype)
    # scale the residual tolerance to the spectrum and dtype
    scale = float(torch.where(hd_flat.abs() > 1e20, 0.0, hd_flat).abs().max())
    eps = torch.finfo(solver_dtype).eps
    tol_eff = max(tol, 32 * eps * max(1.0, scale))
    result = davidson_ground_state(
        sci_matvec_flat, ham, hd_flat, v0,
        tol=tol_eff, max_subspace=max_subspace, max_iterations=max_cycle,
    )
    vec_flat = result.vector.to(torch.float64)
    if refine_iterations > 0 and solver_dtype != torch.float64:
        result64 = davidson_ground_state(
            sci_matvec_flat, ham64, ham64.hdiag.reshape(-1), vec_flat,
            tol=tol, max_subspace=max_subspace, max_iterations=refine_iterations,
        )
        vec_flat = result64.vector
    vec_pad = vec_flat.reshape(mp, np_)
    vec_pad = vec_pad / torch.linalg.norm(vec_pad)

    # f64 RDMs -> occupancies.  Padded rows/columns are exactly zero, so the
    # padded gather tables give the same RDMs as an unpadded rebuild would.
    rdms = rdm_ops.make_rdms(
        ham64, vec_pad, pa if with_rdms else None, pb if with_rdms else None,
        with_dm2=with_rdms,
    )
    dm1a, dm1b = rdms["dm1a"].cpu().numpy(), rdms["dm1b"].cpu().numpy()
    dm2 = rdms["dm2"].cpu().numpy() if with_rdms else None
    occupancies = (np.diagonal(dm1a).copy(), np.diagonal(dm1b).copy())
    energy = expectation_value(ham64, vec_pad.reshape(-1), spin_penalty=False)
    sci_state = SCIState(
        amplitudes=vec_pad[:m, :n].cpu().numpy(),
        ci_strs_a=strs_a,
        ci_strs_b=strs_b,
        norb=norb,
        nelec=tuple(int(x) for x in nelec),
        device=device,
    )
    return SCIResult(
        energy, sci_state, orbital_occupancies=occupancies, rdm1=dm1a + dm1b, rdm2=dm2
    )


def solve_sci_excited(*args, **kwargs):
    """The k lowest eigenstates (``sqd_tpu.fermion.solve_sci_excited``): not ported yet."""
    raise NotImplementedError("solve_sci_excited is not ported yet; see ROADMAP.md")


def optimize_orbitals(*args, **kwargs):
    """Orbital optimization (``sqd_tpu.fermion.optimize_orbitals``): not ported yet."""
    raise NotImplementedError("optimize_orbitals is not ported yet; see ROADMAP.md")


def enlarge_batch_from_transitions(*args, **kwargs):
    """Excitation augmentation (``sqd_tpu.fermion.enlarge_batch_from_transitions``):
    not ported yet."""
    raise NotImplementedError("enlarge_batch_from_transitions is not ported yet; see ROADMAP.md")


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
        checkpoint_path / resume: not ported yet; a ``checkpoint_path``
            raises ``NotImplementedError``.
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
    if checkpoint_path is not None:
        raise NotImplementedError("checkpoint_path/resume is not ported yet; see ROADMAP.md")
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

    raw_bitstrings, raw_probs = bit_array_to_arrays(bit_array)

    for _ in range(max_iterations):
        if current_occupancies is None:
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
            bitstrings, probs = recover_configurations(
                raw_bitstrings, raw_probs, current_occupancies, n_alpha, n_beta,
                rand_seed=rng, device=device,
            )

        subsamples = subsample(
            bitstrings, probs, samples_per_batch=samples_per_batch,
            num_batches=num_batches, rand_seed=rng,
        )

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

    return cast(SCIResult, best_result)
