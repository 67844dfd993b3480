# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fermionic SCI: the fixed-subspace solve (port of ``sqd_tpu.fermion.solve_sci``).

The projected Hamiltonian is applied by :mod:`sqd_tpu_torch.ops.hamiltonian`
(the f32 opposite-spin channel through the CUDA kernel on the card), the
Davidson iterations run in ``solver_dtype`` (f32 above 200k determinants),
a few f64 iterations refine an f32 solution, and the energy, RDMs and
occupancies are evaluated in f64.  Public results keep ``sqd_tpu``'s layout:
numpy amplitudes ``(M, N)``, numpy RDMs and occupancies.

The SQD loop (``diagonalize_fermionic_hamiltonian``), the other solve
variants, the dense density-fitted operator and the table cache are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import native
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

__all__ = ["SCIResult", "SCIState", "solve_sci"]


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

    device: torch.device = field(kw_only=True)
    """The device the RDM and spin queries run on."""

    def __post_init__(self):
        object.__setattr__(self, "amplitudes", np.asarray(self.amplitudes))
        if self.amplitudes.shape != (len(self.ci_strs_a), len(self.ci_strs_b)):
            raise ValueError(
                f"'amplitudes' shape must be ({len(self.ci_strs_a)}, {len(self.ci_strs_b)}) "
                f"but got {self.amplitudes.shape}"
            )
        object.__setattr__(self, "device", _checked_device(self.device))

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


def _checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


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
    device,
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
    (``"cuda"``, ``"cpu"`` or a ``torch.device``; required, and a CUDA device
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
        table_cache / eri_factor: a table cache, or a Cholesky factor
            (explicit, or ``"auto"`` with ``norb**2 > 256``), is not ported
            yet and raises ``NotImplementedError``; pass ``eri_factor=None``
            to solve such a problem with the exact integrals.
        **kwargs: ignored extras for signature compatibility.

    Returns:
        An :class:`SCIResult` with f64 energy, state, occupancies and RDMs.
    """
    device = _checked_device(device)
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
