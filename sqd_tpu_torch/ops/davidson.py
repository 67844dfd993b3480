# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Davidson ground-state eigensolver (port of ``sqd_tpu.ops.davidson``).

The same algorithm as ``sqd_tpu``'s jitted solver, as an eager Python loop:
fixed ``(max_subspace, dim)`` buffers with an active-row count ``m``, masked
Rayleigh-Ritz on the small Gram matrix (``torch.linalg.eigh`` in f64),
spectrum-scaled preconditioner clamp, two-round masked classical
Gram-Schmidt, a raw-residual fallback when the preconditioned direction
collapses, a stall exit, and a thick restart that keeps
``max(1, min(max_subspace // 3, 8))`` Ritz vectors.

The TPU workarounds of ``sqd_tpu`` (Jacobi / hybrid eigensolvers, the
elementwise-f64 row combinations, the segmented driver) are not ported: the
card has true f64 arithmetic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .precision import highest_precision

__all__ = ["DavidsonResult", "davidson_ground_state", "davidson_initial_guess"]


def davidson_initial_guess(hdiag: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Robust start vector: min-diagonal one-hot + a diagonal-weighted spread.

    A bare one-hot at ``argmin(hdiag)`` can be an exact eigenvector of a
    disconnected block of a selected-CI operator; the small component on
    every determinant (negligible on 1e30 padding entries) guarantees overlap
    with the true ground state.
    """
    dtype = hdiag.dtype if dtype is None else dtype
    finite = torch.where(hdiag.abs() > 1e20, torch.inf, hdiag)
    lo = finite.min()
    spread = 1.0 / (finite - lo + 1.0)
    spread = spread / torch.linalg.norm(spread)
    v0 = spread * 0.2
    v0[torch.argmin(finite)] += 1.0
    return v0.to(dtype)


class DavidsonResult(NamedTuple):
    theta: float  # lowest Ritz value found
    vector: torch.Tensor  # (dim,) normalized Ritz vector
    residual_norm: float
    iterations: int
    converged: bool


def _masked_eigh(t: torch.Tensor, m: int):
    """Eigenpairs of the active ``m x m`` block of ``t``, in f64.

    Inactive rows get a diagonal above the active spectrum so their pairs
    sort last; active eigenvectors are zero in inactive rows.
    """
    mss = t.shape[0]
    active = torch.arange(mss, device=t.device) < m
    mask2 = active[:, None] & active[None, :]
    big = (t.abs().max() + 1.0) * 4.0
    t_masked = torch.where(mask2, t, 0.0) + torch.diag(torch.where(active, 0.0, big))
    vals, vecs = torch.linalg.eigh(t_masked.to(torch.float64))
    return vals.to(t.dtype), (vecs * active[:, None]).to(t.dtype)


def davidson_ground_state(
    matvec: Callable,
    operator,
    hdiag: torch.Tensor,
    v0: torch.Tensor,
    *,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_iterations: int = 200,
) -> DavidsonResult:
    """Find the lowest eigenpair of the implicit symmetric operator.

    Args:
        matvec: ``matvec(operator, x) -> Hx`` on flat ``(dim,)`` vectors.
        operator: the operator data consumed by ``matvec``.
        hdiag: ``(dim,)`` diagonal for the preconditioner; padded entries
            hold a huge value so they are never selected or amplified.
        v0: ``(dim,)`` initial guess (need not be normalized); its dtype is the
            working dtype.
        tol: residual-norm convergence threshold.
        max_subspace: Krylov buffer rows.
        max_iterations: matvec budget.
    """
    # f32 Gram-Schmidt and Rayleigh-Ritz need full-f32 products (no TF32)
    with highest_precision():
        return _davidson(matvec, operator, hdiag, v0, tol, max_subspace, max_iterations)


def _davidson(matvec, operator, hdiag, v0, tol, mss, max_iterations) -> DavidsonResult:
    dim = hdiag.shape[0]
    dt = v0.dtype
    dev = v0.device
    eps = torch.finfo(dt).tiny ** 0.5
    dep_eps = 64 * torch.finfo(dt).eps
    keep = max(1, min(mss // 3, 8))
    rows = torch.arange(mss, device=dev)

    def norm(a):
        return torch.sqrt(torch.dot(a, a))

    def orthonormalize(t_vec, v, m):
        """Two rounds of masked classical Gram-Schmidt; returns (vec, norm)."""
        active = (rows < m).to(dt)
        for _ in range(2):
            coeffs = (v.conj() @ t_vec) * active
            t_vec = t_vec - v.T @ coeffs
        nrm = norm(t_vec)
        return t_vec / torch.clamp(nrm, min=eps), nrm

    def precondition(r, theta):
        # clamp scaled to the spectrum: an absolute micro-clamp would turn the
        # argmin-hdiag determinant into a spike parallel to the Ritz vector
        clamp = 1e-3 * (1.0 + theta.abs())
        denom = hdiag - theta
        safe = torch.where(denom == 0, 1.0, denom)
        denom = torch.where(
            denom.abs() < clamp, torch.where(safe < 0, -clamp, clamp), denom
        )
        return r / denom

    v0 = v0 / norm(v0)
    w0 = matvec(operator, v0)
    v = torch.zeros((mss, dim), dtype=dt, device=dev)
    w = torch.zeros((mss, dim), dtype=dt, device=dev)
    t = torch.zeros((mss, mss), dtype=dt, device=dev)
    v[0], w[0] = v0, w0
    t[0, 0] = torch.dot(v0, w0)
    theta = t[0, 0].clone()
    u, hu = v0, w0
    rnorm = float(norm(w0 - theta * v0))
    m, it = 1, 0
    done = rnorm < tol
    while not done and it < max_iterations:
        r = hu - theta * u
        pre = precondition(r, theta)
        pre_norm = float(norm(pre))
        t_new, nrm_pre = orthonormalize(pre, v, m)
        # the clamped preconditioner can give a direction (almost) inside the
        # subspace: fall back to the raw residual, and stop at the precision
        # floor when that collapses too (reported as converged, as in sqd_tpu)
        if float(nrm_pre) <= dep_eps * max(pre_norm, eps):
            t_new, nrm_raw = orthonormalize(r, v, m)
            if float(nrm_raw) <= dep_eps * max(rnorm, eps):
                it += 1
                done = True
                break
        if m >= mss:
            # thick restart: keep the best few Ritz vectors
            vals, vecs = _masked_eigh(t, m)
            y = vecs[:, :keep]  # (mss, keep), inactive rows zero
            v_keep, w_keep = y.T @ v, y.T @ w
            v.zero_()
            w.zero_()
            t.zero_()
            v[:keep], w[:keep] = v_keep, w_keep
            t[rows[:keep], rows[:keep]] = vals[:keep]
            m = keep
        t_ortho, _ = orthonormalize(t_new, v, m)
        w_new = matvec(operator, t_ortho)
        v[m], w[m] = t_ortho, w_new
        col = (v.conj() @ w_new) * (rows <= m)
        t[m, :] = col.conj()
        t[:, m] = col
        m += 1
        vals, vecs = _masked_eigh(t, m)
        theta, y = vals[0], vecs[:, 0]
        u, hu = y @ v, y @ w
        rnorm = float(norm(hu - theta * u))
        it += 1
        done = rnorm < tol
    return DavidsonResult(
        theta=float(theta),
        vector=u / norm(u),
        residual_norm=rnorm,
        iterations=it,
        converged=done,
    )
