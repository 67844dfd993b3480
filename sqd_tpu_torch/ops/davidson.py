# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Davidson eigensolvers (port of ``sqd_tpu.ops.davidson``).

The same algorithms as ``sqd_tpu``'s jitted solvers, as eager Python loops:
fixed ``(max_subspace, dim)`` buffers with an active-row count ``m``, masked
Rayleigh-Ritz on the small Gram matrix (``torch.linalg.eigh`` in f64 or
complex128), spectrum-scaled preconditioner clamp, two-round masked
classical Gram-Schmidt, a raw-residual fallback when the preconditioned
direction collapses, a stall exit, and a thick restart.
:func:`davidson_ground_state` finds the lowest pair (restart keeps
``max(1, min(max_subspace // 3, 8))`` Ritz vectors);
:func:`davidson_lowest_k` the ``k`` lowest (restart keeps at least
``k + 2``).  Both take real symmetric or complex Hermitian operators: the
vectors' dtype decides, and the Ritz values are real.
:func:`davidson_initial_block` is the start block of the complex k > 1 solve.

With a ``group`` (a ``torch.distributed`` process group, the counterpart of
``sqd_tpu``'s ``axis_name`` inside ``shard_map``) the vectors are this rank's
shard of a dimension split over the group's ranks: every inner product, norm
and Gram entry is completed with ``dist.all_reduce``, so every rank holds the
same small Gram matrix, takes the same ``eigh`` and the same branches, and
the Krylov buffers stay sharded.  :func:`davidson_initial_guess_sharded` is
the start vector of such a solve.  Without a group nothing is communicated.

:func:`davidson_ground_state_segmented` relaunches the lowest-pair solver in
segments, as ``sqd_tpu``'s does, and runs where ``sqd_tpu`` runs it.  The
TPU workarounds of ``sqd_tpu`` (Jacobi / hybrid eigensolvers, the
elementwise-f64 row combinations) are not ported: the card has true f64
arithmetic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .precision import highest_precision, real_dtype

__all__ = [
    "DavidsonKResult",
    "DavidsonResult",
    "davidson_ground_state",
    "davidson_ground_state_segmented",
    "davidson_initial_block",
    "davidson_initial_guess",
    "davidson_initial_guess_k",
    "davidson_initial_guess_sharded",
    "davidson_lowest_k",
]


def _finite_and_spread(hdiag: torch.Tensor):
    """``hdiag`` with padding (|h| > 1e20) at +inf, and the unit spread
    ``1 / (h - min h + 1)`` that decays with the diagonal gap (zero on padding)."""
    finite = torch.where(hdiag.abs() > 1e20, torch.inf, hdiag)
    spread = 1.0 / (finite - finite.min() + 1.0)
    return finite, spread / torch.linalg.norm(spread)


def davidson_initial_guess(hdiag: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Robust start vector: min-diagonal one-hot + a diagonal-weighted spread.

    A bare one-hot at ``argmin(hdiag)`` can be an exact eigenvector of a
    disconnected block of a selected-CI operator; the small component on
    every determinant (negligible on 1e30 padding entries) guarantees overlap
    with the true ground state.
    """
    dtype = hdiag.dtype if dtype is None else dtype
    finite, spread = _finite_and_spread(hdiag)
    v0 = spread * 0.2
    v0[torch.argmin(finite)] += 1.0
    return v0.to(dtype)


def davidson_initial_guess_sharded(hdiag_loc: torch.Tensor, group) -> torch.Tensor:
    """:func:`davidson_initial_guess` of a diagonal split over ``group``'s
    ranks, from this rank's shard ``hdiag_loc``: this rank's shard of the
    same vector (``sqd_tpu.parallel.row_sharded._sharded_initial_guess``).

    A shard may hold nothing but padding, so the reference point (the global
    minimum) and the norm are completed over the group; the rank (ranks, on
    a tie) holding the minimum adds the spike at its local argmin.  With no
    group it is :func:`davidson_initial_guess`.
    """
    finite = torch.where(hdiag_loc.abs() > 1e20, torch.inf, hdiag_loc)
    local_min = finite.min()
    lo = _allsum(local_min, group, op=dist.ReduceOp.MIN)
    spread = 1.0 / (finite - lo + 1.0)  # padding: 1 / inf = 0
    v0 = spread / torch.sqrt(_allsum(torch.sum(spread * spread), group)) * 0.2
    if bool(local_min == lo):
        v0[torch.argmin(finite)] += 1.0
    return v0


def davidson_initial_guess_k(hdiag: torch.Tensor, k: int, dtype: torch.dtype | None = None):
    """``(k, dim)`` start block: one-hots at the k smallest diagonal entries.

    Each row gets the same diagonal-weighted spread as
    :func:`davidson_initial_guess`; rows are linearly independent (distinct
    spikes).  Ties go to the lower index, as ``jax.lax.top_k`` breaks them.
    """
    dtype = hdiag.dtype if dtype is None else dtype
    finite, spread = _finite_and_spread(hdiag)
    idx = torch.sort(finite, stable=True).indices[:k]
    block = (spread * 0.2).repeat(k, 1)
    block[torch.arange(k, device=hdiag.device), idx] += 1.0
    return block.to(dtype)


def davidson_initial_block(hdiag: torch.Tensor, block: int, dtype: torch.dtype | None = None):
    """``(block, dim)`` start block whose span holds bare one-hots: the rows of
    :func:`davidson_initial_guess_k` at the ``block - 1`` smallest diagonal
    entries, then the spread alone.

    A string that no term connects to the rest of the subspace is an exact
    eigenvector, and from a one-hot that carries the spread the iteration
    reaches it only by spanning the spread itself.  ``sqd_tpu``'s real
    embedding of a complex operator starts from each one-hot twice (real and
    imaginary part) with the same spread, so the two cancel it; this block
    spans the same bare one-hots.
    """
    dtype = hdiag.dtype if dtype is None else dtype
    _, spread = _finite_and_spread(hdiag)
    rows = davidson_initial_guess_k(hdiag, block - 1, dtype)
    return torch.cat([rows, spread.to(dtype)[None, :]])


class DavidsonResult(NamedTuple):
    theta: float  # lowest Ritz value found
    vector: torch.Tensor  # (dim,) normalized Ritz vector
    residual_norm: float
    iterations: int
    converged: bool


class DavidsonKResult(NamedTuple):
    thetas: torch.Tensor  # (k,) lowest Ritz values, ascending (real)
    vectors: torch.Tensor  # (k, dim) normalized Ritz vectors
    residual_norms: torch.Tensor  # (k,)
    iterations: int
    converged: bool  # all k residuals below tol


def _masked_eigh(t: torch.Tensor, m: int):
    """Eigenpairs of the active ``m x m`` block of ``t``, in f64 (complex128 for
    a complex ``t``); the values come back real.

    Inactive rows get a diagonal above the active spectrum so their pairs
    sort last; active eigenvectors are zero in inactive rows.
    """
    mss = t.shape[0]
    active = torch.arange(mss, device=t.device) < m
    mask2 = active[:, None] & active[None, :]
    big = (t.abs().max() + 1.0) * 4.0
    t_masked = torch.where(mask2, t, 0.0) + torch.diag(torch.where(active, 0.0, big))
    wide = torch.complex128 if t.is_complex() else torch.float64
    vals, vecs = torch.linalg.eigh(t_masked.to(wide))
    return vals.to(real_dtype(t.dtype)), (vecs * active[:, None]).to(t.dtype)


def _allsum(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over ``group``'s ranks, the same on
    every rank; ``x`` itself without a group."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _norm(a: torch.Tensor, group=None) -> torch.Tensor:
    return torch.sqrt(_allsum(torch.vdot(a, a), group).real)


def _precondition(hdiag, r, theta):
    # clamp scaled to the spectrum: an absolute micro-clamp would turn the
    # argmin-hdiag determinant into a spike parallel to the Ritz vector
    clamp = 1e-3 * (1.0 + theta.abs())
    denom = hdiag - theta
    safe = torch.where(denom == 0, 1.0, denom)
    denom = torch.where(denom.abs() < clamp, torch.where(safe < 0, -clamp, clamp), denom)
    return r / denom


def _orthonormalize(t_vec, v, m, eps, group=None):
    """Two rounds of masked classical Gram-Schmidt against the first ``m`` rows
    of ``v``; returns ``(vec, norm)``."""
    active = (torch.arange(v.shape[0], device=v.device) < m).to(v.dtype)
    for _ in range(2):
        coeffs = _allsum(v.conj() @ t_vec, group) * active
        t_vec = t_vec - v.T @ coeffs
    nrm = _norm(t_vec, group)
    return t_vec / torch.clamp(nrm, min=eps), nrm


def davidson_ground_state(
    matvec: Callable,
    operator,
    hdiag: torch.Tensor,
    v0: torch.Tensor,
    *,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_iterations: int = 200,
    group=None,
) -> DavidsonResult:
    """Find the lowest eigenpair of the implicit symmetric (or Hermitian) operator.

    Args:
        matvec: ``matvec(operator, x) -> Hx`` on flat ``(dim,)`` vectors.
        operator: the operator data consumed by ``matvec``.
        hdiag: ``(dim,)`` diagonal for the preconditioner; padded entries
            hold a huge value so they are never selected or amplified.
        v0: ``(dim,)`` initial guess (need not be normalized); its dtype is the
            working dtype (complex for a Hermitian operator).
        tol: residual-norm convergence threshold.
        max_subspace: Krylov buffer rows.
        max_iterations: matvec budget.
        group: a ``torch.distributed`` process group over which ``hdiag``,
            ``v0`` and the vectors ``matvec`` takes and returns are split
            (each rank passes its shard); ``None``: not split.
    """
    # f32 Gram-Schmidt and Rayleigh-Ritz need full-f32 products (no TF32)
    with highest_precision():
        res = _davidson(matvec, operator, hdiag, v0, tol, max_subspace, max_iterations, group)
    if not res.converged:
        _iteration_counter.unconverged += 1
    return res


# Davidson iterations run by every lowest-pair solve (segments and stages
# included), counted in _davidson, and the lowest-pair solves that returned
# unconverged at their iteration cap (a segmented solve once, not each
# segment); callers read the change across their work.
davidson_ground_state.iterations = 0
davidson_ground_state.unconverged = 0
_iteration_counter = davidson_ground_state  # the owner, also where the name is rebound


def davidson_ground_state_segmented(
    matvec: Callable,
    operator,
    hdiag: torch.Tensor,
    v0: torch.Tensor,
    *,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_iterations: int = 200,
    segment_iterations: int = 25,
    group=None,
) -> DavidsonResult:
    """Same contract as :func:`davidson_ground_state`, run in segments.

    ``sqd_tpu``'s ``davidson_ground_state_segmented``: the solver is
    relaunched every ``segment_iterations`` matvecs, each segment
    warm-started from the current Ritz vector (its Krylov space dropped),
    until a segment converges or ends early (a stall, or the precision
    floor), or the segments' iterations reach ``max_iterations``; the count
    returned is capped at ``max_iterations``.  ``sqd_tpu`` bounds the length
    of one device program this way, but the restart also changes the solve:
    an f32 solve that stalls just above ``tol`` unsegmented can converge in
    segments (``bench_torch.py``'s config 5 at 96 x 96 strings: the cap of
    200 iterations unsegmented, 26 in segments).  Each segment costs one host sync and one more matvec
    (the restart vector's).  ``group`` as in :func:`davidson_ground_state`.
    """
    total = 0
    v = v0
    res = None
    segments = 0
    while total < max_iterations:
        res = davidson_ground_state(
            matvec, operator, hdiag, v,
            tol=tol, max_subspace=max_subspace,
            max_iterations=segment_iterations, group=group,
        )
        total += res.iterations
        segments += 1
        # converged, stalled (precision floor), or the solver exited early
        if res.converged or res.iterations < segment_iterations:
            break
        v = res.vector
    # each segment but the last stopped unconverged at its cap and was counted:
    # the segmented solve counts once, as its last segment
    _iteration_counter.unconverged -= segments - 1
    return res._replace(iterations=min(total, max_iterations))


def _davidson(matvec, operator, hdiag, v0, tol, mss, max_iterations, group) -> DavidsonResult:
    dim = hdiag.shape[0]
    dt = v0.dtype
    dev = v0.device
    eps = torch.finfo(real_dtype(dt)).tiny ** 0.5
    dep_eps = 64 * torch.finfo(real_dtype(dt)).eps
    keep = max(1, min(mss // 3, 8))
    rows = torch.arange(mss, device=dev)

    v0 = v0 / _norm(v0, group)
    w0 = matvec(operator, v0)
    v = torch.zeros((mss, dim), dtype=dt, device=dev)
    w = torch.zeros((mss, dim), dtype=dt, device=dev)
    t = torch.zeros((mss, mss), dtype=dt, device=dev)
    v[0], w[0] = v0, w0
    t[0, 0] = _allsum(torch.vdot(v0, w0), group)
    theta = t[0, 0].real.clone()
    u, hu = v0, w0
    rnorm = float(_norm(w0 - theta * v0, group))
    m, it = 1, 0
    done = rnorm < tol
    while not done and it < max_iterations:
        r = hu - theta * u
        pre = _precondition(hdiag, r, theta)
        pre_norm = float(_norm(pre, group))
        t_new, nrm_pre = _orthonormalize(pre, v, m, eps, group)
        # the clamped preconditioner can give a direction (almost) inside the
        # subspace: fall back to the raw residual, and stop at the precision
        # floor when that collapses too (reported as converged, as in sqd_tpu)
        if float(nrm_pre) <= dep_eps * max(pre_norm, eps):
            t_new, nrm_raw = _orthonormalize(r, v, m, eps, group)
            if float(nrm_raw) <= dep_eps * max(rnorm, eps):
                it += 1
                _iteration_counter.iterations += 1
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
            t[rows[:keep], rows[:keep]] = vals[:keep].to(dt)
            m = keep
        t_ortho, _ = _orthonormalize(t_new, v, m, eps, group)
        w_new = matvec(operator, t_ortho)
        v[m], w[m] = t_ortho, w_new
        col = _allsum(v.conj() @ w_new, group) * (rows <= m)
        t[m, :] = col.conj()
        t[:, m] = col
        m += 1
        vals, vecs = _masked_eigh(t, m)
        theta, y = vals[0], vecs[:, 0]
        u, hu = y @ v, y @ w
        rnorm = float(_norm(hu - theta * u, group))
        it += 1
        _iteration_counter.iterations += 1
        done = rnorm < tol
    return DavidsonResult(
        theta=float(theta),
        vector=u / _norm(u, group),
        residual_norm=rnorm,
        iterations=it,
        converged=done,
    )


def davidson_lowest_k(
    matvec: Callable,
    operator,
    hdiag: torch.Tensor,
    v0: torch.Tensor,
    *,
    k: int,
    tol: float = 1e-5,
    max_subspace: int = 32,
    max_iterations: int = 300,
    group=None,
) -> DavidsonKResult:
    """Block Davidson: the k lowest eigenpairs of an implicit symmetric (or
    Hermitian) operator.

    Same contract as :func:`davidson_ground_state` generalized to a block:
    ``v0`` is a ``(k, dim)`` start block (see :func:`davidson_initial_guess_k`);
    each iteration expands the shared Krylov space with the preconditioned
    residual of the lowest unconverged Ritz pair, and thick restarts keep at
    least ``k + 2`` Ritz vectors, so converged pairs are never lost.  With a
    ``group``, every rank passes its shard of ``hdiag`` and of each row of
    ``v0``, as in :func:`davidson_ground_state`.
    """
    if k >= max_subspace - 2:
        raise ValueError(f"max_subspace ({max_subspace}) must exceed k + 2 ({k + 2})")
    with highest_precision():
        return _davidson_k(matvec, operator, hdiag, v0, k, tol, max_subspace, max_iterations,
                           group)


def _davidson_k(matvec, operator, hdiag, v0, k, tol, mss, max_iterations,
                group) -> DavidsonKResult:
    dim = hdiag.shape[0]
    dt = v0.dtype
    dev = v0.device
    eps = torch.finfo(real_dtype(dt)).tiny ** 0.5
    dep_eps = 64 * torch.finfo(real_dtype(dt)).eps
    keep = min(max(k + 2, min(mss // 3, 8)), mss - 2)
    rows = torch.arange(mss, device=dev)

    def row_norms(x):
        return torch.sqrt(_allsum((x * x.conj()).real.sum(dim=1), group))

    def ritz(v, w, t, m):
        vals, vecs = _masked_eigh(t, m)
        thetas = vals[:k]
        y = vecs[:, :k]  # (mss, k)
        u, hu = y.T @ v, y.T @ w
        return thetas, u, hu, row_norms(hu - thetas[:, None] * u)

    # seed the basis with the orthonormalized start block (k matvecs)
    v = torch.zeros((mss, dim), dtype=dt, device=dev)
    w = torch.zeros((mss, dim), dtype=dt, device=dev)
    for i in range(k):
        v[i], _ = _orthonormalize(v0[i], v, i, eps, group)
        w[i] = matvec(operator, v[i])
    t = torch.zeros((mss, mss), dtype=dt, device=dev)
    blk = _allsum(v[:k].conj() @ w[:k].T, group)
    t[:k, :k] = 0.5 * (blk + blk.conj().T)  # symmetrize roundoff
    m, it = k, 0
    thetas, u, hu, rnorms = ritz(v, w, t, m)
    done = bool((rnorms < tol).all())
    while not done and it < max_iterations:
        # the lowest unconverged Ritz pair drives the expansion
        pick = int(torch.nonzero(rnorms >= tol)[0, 0])
        r = hu[pick] - thetas[pick] * u[pick]
        pre = _precondition(hdiag, r, thetas[pick])
        pre_norm = float(_norm(pre, group))
        t_new, nrm_pre = _orthonormalize(pre, v, m, eps, group)
        if float(nrm_pre) <= dep_eps * max(pre_norm, eps):
            t_new, nrm_raw = _orthonormalize(r, v, m, eps, group)
            if float(nrm_raw) <= dep_eps * max(float(rnorms[pick]), eps):
                it += 1
                done = True
                break
        if m >= mss:
            vals, vecs = _masked_eigh(t, m)
            y = vecs[:, :keep]
            v_keep, w_keep = y.T @ v, y.T @ w
            v.zero_()
            w.zero_()
            t.zero_()
            v[:keep], w[:keep] = v_keep, w_keep
            t[rows[:keep], rows[:keep]] = vals[:keep].to(dt)
            m = keep
        t_ortho, _ = _orthonormalize(t_new, v, m, eps, group)
        w_new = matvec(operator, t_ortho)
        v[m], w[m] = t_ortho, w_new
        col = _allsum(v.conj() @ w_new, group) * (rows <= m)
        t[m, :] = col.conj()
        t[:, m] = col
        m += 1
        thetas, u, hu, rnorms = ritz(v, w, t, m)
        it += 1
        done = bool((rnorms < tol).all())
    return DavidsonKResult(
        thetas=thetas,
        vectors=u / torch.clamp(row_norms(u), min=eps)[:, None],
        residual_norms=rnorms,
        iterations=it,
        converged=bool((rnorms < tol).all()),
    )
