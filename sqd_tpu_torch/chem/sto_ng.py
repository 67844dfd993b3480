# (C) 2026. Licensed under the Apache License, Version 2.0.
"""STO-nG expansion fitter (Hehre-Stewart-Pople methodology, from scratch).

STO-nG bases are DEFINED algorithmically (Hehre, Stewart, Pople, JCP 51,
2657 (1969)): each Slater-type orbital ``chi_{n,l}(zeta)`` is replaced by the
least-squares best contraction of ``n_g`` Gaussians, fitted once at
``zeta = 1`` and rescaled as ``alpha_i(zeta) = alpha_i(1) * zeta**2`` (the
overlap between the STO and the contracted Gaussian is invariant under that
joint scaling).  Pople sp shells share one exponent set between the ns and np
fits, maximizing the SUM of the two overlaps.

This module re-derives those universal expansions by direct optimization —
maximize ``<STO | sum_i c_i g_i>`` over exponents, with the optimal
coefficients available in closed form (a generalized Rayleigh quotient:
``c ~ S_gg^{-1} s``, overlap ``= sqrt(s^T S_gg^{-1} s)``) — so only the 3
log-exponents per shell are free parameters.  The fitted 1s/2sp/3sp values
reproduce the published STO-3G tables to ~1e-4 (``tests/test_sto_ng.py``),
which validates the 3d/4sp fits the published first-row tables don't cover.

Purpose here: generate minimal-basis data for elements beyond the
transcribed H-Ne tables (``basis_data.py``) — in particular the iron entry
for the BASELINE config-4/5 Fe-S systems, built at documented Slater-rule
exponents (:func:`slater_zeta`).  That choice is stated where used: the
published transition-metal STO-3G (Pietro & Hehre, J. Comput. Chem. 4, 241
(1983)) optimized its zetas variationally; Slater-rule zetas are the
documented, reproducible stand-in — the expansions themselves are exact
STO-nG fits either way.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["fit_sto_ng", "fit_sto_ng_shared", "slater_zeta", "sto3g_shells"]


def _radial_grid(npts: int = 4000, rmax: float = 60.0):
    """Log-spaced radial quadrature grid (dense near 0 where STOs peak)."""
    # r = exp(u) substitution: integral f(r) r^2 dr = f(e^u) e^{3u} du
    u = np.linspace(np.log(1e-7), np.log(rmax), npts)
    r = np.exp(u)
    du = u[1] - u[0]
    w = r**3 * du  # r^2 dr = r^3 du (trapezoid end corrections negligible)
    w[0] *= 0.5
    w[-1] *= 0.5
    return r, w


def _sto_radial(n: int, r: np.ndarray) -> np.ndarray:
    """Normalized Slater radial ``R_n(r) = N r^{n-1} e^{-r}`` at zeta = 1."""
    norm = 2.0 ** (n + 0.5) / math.sqrt(math.factorial(2 * n))
    return norm * r ** (n - 1) * np.exp(-r)


def _gauss_radial(l: int, alpha: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Normalized Gaussian radials ``R_l(r) ~ r^l e^{-a r^2}``, one per row."""
    a = np.asarray(alpha, float)[:, None]
    # norm^2 = 2 (2a)^{l+3/2} / Gamma(l+3/2)
    norm = np.sqrt(2.0 * (2.0 * a) ** (l + 1.5) / math.gamma(l + 1.5))
    return norm * r[None, :] ** l * np.exp(-a * r[None, :] ** 2)


def _best_overlap(n: int, l: int, alpha: np.ndarray, grid) -> tuple[float, np.ndarray]:
    """Max overlap of chi_{n,l}(zeta=1) with span{g_i} and its coefficients.

    Returns ``(overlap, c)`` with ``c`` in the normalized-primitive
    convention scaled so the contracted function is itself normalized
    (the convention of every published STO-nG table and of
    ``basis_data.BASIS_SETS``).
    """
    r, w = grid
    g = _gauss_radial(l, alpha, r)  # (ng, npts)
    sto = _sto_radial(n, r)
    s = g @ (w * sto)  # <g_i | sto>
    gram = (g * w) @ g.T  # <g_i | g_j>  (analytic would do; grid is exact enough)
    try:
        c = np.linalg.solve(gram, s)
    except np.linalg.LinAlgError:  # pragma: no cover - degenerate exponents
        return 0.0, np.zeros_like(s)
    val = float(s @ c)
    if val <= 0:  # pragma: no cover - pathological trial point
        return 0.0, c
    overlap = math.sqrt(val)
    c = c / math.sqrt(float(c @ gram @ c))  # normalize the contraction
    return overlap, c


def _optimize(fun, x0: np.ndarray) -> np.ndarray:
    """Nelder-Mead on log-exponents (scipy if present, else a local copy)."""
    try:
        from scipy.optimize import minimize

        res = minimize(fun, x0, method="Nelder-Mead",
                       options={"xatol": 1e-10, "fatol": 1e-14, "maxiter": 20000})
        return res.x
    except ModuleNotFoundError:  # pragma: no cover - scipy is a dependency
        x = x0.copy()
        step = 0.05
        f = fun(x)
        for _ in range(20000):
            improved = False
            for i in range(len(x)):
                for d in (step, -step):
                    xt = x.copy()
                    xt[i] += d
                    ft = fun(xt)
                    if ft < f:
                        x, f, improved = xt, ft, True
            if not improved:
                step *= 0.5
                if step < 1e-10:
                    break
        return x


def fit_sto_ng(n: int, l: int, ng: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Fit ``ng`` Gaussians to the ``(n, l)`` Slater orbital at zeta = 1.

    Returns ``(alpha, c)`` sorted by descending exponent; rescale with
    ``alpha * zeta**2`` for a general zeta (coefficients are invariant).
    """
    grid = _radial_grid()
    # spread initial exponents geometrically around the STO's length scale
    x0 = np.log(np.geomspace(10.0 / n**2, 0.1 / n**2, ng))

    def neg(x):
        ov, _ = _best_overlap(n, l, np.exp(x), grid)
        return -ov

    x = _optimize(neg, x0)
    alpha = np.exp(x)
    order = np.argsort(-alpha)
    alpha = alpha[order]
    _, c = _best_overlap(n, l, alpha, grid)
    return alpha, c


def fit_sto_ng_shared(n: int, ng: int = 3) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit an sp shell: ONE exponent set for the ns and np Slater orbitals.

    Maximizes ``overlap(ns) + overlap(np)`` (the Pople shared-exponent
    constraint).  Returns ``(alpha, c_s, c_p)``.
    """
    grid = _radial_grid()
    x0 = np.log(np.geomspace(10.0 / n**2, 0.1 / n**2, ng))

    def neg(x):
        a = np.exp(x)
        ov_s, _ = _best_overlap(n, 0, a, grid)
        ov_p, _ = _best_overlap(n, 1, a, grid)
        return -(ov_s + ov_p)

    x = _optimize(neg, x0)
    alpha = np.exp(x)
    order = np.argsort(-alpha)
    alpha = alpha[order]
    _, c_s = _best_overlap(n, 0, alpha, grid)
    _, c_p = _best_overlap(n, 1, alpha, grid)
    return alpha, c_s, c_p


# --------------------------------------------------------------------------
# Slater-rule exponents (Slater, Phys. Rev. 36, 57 (1930)) — documented,
# reproducible zetas for elements without a transcribed published table.
# --------------------------------------------------------------------------

_NSTAR = {1: 1.0, 2: 2.0, 3: 3.0, 4: 3.7}


def slater_zeta(z: int, occ_shells: list[tuple[int, str, int]]) -> dict[tuple[int, str], float]:
    """Slater-rule effective exponents ``zeta = (Z - screening) / n*``.

    ``occ_shells``: ``[(n, kind, nelec), ...]`` with kind ``"sp"`` or ``"d"``,
    in shell order.  Classic rules: same-group electrons screen 0.35 (1s:
    0.30); for s/p, (n-1)-shell electrons screen 0.85 and deeper 1.00; for
    d, ALL inner electrons screen 1.00.
    """
    zetas: dict[tuple[int, str], float] = {}
    for idx, (n, kind, nel) in enumerate(occ_shells):
        same = 0.35 * (nel - 1) if (n, kind) != (1, "sp") else 0.30 * (nel - 1)
        inner = 0.0
        for jn, jkind, jnel in occ_shells[:idx]:
            if kind == "d":
                inner += 1.0 * jnel
            elif jn == n - 1:
                inner += 0.85 * jnel
            elif jn <= n - 2:
                inner += 1.0 * jnel
            elif jn == n:  # same n, different kind (3d when computing 4s)
                inner += 0.85 * jnel if kind == "sp" else 1.0 * jnel
        s = same + inner
        zetas[(n, kind)] = (z - s) / _NSTAR[n]
    return zetas


def sto3g_shells(zetas_by_shell: list[tuple[int, str, float]]) -> list[tuple[int, list]]:
    """Build ``basis_data``-format shells from ``[(n, kind, zeta), ...]``.

    ``kind``: ``"s"`` (lone s), ``"sp"`` (shared-exponent s+p pair) or
    ``"d"``.  Exponents scale as ``alpha * zeta**2``; coefficients are the
    universal zeta = 1 fits.
    """
    shells: list[tuple[int, list]] = []
    for n, kind, zeta in zetas_by_shell:
        if kind == "sp":
            alpha, c_s, c_p = fit_sto_ng_shared(n)
            a = alpha * zeta**2
            shells.append((0, list(zip(a.tolist(), c_s.tolist()))))
            shells.append((1, list(zip(a.tolist(), c_p.tolist()))))
        elif kind == "s":
            alpha, c = fit_sto_ng(n, 0)
            a = alpha * zeta**2
            shells.append((0, list(zip(a.tolist(), c.tolist()))))
        elif kind == "d":
            alpha, c = fit_sto_ng(n, 2)
            a = alpha * zeta**2
            shells.append((2, list(zip(a.tolist(), c.tolist()))))
        else:  # pragma: no cover - caller error
            raise ValueError(f"unknown shell kind {kind!r}")
    return shells
