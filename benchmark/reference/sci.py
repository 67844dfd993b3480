"""The plain reference: a selected-CI subspace's Hamiltonian and RDMs.

Written from the Slater-Condon rules alone, in plain PyTorch, from the
integrals and the CI strings.  It imports nothing of the program and takes no
table the program built: it enumerates its own excitations of the strings.

The subspace is the product of an alpha and a beta string set; amplitudes
``c`` are ``(M, N)``.  With ``E^s_pq = a+_ps a_qs`` the Hamiltonian (no core
energy) is

    H = H_a (x) 1 + 1 (x) H_b + sum_{pq,rs} (pq|rs) E^a_pq E^b_rs

where ``H_a`` is the alpha strings' own Hamiltonian (one-body part and the
same-spin two-body part), computed as a dense ``M x M`` matrix by the
Slater-Condon rules, and the opposite-spin part is exact on a product space.
RDMs follow the convention ``E = sum h dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]``
with ``dm2[p,q,r,s] = sum_{st} <a+_ps a+_rt a_st a_qs>``; the same-spin blocks
come from the transition matrix ``C C^T`` over pairs of strings at most a
double excitation apart.  Everything runs in the dtype asked for (f64 for
the reference, f32 for the control), in blocks of alpha rows that keep each
intermediate within ``block_bytes``.  :meth:`Subspace.lowest_eigenvalue`
finds the subspace's ground-state energy on its own, from a random start.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 1 << 30


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each entry of an int64 tensor of non-negative values."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _bit_index(power_of_two: torch.Tensor) -> torch.Tensor:
    return torch.log2(power_of_two.to(torch.float64)).round().to(torch.int64)


def _between(strs: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Occupied orbitals of ``strs`` strictly between orbitals ``a`` and ``b``."""
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    one = torch.ones_like(lo)
    mask = ((one << hi) - 1) ^ ((one << (lo + 1)) - 1)
    return torch.where(hi > lo, popcount(strs & mask), torch.zeros_like(lo))


def _sign(n: torch.Tensor) -> torch.Tensor:
    return 1 - 2 * (n & 1)


def _bits(strs: torch.Tensor, norb: int) -> torch.Tensor:
    return (strs[:, None] >> torch.arange(norb, device=strs.device)) & 1


def singles(strs: torch.Tensor, norb: int):
    """Every ``<I|a+_p a_q|J>`` within the string set, ``p == q`` included.

    Returns ``(bra, ket, pq, sign)``: row indices ``I``, ``J`` into ``strs``
    (sorted ascending), the pair index ``p * norb + q`` and the sign.
    """
    m = strs.shape[0]
    bits = _bits(strs, norb).bool()
    eye = torch.eye(norb, dtype=torch.bool, device=strs.device)
    # ket J, hole q (occupied), particle p (empty, or q itself)
    ket, q, p = torch.nonzero(bits[:, :, None] & (~bits[:, None, :] | eye), as_tuple=True)
    one = torch.ones_like(p)
    target = strs[ket] ^ (one << q) ^ (one << p)
    pos = torch.searchsorted(strs, target).clamp(max=m - 1)
    found = strs[pos] == target
    sign = _sign(_between(strs[ket], p, q))
    return pos[found], ket[found], (p * norb + q)[found], sign[found]


def doubles(strs: torch.Tensor, rows: slice):
    """Ordered pairs (bra in ``rows``, any ket) two excitations apart.

    Returns ``(bra, ket, p1, q1, p2, q2, sign)`` with ``<I|a+_p1 a+_p2 a_q2
    a_q1|J> = sign``: particles ``p1 < p2`` (in I, not in J), holes
    ``q1 < q2`` (in J, not in I).
    """
    bra_strs = strs[rows]
    x = bra_strs[:, None] ^ strs[None, :]
    bra, ket = torch.nonzero(popcount(x) == 4, as_tuple=True)
    si, sj = bra_strs[bra], strs[ket]
    x = si ^ sj
    part, hole = si & x, sj & x
    p1b, q1b = part & -part, hole & -hole
    p1, p2 = _bit_index(p1b), _bit_index(part - p1b)
    q1, q2 = _bit_index(q1b), _bit_index(hole - q1b)
    mid = sj ^ q1b ^ p1b
    sign = _sign(_between(sj, p1, q1) + _between(mid, p2, q2))
    return bra + rows.start, ket, p1, q1, p2, q2, sign


class Subspace:
    """One product subspace and its integrals, on ``device`` in ``dtype``."""

    def __init__(self, strs_a, strs_b, h1, eri, norb: int, *, device, dtype=torch.float64,
                 block_bytes: int = BLOCK_BYTES):
        self.norb, self.device, self.dtype = norb, torch.device(device), dtype
        self.block_bytes = block_bytes
        self.sa = torch.as_tensor(np.asarray(strs_a, np.int64), device=self.device)
        self.sb = torch.as_tensor(np.asarray(strs_b, np.int64), device=self.device)
        if not all(bool((s[1:] > s[:-1]).all()) for s in (self.sa, self.sb)):
            raise ValueError("CI strings must be sorted ascending and unique")
        self.h1 = torch.as_tensor(np.asarray(h1), device=self.device).to(dtype)
        self.eri = torch.as_tensor(np.asarray(eri), device=self.device).to(dtype)
        self.singles_a = singles(self.sa, norb)
        self.singles_b = singles(self.sb, norb)
        self._h_a = self._h_b = None

    # -- the same-spin Hamiltonians -------------------------------------------
    def _samespin(self, strs, ones) -> torch.Tensor:
        """The dense Slater-Condon matrix of one spin's strings."""
        norb, dt = self.norb, self.dtype
        h1, eri = self.h1, self.eri
        m = strs.shape[0]
        bits = _bits(strs, norb).to(dt)
        jm = torch.einsum("iijj->ij", eri)
        km = torch.einsum("ijji->ij", eri)
        diag = bits @ torch.diagonal(h1) + 0.5 * ((bits @ (jm - km)) * bits).sum(1)
        h = torch.diag(diag)
        bra, ket, pq, sign = ones
        off = (pq // norb) != (pq % norb)
        bra, ket, pq, sign = bra[off], ket[off], pq[off], sign[off]
        p, q = pq // norb, pq % norb
        # W[p,q,k] = (pq|kk) - (pk|kq); the k = q term vanishes on its own
        w = torch.einsum("pqkk->pqk", eri) - torch.einsum("pkkq->pqk", eri)
        val = h1[p, q] + (bits[ket] * w[p, q]).sum(1)
        h.index_put_((bra, ket), sign.to(dt) * val, accumulate=True)
        for rows in self._row_blocks(m, m * 8 * 4):
            b, k, p1, q1, p2, q2, sg = doubles(strs, rows)
            val = eri[p1, q1, p2, q2] - eri[p1, q2, p2, q1]
            h.index_put_((b, k), sg.to(dt) * val, accumulate=True)
        return h

    def _row_blocks(self, rows: int, bytes_per_row: int):
        step = max(1, min(rows, self.block_bytes // max(bytes_per_row, 1)))
        for i0 in range(0, rows, step):
            yield slice(i0, min(rows, i0 + step))

    @property
    def h_a(self):
        if self._h_a is None:
            self._h_a = self._samespin(self.sa, self.singles_a)
        return self._h_a

    @property
    def h_b(self):
        if self._h_b is None:
            self._h_b = self._samespin(self.sb, self.singles_b)
        return self._h_b

    # -- the opposite-spin channel, and its 2-RDM block -----------------------
    def _cross(self, c: torch.Tensor, with_dm2: bool):
        """``sigma_ab = sum (pq|rs) E^a_pq E^b_rs c`` and, with ``with_dm2``,
        ``X[pq, rs] = <c|E^a_pq E^b_rs|c>``, over blocks of alpha rows."""
        norb, dt = self.norb, self.dtype
        npair = norb * norb
        m, n = c.shape
        v = self.eri.reshape(npair, npair)
        bra_a, ket_a, pq_a, sg_a = self.singles_a
        order = torch.argsort(bra_a)
        bra_a, ket_a, pq_a, sg_a = bra_a[order], ket_a[order], pq_a[order], sg_a[order].to(dt)
        bra_b, ket_b, rs_b, sg_b = self.singles_b
        sg_b = sg_b.to(dt)
        col_b = rs_b * n + ket_b
        sigma = torch.zeros_like(c)
        x = torch.zeros((npair, npair), dtype=dt, device=self.device) if with_dm2 else None
        starts = torch.searchsorted(bra_a, torch.arange(m + 1, device=self.device)).tolist()
        for rows in self._row_blocks(m, npair * n * c.element_size() * 4):
            b = rows.stop - rows.start
            lo, hi = starts[rows.start], starts[rows.stop]
            d = torch.zeros((b * npair, n), dtype=dt, device=self.device)
            d.index_add_(0, (bra_a[lo:hi] - rows.start) * npair + pq_a[lo:hi],
                         sg_a[lo:hi, None] * c[ket_a[lo:hi]])
            g = torch.matmul(v, d.view(b, npair, n)).view(b, npair * n)
            sigma[rows].index_add_(1, bra_b, g[:, col_b] * sg_b)
            del g
            if with_dm2:
                f = torch.zeros((b, npair * n), dtype=dt, device=self.device)
                f.index_add_(1, col_b, c[rows][:, bra_b] * sg_b)
                dt_ = d.view(b, npair, n).transpose(0, 1).reshape(npair, b * n)
                ft = f.view(b, npair, n).transpose(0, 1).reshape(npair, b * n)
                x += dt_ @ ft.T
                del f, dt_, ft
            del d
        return sigma, x

    def apply(self, c: torch.Tensor) -> torch.Tensor:
        """``H c`` for amplitudes ``(M, N)``, without the core energy."""
        c = c.to(self.dtype)
        sigma, _ = self._cross(c, with_dm2=False)
        return sigma + self.h_a @ c + c @ self.h_b.T

    def lowest_eigenvalue(self, seed: int, *, tol: float = 1e-7, max_steps: int = 600,
                          check_every: int = 10) -> float:
        """The subspace's lowest eigenvalue, without the core energy.

        Plain Lanczos with full reorthogonalisation from a random start drawn
        from ``seed`` on the device, which has a part in every symmetry sector
        and so converges to the lowest eigenvalue first.  Every
        ``check_every`` steps the tridiagonal matrix's lowest Ritz pair is
        read; it stops when that pair's residual norm ``|beta_k s_k|`` is under
        ``tol``, where the eigenvalue's error is of the order of ``tol**2``
        over the gap to the next one.  Raises if it has not converged in
        ``max_steps`` steps (one product with ``H`` each).
        """
        m, n = self.sa.shape[0], self.sb.shape[0]
        dim = m * n
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        steps = min(max_steps, dim)
        basis = torch.zeros((steps, dim), dtype=self.dtype, device=self.device)
        v = torch.randn(dim, generator=gen, dtype=self.dtype, device=self.device)
        basis[0] = v / torch.linalg.norm(v)
        alpha, beta = [], []
        for k in range(steps):
            w = self.apply(basis[k].view(m, n)).reshape(-1)
            alpha.append(float(basis[k] @ w))
            for _ in range(2):  # full reorthogonalisation, twice against rounding
                w = w - basis[: k + 1].T @ (basis[: k + 1] @ w)
            b = float(torch.linalg.norm(w))
            if (k + 1) % check_every == 0 or k + 1 == steps or b < tol:
                t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
                theta, s = np.linalg.eigh(t)
                if abs(b * s[-1, 0]) < tol:
                    return float(theta[0])
            if k + 1 < steps:
                beta.append(b)
                basis[k + 1] = w / b
        raise ArithmeticError(f"Lanczos did not converge to {tol} in {steps} steps")

    # -- RDMs -------------------------------------------------------------
    def _samespin_dm2(self, strs, ones, t: torch.Tensor) -> torch.Tensor:
        """``sum_{IJ} t[I,J] <I|a+_p a+_r a_s a_q|J>`` flattened over
        ``[p,q,r,s]``, for one spin's strings and transition matrix ``t``."""
        norb, dt = self.norb, self.dtype
        n4 = norb**4
        dm2 = torch.zeros(n4, dtype=dt, device=self.device)

        def put(p, q, r, s, val):
            dm2.index_add_(0, ((p * norb + q) * norb + r) * norb + s, val)

        bits = _bits(strs, norb).bool()
        # the diagonal: q != s both occupied
        j, q, s = torch.nonzero(bits[:, :, None] & bits[:, None, :]
                                & ~torch.eye(norb, dtype=torch.bool, device=self.device),
                                as_tuple=True)
        tv = torch.diagonal(t)[j]
        put(q, q, s, s, tv)
        put(s, q, q, s, -tv)
        # singles h -> p' with a spectator k occupied in both strings
        bra, ket, pq, sign = ones
        off = (pq // norb) != (pq % norb)
        bra, ket, pq, sign = bra[off], ket[off], pq[off], sign[off]
        pp, hh = pq // norb, pq % norb
        e, k = torch.nonzero(bits[ket] & (torch.arange(norb, device=self.device)[None, :]
                                          != hh[:, None]), as_tuple=True)
        pp, hh = pp[e], hh[e]
        tv = sign[e].to(dt) * t[bra[e], ket[e]]
        put(pp, hh, k, k, tv)
        put(k, k, pp, hh, tv)
        put(k, hh, pp, k, -tv)
        put(pp, k, k, hh, -tv)
        # doubles
        m = strs.shape[0]
        for rows in self._row_blocks(m, m * 8 * 4):
            b, kk, p1, q1, p2, q2, sg = doubles(strs, rows)
            tv = sg.to(dt) * t[b, kk]
            put(p1, q1, p2, q2, tv)
            put(p2, q2, p1, q1, tv)
            put(p1, q2, p2, q1, -tv)
            put(p2, q1, p1, q2, -tv)
        return dm2

    def _dm1(self, ones, t: torch.Tensor) -> torch.Tensor:
        bra, ket, pq, sign = ones
        dm1 = torch.zeros(self.norb**2, dtype=self.dtype, device=self.device)
        dm1.index_add_(0, pq, sign.to(self.dtype) * t[bra, ket])
        return dm1.reshape(self.norb, self.norb)

    def evaluate(self, c, *, with_rdm2: bool = True) -> dict:
        """Everything the comparison reads for normalised amplitudes ``c``:
        the Rayleigh quotient, the residual norm ``|Hc - E c|``, the
        spin-summed 1-RDM, the occupancies and the spin-summed 2-RDM."""
        norb = self.norb
        c = torch.as_tensor(np.asarray(c), device=self.device).to(self.dtype)
        c = c / torch.linalg.norm(c)
        sigma, x = self._cross(c, with_dm2=with_rdm2)
        sigma += self.h_a @ c + c @ self.h_b.T
        energy = float((c * sigma).sum())
        residual = float(torch.linalg.norm(sigma - energy * c))
        del sigma
        t_a, t_b = c @ c.T, c.T @ c
        dm1a, dm1b = self._dm1(self.singles_a, t_a), self._dm1(self.singles_b, t_b)
        out = {
            "energy": energy,
            "residual": residual,
            "rdm1": (dm1a + dm1b).cpu().numpy(),
            "occ_a": torch.diagonal(dm1a).cpu().numpy(),
            "occ_b": torch.diagonal(dm1b).cpu().numpy(),
        }
        if with_rdm2:
            dm2 = (self._samespin_dm2(self.sa, self.singles_a, t_a)
                   + self._samespin_dm2(self.sb, self.singles_b, t_b))
            dm2 += (x + x.T).reshape(-1)
            out["rdm2"] = dm2.reshape((norb,) * 4).cpu().numpy()
        return out
