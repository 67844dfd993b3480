# (C) 2026. Licensed under the Apache License, Version 2.0.
"""FCIDUMP molecular-integral reader and writer (a copy of ``sqd_tpu.models.fcidump``)."""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_fcidump", "write_fcidump"]


def read_fcidump(path) -> dict:
    """Parse an FCIDUMP file.

    Returns dict with ``h1e`` (norb, norb), ``eri`` (norb,)*4 chemist-order
    with 8-fold symmetry expanded, ``ecore`` (float), ``norb``, ``nelec``,
    ``ms2``.
    """
    with open(path) as f:
        text = f.read()
    header_match = re.search(r"&FCI(.*?)(/|&END)", text, re.S | re.I)
    if not header_match:
        raise ValueError(f"{path} does not look like an FCIDUMP file (no &FCI header).")
    header = header_match.group(1)

    def get_int(name, default=None):
        m = re.search(rf"{name}\s*=\s*([0-9]+)", header, re.I)
        if m:
            return int(m.group(1))
        if default is None:
            raise ValueError(f"FCIDUMP header missing {name}.")
        return default

    norb = get_int("NORB")
    nelec = get_int("NELEC")
    ms2 = get_int("MS2", 0)

    body = text[header_match.end() :]
    h1e = np.zeros((norb, norb))
    eri = np.zeros((norb,) * 4)
    ecore = 0.0
    for line in body.splitlines():
        parts = line.split()
        if len(parts) != 5:
            continue
        val = float(parts[0].replace("D", "E").replace("d", "e"))
        i, j, k, l = (int(x) for x in parts[1:])
        if i == j == k == l == 0:
            ecore = val
        elif k == l == 0:
            h1e[i - 1, j - 1] = val
            h1e[j - 1, i - 1] = val
        else:
            p, q, r, s = i - 1, j - 1, k - 1, l - 1
            for a, b, c, d in (
                (p, q, r, s),
                (q, p, r, s),
                (p, q, s, r),
                (q, p, s, r),
                (r, s, p, q),
                (s, r, p, q),
                (r, s, q, p),
                (s, r, q, p),
            ):
                eri[a, b, c, d] = val
    n_alpha = (nelec + ms2) // 2
    n_beta = (nelec - ms2) // 2
    return {
        "h1e": h1e,
        "eri": eri,
        "ecore": ecore,
        "norb": norb,
        "nelec": (n_alpha, n_beta),
        "ms2": ms2,
    }


def write_fcidump(path, h1e, eri, *, nelec, ecore: float = 0.0, ms2: int = 0, tol: float = 1e-12):
    """Write (h1e, eri) to FCIDUMP (unique 8-fold-symmetric elements only)."""
    norb = h1e.shape[0]
    if isinstance(nelec, tuple):
        ms2 = nelec[0] - nelec[1]
        nelec = sum(nelec)
    with open(path, "w") as f:
        f.write(f"&FCI NORB={norb},NELEC={nelec},MS2={ms2},\n")
        f.write(" ORBSYM=" + ",".join(["1"] * norb) + ",\n ISYM=1,\n&END\n")
        for p in range(norb):
            for q in range(p + 1):
                for r in range(p + 1):
                    s_max = q if r == p else r
                    for s in range(s_max + 1):
                        v = eri[p, q, r, s]
                        if abs(v) > tol:
                            f.write(f" {v:23.16E} {p+1:4d} {q+1:4d} {r+1:4d} {s+1:4d}\n")
        for p in range(norb):
            for q in range(p + 1):
                if abs(h1e[p, q]) > tol:
                    f.write(f" {h1e[p, q]:23.16E} {p+1:4d} {q+1:4d}    0    0\n")
        f.write(f" {ecore:23.16E}    0    0    0    0\n")
