# (C) 2026. Licensed under the Apache License, Version 2.0.
"""FCIDUMP molecular-integral reader (``sqd_tpu.models.fcidump.read_fcidump``)."""

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


def write_fcidump(*args, **kwargs):
    """Write integrals as FCIDUMP (``sqd_tpu.models.fcidump.write_fcidump``):
    not ported yet."""
    raise NotImplementedError("write_fcidump is not ported yet; see ROADMAP.md")
