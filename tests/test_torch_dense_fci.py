# (C) 2026. Licensed under the Apache License, Version 2.0.
"""``sqd_tpu_torch.ops.dense_fci`` is ``sqd_tpu.ops.dense_fci`` bit for bit.

Every one of its ten functions, on seeded inputs: random symmetric integrals
over 5 orbitals, random selected string sets (open and closed shell), a
normalized random vector; all results compared with ``assert_array_equal``
(the two copies run the same NumPy operations in the same order).  Nothing of
the port's operator code is involved: this is the examples' exact oracle on
the card, and ``sqd_tpu``'s copy stays the tests' independent oracle.
"""

import itertools

import numpy as np
import pytest

from sqd_tpu.ops import dense_fci as ref
from sqd_tpu_torch.ops import dense_fci

NORB = 5


def _integrals(seed):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(NORB, NORB))
    eri = rng.normal(size=(NORB,) * 4)
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return (h1 + h1.T) / 2, eri / 8


def _sets(seed, nelec=(3, 2)):
    rng = np.random.default_rng(seed)
    full_a = ref.all_hamming_strings(NORB, nelec[0])
    full_b = ref.all_hamming_strings(NORB, nelec[1])
    sa = np.sort(rng.choice(full_a, 7, replace=False))
    sb = np.sort(rng.choice(full_b, 6, replace=False))
    return sa, sb


def _vector(sa, sb, seed):
    v = np.random.default_rng(seed).normal(size=len(sa) * len(sb))
    return v / np.linalg.norm(v)


def _equal(a, b):
    if isinstance(a, tuple | list):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _calls(name):
    """Each function's arguments: several seeded inputs."""
    h1, eri = _integrals(4)
    sa, sb = _sets(5)
    v = _vector(sa, sb, 6)
    strs = ref.all_hamming_strings(NORB, 2)
    if name == "apply_excitation_int":
        return [(s, p, q) for s in (0b10110, 0b01011, 7) for p, q in
                itertools.product(range(NORB), repeat=2)]
    if name == "_index_map":
        return [(sa,), (strs,)]
    if name == "_single_excitation_matrix":
        return [(sa, NORB), (strs, NORB)]
    if name == "_full_sector":
        return [(sa, NORB), (sb, NORB)]
    if name == "build_dense_hamiltonian":
        return [(sa, sb, h1, eri), (strs, strs, h1, eri)]
    if name == "build_dense_s2":
        return [(sa, sb, NORB), (sa, sa, NORB)]
    if name == "_embed":
        return [(v, sa, sb, NORB)]
    if name in ("dense_rdm1s", "dense_rdm12"):
        return [(v, sa, sb, NORB), (_vector(strs, strs, 7), strs, strs, NORB)]
    if name == "all_hamming_strings":
        return [(NORB, 2), (8, 5), (64, 1), (65, 2)]  # object dtype past 63 orbitals
    raise KeyError(name)


FUNCTIONS = ["apply_excitation_int", "_index_map", "_single_excitation_matrix", "_full_sector",
             "build_dense_hamiltonian", "build_dense_s2", "_embed", "dense_rdm1s",
             "dense_rdm12", "all_hamming_strings"]


def test_the_copy_has_every_function():
    def functions(module):
        return {n for n, f in vars(module).items()
                if callable(f) and f.__module__ == module.__name__}

    ours, theirs = functions(dense_fci), functions(ref)
    assert ours == theirs == set(FUNCTIONS)
    assert dense_fci.__all__ == ref.__all__


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_is_bit_for_bit(name):
    for args in _calls(name):
        _equal(getattr(dense_fci, name)(*args), getattr(ref, name)(*args))
