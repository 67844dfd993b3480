"""The cross-spin channel's work, counted from the strings."""

from __future__ import annotations

import itertools

import pytest

from benchmark import generators
from benchmark.metrics import _cross_spin_work as work


def brute_singles(strs, norb):
    index = set(int(s) for s in strs)
    count = 0
    for s in strs:
        s = int(s)
        for q, p in itertools.product(range(norb), repeat=2):
            if (s >> q) & 1 and (p == q or not (s >> p) & 1):
                count += (s ^ (1 << q) ^ (1 << p)) in index
    return count


@pytest.mark.parametrize("norb, n_elec, count, seed",
                         [(8, 3, 30, 1), (10, 4, 80, 2), (12, 5, 150, 3)])
def test_in_set_singles_by_brute_force(norb, n_elec, count, seed):
    strs = generators.excitation_strings(count, norb, n_elec, seed)
    assert work.in_set_singles(strs, norb) == brute_singles(strs, norb)


def test_headline_shape():
    """1000 x 1000 excitation strings (seeds 1, 2) at 16 orbitals: the 0.7784
    GFLOP that chip_smoke.py's bound counts from the kernel's operands."""
    a = generators.excitation_strings(1000, 16, 5, 1)
    b = generators.excitation_strings(1000, 16, 5, 2)
    flops, nbytes = work.work(a, b, 16)
    assert flops == 778_381_184
    assert nbytes == 4 * (2 * 1000 * 1000 + 16**4) + 8 * (
        work.in_set_singles(a, 16) + work.in_set_singles(b, 16))
    assert work.least_seconds(flops, nbytes) == pytest.approx(flops / work.PEAK_F32_FLOPS)


def test_full_space_counts_every_single():
    a = generators.all_strings(16, 5)
    assert work.in_set_singles(a, 16) == len(a) * (5 * 11 + 5)
    flops, _ = work.work(a, a, 16)
    assert flops == 2.0 * (len(a) * 60) ** 2
