"""The benchmark's frozen copies equal their originals: the integrals byte
for byte, the FCIDUMP reader's output, and the traffic generators' outputs
for the cells' seeds."""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest

from benchmark import generators
from benchmark.data.fcidump import read_fcidump as frozen_reader

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FCIDUMPS = ["n2_631g_cas16o_5a5b.fcidump", "n2_ccpvdz_28o_7a7b.fcidump"]
SEEDS = [2147480001, 2147480012, 41, 0]


@pytest.mark.parametrize("name", FCIDUMPS)
def test_fcidump_copied_byte_for_byte(name):
    assert filecmp.cmp(os.path.join(ROOT, "benchmark", "data", name),
                       os.path.join(ROOT, "sqd_tpu_torch", "data", name), shallow=False)


@pytest.mark.parametrize("name", FCIDUMPS)
def test_fcidump_reader_reads_as_the_ports(name):
    from sqd_tpu_torch.models.fcidump import read_fcidump

    path = os.path.join(ROOT, "benchmark", "data", name)
    ours, theirs = frozen_reader(path), read_fcidump(path)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("count, norb, n_elec", [(1000, 16, 5), (1500, 28, 7)])
def test_excitation_strings_as_bench_torch(seed, count, norb, n_elec):
    import bench_torch

    for k in range(2):
        words = generators.seed_words(seed, k, 0)
        np.testing.assert_array_equal(generators.excitation_strings(count, norb, n_elec, words),
                                      bench_torch.excitation_strings(count, norb, n_elec, words))


@pytest.mark.parametrize("seed", SEEDS)
def test_shots_as_chip_smoke(seed):
    import chip_smoke

    sa = generators.excitation_strings(300, 16, 5, generators.seed_words(seed, 0, 0))
    sb = generators.excitation_strings(300, 16, 5, generators.seed_words(seed, 0, 1))
    words = generators.seed_words(seed, 0, 2)
    np.testing.assert_array_equal(generators.shots(sa, sb, 16, 20_000, words),
                                  chip_smoke._shots(sa, sb, 16, 20_000, words))


def test_loop_settings_as_chip_smoke():
    import json

    import chip_smoke

    for traffic, settings in (("sqd_loop", chip_smoke.LOOP_SETTINGS),
                              ("sqd_loop_sym", chip_smoke.CCPVDZ_SETTINGS)):
        with open(os.path.join(ROOT, "benchmark", "traffic", traffic + ".json")) as f:
            loop = json.load(f)["loop"]
        assert loop == {k: v for k, v in settings.items() if k != "seed"}


def test_all_strings():
    from math import comb

    strs = generators.all_strings(16, 5)
    assert len(strs) == comb(16, 5) and np.all(np.diff(strs) > 0)
    assert all(bin(int(s)).count("1") == 5 for s in strs)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**70, -3])
def test_seed_words_are_valid_entropy(seed):
    np.random.default_rng(generators.seed_words(seed, 3))
