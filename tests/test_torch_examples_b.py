# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's guide examples 07-12, 14 and 15 against ``sqd_tpu``'s record
(see ``test_torch_examples_a.py``)."""

import pytest

from test_torch_examples_a import check_example


@pytest.mark.parametrize("name", ["07_benchmark_pauli_projection", "08_fcidump_workflow",
                                  "09_choose_subspace_dimension", "10_excitation_augmentation",
                                  "11_real_molecule_n2", "12_excited_states", "14_ccpvdz_n2",
                                  "15_multiprocess_cluster"])
def test_example_matches_record(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)
