# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's guide examples 13 and 16 against ``sqd_tpu``'s record (see
``test_torch_examples_a.py``), ``sqd_tpu``'s ``16`` live against its record,
and ``13``'s ``problem()`` as the example's own inputs."""

import numpy as np
import pytest

from test_torch_examples_a import RECORDS, check_example, run_sqd_tpu_example
from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch.examples import records


@pytest.mark.parametrize("name", ["13_large_active_space", "16_open_shell_rohf"])
def test_example_matches_record(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)


def test_sqd_tpu_16_matches_its_record(monkeypatch, tmp_path):
    """The committed record is current: ``sqd_tpu``'s ``16`` prints it now,
    loop lines included (its own noise is the record's)."""
    name = "16_open_shell_rohf"
    lines = run_sqd_tpu_example(name, monkeypatch, tmp_path)
    assert records.compare(name, RECORDS[name]["guide"]["lines"], lines) == []


def test_13_problem_is_the_sqd_tpu_example_inputs():
    """``problem()`` of the port's ``13`` builds the inputs ``sqd_tpu``'s
    ``main()`` builds inline: 36 orbitals, (27, 27), 24 strings per spin,
    a PSD ERI of rank 108."""
    h1, eri, sa, sb, norb, nelec = records.load_example("13_large_active_space").problem()
    assert (norb, nelec, len(sa), len(sb)) == (36, (27, 27), 24, 24)
    assert h1.shape == (36, 36) and eri.shape == (36,) * 4
    assert all(bin(int(s)).count("1") == 27 for s in np.concatenate([sa, sb]))
    w = np.linalg.eigvalsh(eri.reshape(36 * 36, 36 * 36))
    assert w.min() > -1e-10 and np.count_nonzero(w > 1e-10) == 108
