"""The comparison fails what it must: the control (the program's f32-only
path, the reference in f32 in place of its f64 energy and RDMs), and the
rest of a run with the timed path broken underneath.  CPU, tiny cells; the
harness's look for a card is skipped."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import measure


@pytest.mark.parametrize("workload", ["tiny.loop", "tiny.solve"])
def test_control_is_not_correct(tiny_root, workload):
    sound = measure(tiny_root, workload)
    control = measure(tiny_root, workload, control=True)
    assert sound["correct"] and not control["correct"]
    failed = {k for k, c in control["checks"].items() if c["value"] > c["limit"]}
    assert {"energy_gap", "rdm1_gap", "rdm2_gap", "ground_gap"} <= failed


def _unchanged_state(monkeypatch):
    """A Davidson that returns its start vector as its answer."""
    from sqd_tpu_torch import fermion

    real = fermion.davidson_ground_state

    def broken(matvec, operator, hdiag, v0, **kwargs):
        return real(matvec, operator, hdiag, v0, **kwargs)._replace(vector=v0.clone())

    monkeypatch.setattr(fermion, "davidson_ground_state", broken)


def _half_left_out(monkeypatch):
    """The RDMs taken over half of the amplitudes' rows, renormalised."""
    from sqd_tpu_torch.ops import rdm

    real = rdm.make_rdms

    def broken(ham, vec, *args, **kwargs):
        vec = vec.clone()
        vec[vec.shape[0] // 2:] = 0
        return real(ham, vec / vec.norm(), *args, **kwargs)

    monkeypatch.setattr(rdm, "make_rdms", broken)


def _energy_altered(monkeypatch):
    """The energy moved by 1e-7 Ha where it is produced."""
    from sqd_tpu_torch import fermion

    real = fermion.expectation_value
    monkeypatch.setattr(fermion, "expectation_value", lambda *a, **k: real(*a, **k) + 1e-7)


def _batch_left_out(monkeypatch):
    """Half of the loop's batches left out, the best taken over the rest."""
    from sqd_tpu_torch import fermion

    real = fermion.solve_sci_batch
    monkeypatch.setattr(fermion, "solve_sci_batch",
                        lambda cs, *a, **k: real(cs[: max(1, len(cs) // 2)], *a, **k))


def _excited_state(monkeypatch):
    """The Davidson converging to the first excited state: the ground state
    that the f32 solve finds is shifted up by 10 Ha in both Davidson calls."""
    from sqd_tpu_torch import fermion

    real, memo = fermion.davidson_ground_state, {}

    def broken(matvec, operator, hdiag, v0, **kwargs):
        if v0.dtype == torch.float32:
            g = real(matvec, operator, hdiag, v0, **kwargs).vector
            memo["g"] = g / g.norm()
        g = memo["g"].to(v0.dtype)

        def shifted(op, x):
            return matvec(op, x) + 10.0 * g * (g @ x)

        return real(shifted, operator, hdiag, v0 - (g @ v0) * g, **kwargs)

    monkeypatch.setattr(fermion, "davidson_ground_state", broken)


def _string_altered(monkeypatch):
    """The first CI string of each batch dropped where the batch's strings are made."""
    from sqd_tpu_torch import fermion

    real = fermion._unique_with_order_preserved
    monkeypatch.setattr(fermion, "_unique_with_order_preserved", lambda v: real(v)[1:])


FAULTS = {
    "tiny.solve": [_unchanged_state, _half_left_out, _energy_altered, _excited_state],
    "tiny.loop": [_unchanged_state, _half_left_out, _energy_altered, _excited_state,
                  _batch_left_out, _string_altered],
}


@pytest.mark.parametrize("workload, fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = measure(tiny_root, workload)
    assert not out["correct"], out["checks"]
    if fault is _excited_state:  # an excited state, a whole gap above the ground state's
        assert out["checks"]["ground_gap"]["value"] > 1e-2, out["checks"]


def test_reservoir_is_seeded_and_uniform():
    from benchmark.drivers.judging import Reservoir

    picks = []
    for seed in range(400):
        r = Reservoir(2, [seed])
        for i in range(10):
            r.offer(i, i)
        picks += r.kept()
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 40 and counts.max() < 120
    a, b = Reservoir(3, [5]), Reservoir(3, [5])
    for i in range(20):
        a.offer(i, i)
        b.offer(i, i)
    assert a.kept() == b.kept()
