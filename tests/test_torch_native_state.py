# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Recover ``sqd_tpu.native`` after a lost build race, for the port's tests.

``sqd_tpu.native`` builds ``libsqdcore.so`` in place with g++ the first time a
process asks for it, and remembers a failed load for the life of the
process.  Under ``pytest -n`` every worker collects the modules that call
``native.available()`` at once, so several workers write the same file at the
same time, and a worker that loads it half written keeps ``sqd_tpu``'s NumPy
fallbacks for every test it runs.  The port's tests compare against
``sqd_tpu`` bit for bit where the native kernels decide the result (the
Pauli diagonal, the gather tables' clamped sources), so such a worker fails
them.

:func:`ensure_sqd_tpu_native` loads the library again.  No test starts before
every worker has finished collecting, so by the time a test runs the last
write has ended and the file is whole and newer than its source: the retry
loads it and builds nothing.  If it still does not load, the test fails with
the reason; it is never skipped.  Modules that reach ``sqd_tpu.native``
import the fixture :func:`sqd_tpu_native_loaded`, which calls it once per
module.
"""

import ctypes
import os

import numpy as np
import pytest

from sqd_tpu import native as jax_native


def ensure_sqd_tpu_native() -> None:
    """Load ``sqd_tpu.native``'s library if an earlier attempt left it unloaded;
    fail the calling test if it cannot be loaded."""
    if jax_native._lib is not None:
        return
    jax_native._tried = False
    if jax_native._load() is not None:
        return
    path = jax_native._LIB_PATH
    if not os.path.exists(path):
        reason = f"{path} does not exist and g++ did not build it"
    else:
        try:
            ctypes.CDLL(path)
            reason = f"{path} loads with ctypes, but sqd_tpu.native._load() returned None"
        except OSError as exc:
            reason = f"{path} does not load: {exc}"
    pytest.fail(f"sqd_tpu.native is unavailable: {reason}")


@pytest.fixture(scope="module", autouse=True)
def sqd_tpu_native_loaded():
    """Module-scoped: the importing module's tests run with the library loaded."""
    ensure_sqd_tpu_native()


def test_recovers_from_lost_race(monkeypatch):
    # the state a worker is left in after loading a half-written file
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    bits = np.array([[1, 0, 1], [0, 1, 1]], dtype=bool)
    zmask = np.array([1, 0, 1], dtype=np.uint8)  # one byte per column
    assert jax_native.pauli_diag_elements(bits, zmask, 1.0) is None
    ensure_sqd_tpu_native()
    assert jax_native._lib is not None
    out = jax_native.pauli_diag_elements(bits, zmask, 1.0)
    assert out is not None
    amps, rows, cols = out
    np.testing.assert_array_equal(amps, [1.0, -1.0])
    np.testing.assert_array_equal(rows, [0, 1])
    np.testing.assert_array_equal(cols, [0, 1])
