# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Observability helpers for the SQD loop (the port of ``sqd_tpu.utils.tracing``).

* :class:`IterationLogger` — a callback object recording per-iteration
  energies, subspace dimensions and wall-clock (a host-side copy of
  ``sqd_tpu``'s).
* :func:`profile_trace` — context manager around ``torch.profiler`` (CPU and,
  where a card exists, CUDA activities) that writes a Chrome trace into a
  directory, in place of ``sqd_tpu``'s ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

__all__ = ["IterationLogger", "profile_trace", "logger"]

logger = logging.getLogger("sqd_tpu_torch")


class IterationLogger:
    """Callback collecting per-iteration metrics of the SQD loop.

    Usage::

        log = IterationLogger()
        result = diagonalize_fermionic_hamiltonian(..., callback=log)
        log.history  # list of dicts: iteration, best/all energies, dims, dt
    """

    def __init__(self, log_level: int | None = logging.INFO):
        self.history: list[dict] = []
        self._t_last = time.perf_counter()
        self._log_level = log_level

    def __call__(self, results) -> None:
        now = time.perf_counter()
        energies = [float(r.energy) for r in results]
        dims = [
            (len(r.sci_state.ci_strs_a), len(r.sci_state.ci_strs_b)) for r in results
        ]
        entry = {
            "iteration": len(self.history),
            "best_energy": min(energies),
            "energies": energies,
            "subspace_dims": dims,
            "occupancies": results[int(np.argmin(energies))].orbital_occupancies,
            "wall_seconds": now - self._t_last,
        }
        self._t_last = now
        self.history.append(entry)
        if self._log_level is not None:
            logger.log(
                self._log_level,
                "SQD iteration %d: best energy %.10f, dims %s, %.2fs",
                entry["iteration"],
                entry["best_energy"],
                dims,
                entry["wall_seconds"],
            )

    @property
    def energies(self) -> list[float]:
        return [h["best_energy"] for h in self.history]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the body with ``torch.profiler`` and write a Chrome trace
    (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
    ``log_dir``.  Records CPU activity, and CUDA kernels when a card exists.
    Yields the profiler (``key_averages()`` sums the events by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
