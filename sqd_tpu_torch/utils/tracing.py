# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Observability helpers for the SQD loop (the port of ``sqd_tpu.utils.tracing``).

* :class:`IterationLogger` — a callback object recording per-iteration
  energies, subspace dimensions and wall-clock (a host-side copy of
  ``sqd_tpu``'s).
* :func:`profile_trace` — context manager around ``torch.profiler`` (CPU and,
  where a card exists, CUDA activities) that writes a Chrome trace into a
  directory, in place of ``sqd_tpu``'s ``jax.profiler`` trace.
* :func:`span` — a named range of the program's own work, ``sqd.<name>``,
  on the profiler's clock.

The port opens spans where its work happens: ``sqd.solve`` around each
``solve_sci``, and inside it ``sqd.tables`` (``.eri_factor``; ``.card`` where
the card builds the tables, ``.host`` where the native library or a
``TableCache`` does; ``.upload``, ``.hdiag``), ``sqd.davidson.solver`` and
``sqd.davidson.refine``,
``sqd.matvec.<route>`` around each operator application (``kernel``, ``full``,
``blocked``, ``dense_df``; ``sqd.matvec.samespin`` inside ``kernel``),
``sqd.rdm`` (``.dm1``, ``.ab``, ``.holes``, ``.samespin``), ``sqd.energy`` and
``sqd.result``; in the SQD loop ``sqd.loop.iteration`` around each iteration,
and inside it ``sqd.samples.postselect``, ``.recover``, ``.subsample``,
``sqd.loop.strings`` and ``sqd.loop.callback``.  Spans nest on the host
thread: a span's parent is the range that encloses it.  They cost one check
when no profiler runs; under :func:`profile_trace` each is a function range
of the profiler on the host thread, so the Chrome trace shows the launches
inside each span, linked to their kernels, and the card's idle gaps beside
what the host was doing.  Unlike ``torch.profiler.record_function``'s user
ranges, they leave no copy on the card's timeline, where a copy would span
the idle gaps between the kernels it encloses and read as device time.

Five counters count the work, always on:
``sqd_tpu_torch.ops.davidson.davidson_ground_state.iterations`` (Davidson
iterations of every solve and stage),
``sqd_tpu_torch.ops.table_cache.TableCache.rows_requested`` and
``.rows_computed`` (per-string table rows asked of every cache, and those its
native kernels had to compute; the rest were reused), and
``sqd_tpu_torch.ops.card_tables.build_tables.launches`` (operators whose
tables the card built, one per ``build_sci_hamiltonian`` there) and
``card_tables.gather_tables.launches`` (one spin's gather tables the card
built, two per ``build_sci_basis`` there).  Read them before and after the
work and take the difference.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

__all__ = ["IterationLogger", "profile_trace", "span", "logger"]

logger = logging.getLogger("sqd_tpu_torch")

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A context manager over the program's work named ``name``: while a
    profiler runs, the host range ``sqd.<name>`` (a function range, which
    costs about a sixth of a ``record_function`` and has no device copy);
    otherwise nothing (one check, no range entered)."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast("sqd." + name)
    return _NO_SPAN
