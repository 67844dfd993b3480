# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's own instruments on the CPU: the ``sqd.*`` profiler ranges that
``utils.tracing.span`` opens inside ``solve_sci`` and the SQD loop, their
nesting, their cost with no profiler running, and the counters of Davidson
iterations and ``TableCache`` rows."""

import numpy as np
import pytest
import torch

from sqd_tpu_torch import fermion
from sqd_tpu_torch.counts import generate_bit_array_uniform
from sqd_tpu_torch.ops import davidson
from sqd_tpu_torch.ops.dense_fci import all_hamming_strings
from sqd_tpu_torch.ops.table_cache import TableCache
from sqd_tpu_torch.utils import tracing

torch.set_num_threads(2)

NORB, NELEC = 6, (3, 3)

# (parent, span) of one f32 solve_sci: the kernel route, then the f64 tail
SOLVE_NESTING = {
    (None, "solve"),
    ("solve", "tables"),
    ("tables", "tables.eri_factor"),
    ("tables", "tables.host"),
    ("tables", "tables.upload"),
    ("tables", "tables.hdiag"),
    ("solve", "davidson.solver"),
    ("davidson.solver", "matvec.kernel"),
    ("matvec.kernel", "matvec.samespin"),
    ("solve", "davidson.refine"),
    ("davidson.refine", "matvec.full"),
    ("solve", "rdm"),
    ("rdm", "rdm.dm1"),
    ("rdm", "rdm.ab"),
    ("rdm", "rdm.holes"),
    ("rdm", "rdm.samespin"),
    ("solve", "result"),
    ("result", "energy"),
    ("energy", "matvec.full"),
}


def _integrals(norb, seed):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(2 * norb, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    return h1, np.einsum("xpq,xrs->pqrs", chol, chol)


@pytest.fixture(scope="module")
def system():
    h1, eri = _integrals(NORB, 5)
    strs = all_hamming_strings(NORB, NELEC[0])
    return h1, eri, (strs, strs)


def _solve(system, **kwargs):
    h1, eri, strs = system
    return fermion.solve_sci(strs, h1, eri, NORB, NELEC, device="cpu", **kwargs)


def _spans(prof):
    """``(start, end, name)`` of every ``sqd.*`` range the profiler kept, the
    prefix dropped, in order of start."""
    out = [(e.start_ns(), e.end_ns(), e.name()[len("sqd."):])
           for e in prof.profiler.kineto_results.events() if e.name().startswith("sqd.")]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _nesting(spans):
    """``(parent, name)`` pairs: each span's parent is the innermost span
    that encloses it (``None`` at the top)."""
    pairs, stack = set(), []
    for start, end, name in spans:
        while stack and stack[-1][1] < end:
            stack.pop()
        pairs.add((stack[-1][2] if stack else None, name))
        stack.append((start, end, name))
    return pairs


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_solve_sci_spans_nest(system):
    """An f32 solve opens every span of ``solve_sci``, each under its parent,
    one ``sqd.solve`` and one ``sqd.matvec.samespin`` per kernel-route matvec."""
    result, spans = _profiled(lambda: _solve(system, solver_dtype=torch.float32))
    assert _nesting(spans) == SOLVE_NESTING
    names = [s[2] for s in spans]
    assert names.count("solve") == 1
    assert names.count("matvec.kernel") == names.count("matvec.samespin") >= 2
    assert np.isfinite(result.energy)


def test_loop_spans_nest():
    """Two iterations of the SQD loop: postselection in the first, recovery in
    the second, each iteration's solves and callback under its span."""
    h1, eri = _integrals(NORB, 6)
    bits = generate_bit_array_uniform(400, 2 * NORB, rand_seed=np.random.default_rng(3))
    seen = []
    _, spans = _profiled(lambda: fermion.diagonalize_fermionic_hamiltonian(
        h1, eri, bits, samples_per_batch=60, norb=NORB, nelec=NELEC, num_batches=2,
        max_iterations=2, energy_tol=0.0, callback=seen.append, seed=np.random.default_rng(4),
        device="cpu"))
    pairs = _nesting(spans)
    loop = {(None, "loop.iteration")} | {("loop.iteration", name) for name in (
        "samples.postselect", "samples.recover", "samples.subsample", "loop.strings", "solve",
        "loop.callback")}
    assert loop <= pairs
    assert {parent for parent, name in pairs if name == "solve"} == {"loop.iteration"}
    names = [s[2] for s in spans]
    assert names.count("loop.iteration") == len(seen) == 2
    assert names.count("solve") == 4
    assert names.count("samples.postselect") == names.count("samples.recover") == 1


def test_no_profiler_enters_no_range(system, monkeypatch):
    """With no profiler running a solve enters no profiler range; under one,
    every range it enters is one of its ``sqd.*`` spans."""
    entered = []
    make = torch._C._profiler._RecordFunctionFast

    def counting(name, *args):
        entered.append(name)
        return make(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    assert tracing.span("solve") is tracing.span("rdm")
    _solve(system, solver_dtype=torch.float32)
    assert entered == []
    _, spans = _profiled(lambda: _solve(system, solver_dtype=torch.float32))
    assert len(entered) == len(spans) > 0
    assert all(name.startswith("sqd.") for name in entered)


def test_spans_are_host_ranges(system):
    """A span is a function range of the profiler, not a user annotation: the
    profiler makes no copy of it on the card's timeline."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve(system, solver_dtype=torch.float32)
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("sqd.")]
    assert ranges and not any(e.is_user_annotation() for e in ranges)


def _record_iterations(monkeypatch, owner):
    """Wrap ``owner.davidson_ground_state``; returns the iterations of each call."""
    calls = []
    fn = owner.davidson_ground_state

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out.iterations)
        return out

    monkeypatch.setattr(owner, "davidson_ground_state", wrapper)
    return calls


def test_iteration_counter_counts_both_stages(system, monkeypatch):
    """The counter advances by the f32 stage's iterations plus the f64
    refinement's: at this tolerance its 6 iterations and its continuation."""
    counter = davidson.davidson_ground_state
    calls = _record_iterations(monkeypatch, fermion)
    before = counter.iterations
    _solve(system, solver_dtype=torch.float32, tol=1e-8)
    assert len(calls) == 3 and calls[0] > 0 and calls[1] == 6
    assert counter.iterations - before == sum(calls)


def test_iteration_counter_counts_segments(monkeypatch):
    """On the segmented route (``matvec_strategy="dense_df"``) it advances by
    the segments' sum, which the segmented solver reports capped."""
    norb, nelec = 17, (3, 3)
    rng = np.random.default_rng(21)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    ch = rng.normal(size=(3 * norb, norb, norb)) * (0.4 / np.sqrt(3 * norb))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    all_s = all_hamming_strings(norb, 3)
    strs = (np.sort(rng.choice(all_s, 25, replace=False)),
            np.sort(rng.choice(all_s, 25, replace=False)))
    counter = davidson.davidson_ground_state
    segments = _record_iterations(monkeypatch, davidson)
    before = counter.iterations
    fermion.solve_sci(strs, h1, eri, norb, nelec, matvec_strategy="dense_df", tol=1e-10,
                      device="cpu")
    assert len(segments) >= 2
    assert counter.iterations - before == sum(segments)


def test_table_cache_row_counters(system):
    """Each cached build asks for 2 (M + N) rows (gather and same-spin rows of
    both spins); the rows computed advance as ``native_rows_computed`` does:
    the strings the cache has not seen, once per store (alpha and beta share
    both stores here, ``nelec`` being equal)."""
    h1, eri, (strs, _) = system
    cache = TableCache()
    # strings 0..13, then 2..19 of which 14..19 are new
    for (strs_a, strs_b), new in (((strs[:14], strs[:12]), 14), ((strs[4:], strs[2:16]), 6)):
        requested, computed = TableCache.rows_requested, TableCache.rows_computed
        native_before = cache.native_rows_computed
        fermion.solve_sci((strs_a, strs_b), h1, eri, NORB, NELEC, device="cpu",
                          table_cache=cache)
        assert TableCache.rows_requested - requested == 2 * (len(strs_a) + len(strs_b))
        assert TableCache.rows_computed - computed == cache.native_rows_computed - native_before
        assert TableCache.rows_computed - computed == 2 * new
