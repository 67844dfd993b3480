"""The program's spans in a traced run, on hand-made profiler events: the
pure summary (self time, attribution by correlation id, unmatched device
events, idle time inside spans), the quantities read from it, the two
counter readers, which read nothing from a program without their counters,
and the operator's script on a tiny cell."""

from __future__ import annotations

import os

import pytest
from torch.autograd import DeviceType

from benchmark import harness, program_trace
from benchmark.probe import summarize
from benchmark.program_trace import OUTSIDE, UNATTRIBUTED, program_events, summarize_program

MS = 1_000_000  # ns
HOST = 1  # the host thread's id
READERS = ("table_reuse", "davidson_iters")

# the program's spans of one solve (start, end, name, thread)
SPANS = [(2.1, 7.9, "solve"), (2.2, 3.5, "tables"), (2.3, 2.8, "tables.host"),
         (4.0, 7.0, "davidson.solver"), (4.7, 5.2, "matvec.kernel")]
# runtime calls (start, correlation id) and device events (start, end, name, correlation id)
LAUNCHES = [(2.9, 11, "cudaLaunchKernel"), (4.8, 12, "cuLaunchKernel"),
            (9.4, 13, "cudaLaunchKernel")]
DEVICE = [(3.0, 4.0, "k1", 11), (5.0, 5.5, "k2", 12), (9.5, 12.0, "k1", 13),
          (0.5, 1.5, "Memcpy HtoD", 99)]


class Event:
    def __init__(self, name, kind, start, end, corr=0, thread=HOST):
        self._v = name, kind, round(start * MS), round(end * MS), corr, thread

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class Profiler:
    """What ``summarize`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        kineto = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Inner", (), {"kineto_results": kineto})()


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
BENCH_EVENTS = [Event("bench.window", CPU, 0, 10), Event("bench.request", CPU, 1, 9),
                Event("bench.solve", CPU, 2, 8), Event("aten::mm", CPU, 3, 3.5, corr=11)]
KERNELS = [Event(name, CUDA, s, e, corr=c) for s, e, name, c in DEVICE]
PROGRAM_EVENTS = ([Event("sqd." + name, CPU, s, e) for s, e, name in SPANS]
                  + [Event(name, CPU, s, s + 0.01, corr=c) for s, c, name in LAUNCHES])
# the device-side copy a user range (record_function) gets, as the harness's
# own bench.* ranges do
BENCH_COPY = Event("bench.solve", CUDA, 2.5, 7.0)

# the keys summarize returned before, for BENCH_EVENTS + KERNELS, each sum in
# the order the function accumulates it
NS = 1e-9
BEFORE = {
    "busy_s": (1 * MS + 1 * MS + MS // 2 + MS // 2) * NS,
    "window_s": 10 * MS * NS,
    "kernels": {"k1": 1 * MS * NS + (12 * MS - round(9.5 * MS)) * NS, "k2": MS // 2 * NS,
                "Memcpy HtoD": 1 * MS * NS},
    "idle_by_span": {"window": MS // 2 * NS + MS // 2 * NS,
                     "request": MS // 2 * NS + 1 * MS * NS,
                     "solve": 1 * MS * NS + 1 * MS * NS + (8 * MS - round(5.5 * MS)) * NS},
}
BEFORE["breakdown"] = {
    "device_ops": [["k1", BEFORE["kernels"]["k1"]], ["Memcpy HtoD", 1 * MS * NS],
                   ["k2", MS // 2 * NS]],
    "idle_gaps": [["solve", BEFORE["idle_by_span"]["solve"]],
                  ["request", BEFORE["idle_by_span"]["request"]],
                  ["window", BEFORE["idle_by_span"]["window"]]],
}


def _program():
    return summarize_program(
        [(round(s * MS), round(e * MS), name, HOST) for s, e, name in SPANS],
        [(round(s * MS), c, HOST) for s, c, _ in LAUNCHES],
        [(round(s * MS), round(e * MS), c) for s, e, _, c in DEVICE], 0, 10 * MS)


def test_host_ranges_move_no_key_of_summarize():
    """The program's ranges are host ranges: with them and the runtime calls
    in the events, every key ``summarize`` returns is as without them.  A
    device-side copy of a range would be read as device time."""
    assert summarize(Profiler(BENCH_EVENTS + KERNELS + [BENCH_COPY])) == summarize(
        Profiler(BENCH_EVENTS + KERNELS + PROGRAM_EVENTS + [BENCH_COPY]))
    out = summarize(Profiler(BENCH_EVENTS + KERNELS + PROGRAM_EVENTS))
    assert {k: out[k] for k in BEFORE} == BEFORE
    copy = summarize(Profiler(BENCH_EVENTS + KERNELS + [Event("sqd.solve", CUDA, 3.0, 5.5)]))
    assert copy["busy_s"] > BEFORE["busy_s"]


def test_program_events_from_the_profiler():
    """``program_events`` takes the ``sqd.*`` host ranges, the runtime calls
    and the device events (no range copies) inside the harness's window."""
    events = program_events(Profiler(BENCH_EVENTS + KERNELS + PROGRAM_EVENTS + [BENCH_COPY]))
    spans, launches, device, w0, w1 = events
    assert sorted(s[2] for s in spans) == sorted(name for _, _, name in SPANS)
    assert sorted(c for _, c, _ in launches) == [11, 12, 13]
    assert sorted(c for _, _, c in device) == [11, 12, 13, 99]
    assert (w0, w1) == (0, 10 * MS)
    assert summarize_program(*events) == _program()
    assert program_events(Profiler(KERNELS)) is None


def test_self_time_and_nesting():
    spans = _program()["spans"]
    assert spans["solve"]["count"] == 1
    assert spans["solve"]["total_s"] == pytest.approx(5.8e-3)
    assert spans["solve"]["self_s"] == pytest.approx((5.8 - 1.3 - 3.0) * 1e-3)
    assert spans["solve/tables"]["self_s"] == pytest.approx(0.8e-3)
    assert spans["solve/tables/tables.host"]["self_s"] == pytest.approx(0.5e-3)
    assert spans["solve/davidson.solver"]["self_s"] == pytest.approx(2.5e-3)


def test_device_time_by_correlation():
    """Each device event goes to the innermost span open at its runtime call,
    clipped to the window; one issued outside every span is ``outside``, one
    no runtime call matches is ``unattributed``."""
    device = _program()["device_s"]
    assert device == pytest.approx({
        "solve/tables": 1e-3, "solve/davidson.solver/matvec.kernel": 0.5e-3,
        OUTSIDE: 0.5e-3, UNATTRIBUTED: 1e-3})


def test_idle_inside_spans():
    """The card's idle gaps, put down to the innermost span the host was in;
    idle time outside every span belongs to none."""
    program = _program()
    assert program["idle_s"] == pytest.approx({
        "solve": 1.0e-3, "solve/tables": 0.3e-3, "solve/tables/tables.host": 0.5e-3,
        "solve/davidson.solver": 2.2e-3, "solve/davidson.solver/matvec.kernel": 0.3e-3})
    assert program["matvec_kernel_spans_per_solve"] == [1]


def test_spans_of_another_thread_stay_apart():
    """A launch on a thread with no spans is ``outside``; the other thread's
    spans do not nest in the host thread's."""
    out = summarize_program(
        [(0, 10, "solve", 1), (2, 4, "rdm", 2)], [(3, 7, 2), (3, 8, 3)],
        [(5, 6, 7), (6, 7, 8)], 0, 10)
    assert set(out["spans"]) == {"solve", "rdm"}
    assert out["device_s"] == pytest.approx({"rdm": 1e-9, OUTSIDE: 1e-9})


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"),
                               "benchmark_metric_test_" + name)


def _record(counters=()):
    return {"calls": {"solve": [{"seconds": 1.0, "counters": dict(c)} for c in counters]}}


def test_quantities_of_a_summary():
    program = _program()
    rdm = summarize_program(
        [(0, 100, "solve", 1), (50, 90, "rdm", 1), (60, 80, "rdm.samespin", 1),
         (0, 100, "solve", 2)],
        [(65, 1, 1), (85, 2, 1)], [(70, 90, 1), (90, 95, 2)], 0, 200)
    assert program_trace.span_seconds_per_solve(program, "tables.host") == pytest.approx(0.5e-3)
    assert program_trace.span_seconds_per_solve(program, "tables.hdiag") is None
    assert program_trace.matvec_ms(program) == pytest.approx(0.5)
    assert program_trace.solver_idle(program) == pytest.approx(100 * 2.5 / 3.0)
    # 1 ms unmatched beside 1.5 ms issued inside the solve
    assert program_trace.unattributed_share(program) == pytest.approx(40.0)
    # two solves (one on each thread), 20 ns of Gram kernels
    assert program_trace.device_seconds_per_solve(rdm, "rdm.samespin") == pytest.approx(10e-9)
    assert program_trace.device_seconds_per_solve(program, "rdm.samespin") is None
    empty = summarize_program([], [], [], 0, 10)
    for fn in (program_trace.matvec_ms, program_trace.solver_idle,
               program_trace.unattributed_share):
        assert fn(empty) is None


def test_readers_on_a_record():
    counters = [{"davidson_iterations": 10, "table_rows_requested": 100,
                 "table_rows_computed": 30, "cross_spin_launches": 1},
                {"davidson_iterations": 14, "table_rows_requested": 100,
                 "table_rows_computed": 10, "cross_spin_launches": 1}]
    rec = _record(counters)
    assert _reader("davidson_iters").read(rec) == 12
    assert _reader("table_reuse").read(rec) == pytest.approx(80.0)
    for name in READERS:
        reader = _reader(name)
        assert "solve" in reader.SPANS
        assert reader.read({}) is None  # not traced
        assert reader.read(_record([{"cross_spin_launches": 1}])) is None  # no counter


def test_readers_name_counter_files():
    """Each counter a reader names has its file, in the existing form."""
    for name in READERS:
        assert getattr(_reader(name), "COUNTERS", ())
        for counter in _reader(name).COUNTERS:
            spec = harness.load_json(os.path.join(harness.HERE, "counters", counter + ".json"))
            assert set(spec) == {"module", "attr"}
            owner, attr = harness.resolve(spec["module"], spec["attr"])
            assert isinstance(getattr(owner, attr), int)


def test_readers_of_a_program_without_the_counters(monkeypatch):
    """On a version of the program without a counter (an earlier one), its
    reader names none and reads nothing: the traced run goes on without it."""
    from sqd_tpu_torch.ops import davidson
    from sqd_tpu_torch.ops.table_cache import TableCache

    monkeypatch.delattr(davidson.davidson_ground_state, "iterations")
    monkeypatch.delattr(TableCache, "rows_requested")
    assert program_trace.present("davidson_iterations", "cross_spin_launches",
                                 "table_rows_computed") == (
        "cross_spin_launches", "table_rows_computed")
    assert _reader("davidson_iters").COUNTERS == ()
    assert _reader("table_reuse").COUNTERS == ("table_rows_computed",)
    assert _reader("table_reuse").read(_record([{"table_rows_computed": 3}])) is None


def test_trace_program_on_a_tiny_cell(tiny_root):
    """The operator's script runs the tiny loop traced on the CPU: the run's
    metrics beside the program's spans, one ``sqd.solve`` per traced solve."""
    import torch

    from benchmark.trace_program import trace

    cell = harness.load_cell("tiny.loop", root=tiny_root)
    line = trace(cell, 2147483647 + 3, 1.0, torch.device("cpu"))
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert not any(name.startswith("sqd.") for name, _ in line["breakdown"]["device_ops"])
    spans = line["program"]["spans"]
    solves = sum(st["count"] for path, st in spans.items() if path.endswith("solve"))
    assert solves == len(line["program"]["matvec_kernel_spans_per_solve"]) > 0
    assert any(path.endswith("loop.iteration/solve/tables/tables.host") for path in spans)
    derived = line["derived"]
    assert 0 < derived["tables_host_s"] <= line["metrics"]["tables_s.loop"]["value"]
    assert derived["matvec_ms"] is None  # no card: no device events
    assert 0 < line["metrics"]["table_reuse.loop"]["value"] <= 100
    assert line["metrics"]["davidson_iters.loop"]["value"] >= 2
