"""The program's own spans in a traced run: the ``sqd.*`` ranges that
``sqd_tpu_torch.utils.tracing.span`` opens, on the profiler's clock, and the
program's counters.

:func:`program_events` takes three lists from the profiler's raw (Kineto)
events and :func:`summarize_program` reduces them:

* ``spans``: ``(start_ns, end_ns, name, thread)`` of each ``sqd.*`` range,
  the prefix dropped; ranges of one thread nest, and a span's path is its
  ancestors' names and its own joined by ``/`` (``solve/tables/tables.host``);
* ``launches``: ``(start_ns, correlation_id, thread)`` of each CUDA runtime
  or driver call on the host (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...);
* ``device``: ``(start_ns, end_ns, correlation_id)`` of each kernel, copy and
  fill on the card.

A device event is matched to the runtime call that issued it by its
correlation id, and put down to the innermost span open on the calling
thread at that call (``outside`` when none was); an event no call matches
is ``unattributed``.  The card's idle gaps inside the window are put down to
the innermost span the host thread was in.  ``probe.summarize`` does not
read these ranges; ``benchmark/trace_program.py`` prints the summary and the
quantities below it beside a traced run's result.  The counter readers
(``table_reuse``, ``davidson_iters``) read the counters' changes across each
``solve_sci`` call from the run's record.
"""

from __future__ import annotations

import bisect
import os

from benchmark import harness
from benchmark.probe import _merge

OUTSIDE = "outside"
UNATTRIBUTED = "unattributed"
# the operator's routes: one span per application (matvec.samespin nests in
# matvec.kernel and is not an application of its own)
MATVEC_ROUTES = ("matvec.kernel", "matvec.full", "matvec.blocked", "matvec.dense_df")


def _walk(spans):
    """Each span of one thread with its path and its children's total, and
    the thread's time cut into ``(start, end, path)`` segments by the
    innermost span open (``None`` where none is)."""
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, out, segments = [], [], []
    t = None

    def cut(until):
        nonlocal t
        if t is not None and until > t:
            segments.append((t, until, stack[-1]["path"] if stack else None))
        t = until

    for start, end, name, _ in ordered:
        while stack and stack[-1]["end"] <= start:
            cut(stack[-1]["end"])
            stack.pop()
        cut(start)
        node = {"start": start, "end": end, "name": name, "child_ns": 0,
                "path": (stack[-1]["path"] + "/" if stack else "") + name,
                "parent": stack[-1] if stack else None}
        if stack:
            stack[-1]["child_ns"] += end - start
        stack.append(node)
        out.append(node)
    while stack:
        cut(stack[-1]["end"])
        stack.pop()
    return out, segments


def _locate(segments, starts, time_ns):
    """The path of the segment holding ``time_ns`` (``None`` outside all)."""
    i = bisect.bisect_right(starts, time_ns) - 1
    if i >= 0 and segments[i][0] <= time_ns < segments[i][1]:
        return segments[i][2]
    return None


def program_events(profiler):
    """``(spans, launches, device, w0, w1)`` for :func:`summarize_program`
    from a stopped ``torch.profiler.profile`` whose window is the harness's
    ``bench.window`` range; ``None`` without that range."""
    from torch.autograd import DeviceType

    spans, launches, device, windows = [], [], [], []
    for e in profiler.profiler.kineto_results.events():
        name, kind = e.name(), e.device_type()
        if kind == DeviceType.CPU:
            if name.startswith("sqd."):
                spans.append((e.start_ns(), e.end_ns(), name[len("sqd."):],
                              e.start_thread_id()))
            elif name == "bench.window":
                windows.append((e.start_ns(), e.end_ns()))
            elif name.startswith("cu"):
                # a CUDA runtime or driver call: cudaLaunchKernel,
                # cuLaunchKernel, cudaMemcpyAsync, ...
                launches.append((e.start_ns(), e.correlation_id(), e.start_thread_id()))
        elif (kind == DeviceType.CUDA and e.end_ns() > e.start_ns()
              and not name.startswith(("sqd.", "bench."))):
            device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
    if not windows:
        return None
    return spans, launches, device, windows[0][0], windows[0][1]


def summarize_program(spans, launches, device, w0: int, w1: int) -> dict:
    """Span counts and seconds, device and idle seconds by innermost span,
    over the window ``[w0, w1]`` (ns); see the module docstring."""
    spans = [s for s in spans if s[1] > w0 and s[0] < w1]
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(s)
    nodes, segments_of = [], {}
    for thread, own in by_thread.items():
        walked, segments = _walk(own)
        nodes += walked
        segments_of[thread] = (segments, [seg[0] for seg in segments])

    stats: dict[str, dict] = {}
    for node in nodes:
        st = stats.setdefault(node["path"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
        st["count"] += 1
        st["total_s"] += (node["end"] - node["start"]) * 1e-9
        st["self_s"] += (node["end"] - node["start"] - node["child_ns"]) * 1e-9

    # where each device event was issued from
    issued = {}
    for start, corr, thread in launches:
        where = segments_of.get(thread)
        issued[corr] = (_locate(*where, start) if where else None) or OUTSIDE
    device_s: dict[str, float] = {}
    inside = [(max(s, w0), min(e, w1), c) for s, e, c in device if e > w0 and s < w1]
    for start, end, corr in inside:
        key = issued.get(corr, UNATTRIBUTED)
        device_s[key] = device_s.get(key, 0.0) + (end - start) * 1e-9

    # the card's idle gaps, by the innermost span of the host thread (the one
    # whose spans cover the most time)
    idle_s: dict[str, float] = {}
    if by_thread:
        host = max(by_thread, key=lambda th: sum(e - s for s, e, _, _ in by_thread[th]))
        segments = segments_of[host][0]
        busy = _merge([(s, e) for s, e, _ in inside])
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
        i = 0
        for g0, g1 in gaps:
            while i < len(segments) and segments[i][1] <= g0:
                i += 1
            j = i
            while j < len(segments) and segments[j][0] < g1:
                s0, s1, path = segments[j]
                overlap = min(s1, g1) - max(s0, g0)
                if overlap > 0 and path is not None:
                    idle_s[path] = idle_s.get(path, 0.0) + overlap * 1e-9
                j += 1

    # matvec.kernel spans inside each solve, in the order of the solves
    kernel_spans = []
    for node in nodes:
        if node["name"] == "solve":
            kernel_spans.append(0)
            node["solve_index"] = len(kernel_spans) - 1
    for node in nodes:
        if node["name"] == "matvec.kernel":
            up = node["parent"]
            while up is not None and up["name"] != "solve":
                up = up["parent"]
            if up is not None:
                kernel_spans[up["solve_index"]] += 1
    return {"spans": stats, "device_s": device_s, "idle_s": idle_s,
            "matvec_kernel_spans_per_solve": kernel_spans}


# ---------------------------------------------------------------------------
# quantities of one summary; each is None where the run has nothing to read
# ---------------------------------------------------------------------------


def _has(path: str, name: str) -> bool:
    return name in path.split("/")


def _last(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def _solves(program) -> int:
    return sum(st["count"] for path, st in program["spans"].items() if _last(path) == "solve")


def span_seconds_per_solve(program, name: str):
    """Seconds in the spans named ``name`` (on the profiler's clock) over the
    window's ``sqd.solve`` spans."""
    totals = [st["total_s"] for path, st in program["spans"].items() if _last(path) == name]
    solves = _solves(program)
    return sum(totals) / solves if totals and solves else None


def device_seconds_per_solve(program, name: str):
    """Device seconds of what was launched inside the spans named ``name``
    (their nested spans included) over the window's ``sqd.solve`` spans."""
    if not program["device_s"] or not any(_has(p, name) for p in program["spans"]):
        return None
    solves = _solves(program)
    seconds = sum(s for path, s in program["device_s"].items() if _has(path, name))
    return seconds / solves if solves else None


def matvec_ms(program):
    """Device milliseconds per operator application inside
    ``sqd.davidson.solver``: what the ``sqd.matvec.*`` spans there launched,
    over the number of those applications."""
    count = sum(st["count"] for path, st in program["spans"].items()
                if _has(path, "davidson.solver") and _last(path) in MATVEC_ROUTES)
    if not count or not program["device_s"]:
        return None
    seconds = sum(s for path, s in program["device_s"].items()
                  if _has(path, "davidson.solver")
                  and any(_has(path, route) for route in MATVEC_ROUTES))
    return 1e3 * seconds / count


def solver_idle(program):
    """The share of the ``sqd.davidson.*`` spans' time with nothing running
    on the card, in percent."""
    stages = ("davidson.solver", "davidson.refine")
    total = sum(st["total_s"] for path, st in program["spans"].items() if _last(path) in stages)
    if total <= 0 or not program["device_s"]:
        return None
    idle = sum(s for path, s in program["idle_s"].items()
               if any(_has(path, stage) for stage in stages))
    return 100.0 * idle / total


def unattributed_share(program):
    """Device time no runtime call matched, in percent of the device time
    issued inside ``sqd.solve`` spans and of that unmatched time."""
    lost = program["device_s"].get(UNATTRIBUTED, 0.0)
    solve = sum(s for path, s in program["device_s"].items() if _has(path, "solve"))
    return 100.0 * lost / (solve + lost) if solve + lost > 0 else None


# ---------------------------------------------------------------------------
# the counter readers' share; each returns None where there is nothing to read
# ---------------------------------------------------------------------------


def present(*counters: str) -> tuple:
    """The named counters (``benchmark/counters/<name>.json``) that the
    program has: a reader names only these, so that a version of the program
    without one gives the reader nothing to read instead of failing."""
    out = []
    for name in counters:
        spec = harness.load_json(os.path.join(harness.HERE, "counters", name + ".json"))
        try:
            owner, attr = harness.resolve(spec["module"], spec["attr"])
        except (ImportError, AttributeError):
            continue
        if hasattr(owner, attr):
            out.append(name)
    return tuple(out)


def counter_per_solve(record, counter: str):
    """A counter's change summed over the window's ``solve_sci`` calls, over
    those calls."""
    solves = record.get("calls", {}).get("solve", [])
    deltas = [c["counters"][counter] for c in solves if counter in c["counters"]]
    return sum(deltas) / len(solves) if deltas else None


def table_reuse(record):
    """``100 (1 - rows computed / rows requested)`` of the ``TableCache``
    over the window's solves; ``None`` where no row was requested."""
    solves = record.get("calls", {}).get("solve", [])
    requested = sum(c["counters"].get("table_rows_requested", 0) for c in solves)
    computed = sum(c["counters"].get("table_rows_computed", 0) for c in solves)
    if not requested:
        return None
    return 100.0 * (1.0 - computed / requested)
