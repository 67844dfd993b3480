"""The traced run's instruments: spans around the program's calls, its
counters, and ``torch.profiler`` over the window.

A span wraps every function its file under ``benchmark/spans/`` names; the
wrapper synchronises the card before and after, so its seconds are the
call's on the host clock with the device work it enqueued, and opens a
``torch.profiler.record_function`` range ``bench.<span>`` so that the
profiler's idle gaps can be told by what the host was doing.  Each call is
recorded with its seconds, the change of every counter under
``benchmark/counters/`` across it and, where the span asks for it, its first
argument.  The profiler's events stay in memory; :func:`summarize` reduces
its raw (Kineto) events to what the metrics and the result's ``breakdown``
read, without building the profiler's Python event tree, which takes
minutes for a window of a million events.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.harness import resolve, synchronize

NAME_CHARS = 120  # kernel names are cut to this length in the breakdown


class Probe:
    def __init__(self, device, spans: dict, counters: dict):
        self.device = device
        self.spans = spans
        self.calls: dict[str, list] = {name: [] for name in spans}
        self._originals: list = []
        self._counter_refs = {name: resolve(c["module"], c["attr"]) for name, c in counters.items()}
        self.profiler = None

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function("bench." + name):
            yield

    def _counts(self) -> dict:
        return {name: getattr(owner, attr) for name, (owner, attr) in self._counter_refs.items()}

    def _wrap(self, span: str, spec: dict, owner, name: str):
        fn = getattr(owner, name)
        keep_arg = bool(spec.get("keep_first_arg"))
        calls = self.calls[span]

        def wrapper(*args, **kwargs):
            synchronize(self.device)
            before = self._counts()
            t0 = time.perf_counter()
            with self.span(span):
                out = fn(*args, **kwargs)
                synchronize(self.device)
            seconds = time.perf_counter() - t0
            after = self._counts()
            call = {"seconds": seconds,
                    "counters": {k: after[k] - before[k] for k in after}}
            if keep_arg:
                call["arg0"] = args[0]
            calls.append(call)
            return out

        self._originals.append((owner, name, fn))
        setattr(owner, name, wrapper)

    def __enter__(self):
        for span, spec in self.spans.items():
            for module, attr in spec["targets"]:
                owner, name = resolve(module, attr)
                self._wrap(span, spec, owner, name)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.start()
        return self

    def __exit__(self, *exc):
        self.profiler.stop()
        for owner, name, fn in reversed(self._originals):
            setattr(owner, name, fn)
        self._originals.clear()
        return False


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _innermost(spans, w0, w1):
    """The window cut into segments, each labelled by the innermost span open
    in it (spans of one thread nest), or ``window`` outside every span."""
    events = sorted([(s, 1, k) for k, (s, _, _) in enumerate(spans)]
                    + [(e, 0, k) for k, (_, e, _) in enumerate(spans)])
    stack, out, t = [], [], w0
    for time_ns, starts, k in events:
        time_ns = min(max(time_ns, w0), w1)
        if time_ns > t:
            out.append((t, time_ns, spans[stack[-1]][2] if stack else "window"))
            t = time_ns
        if starts:
            stack.append(k)
        else:
            stack.remove(k)
    if t < w1:
        out.append((t, w1, "window"))
    return out


def summarize(profiler) -> dict:
    """Busy seconds, the traced window, device seconds by kernel name and
    idle seconds by the innermost span the host was in."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in profiler.profiler.kineto_results.events():
        name, kind = e.name(), e.device_type()
        if name.startswith("bench."):
            if kind == DeviceType.CPU:
                spans.append((e.start_ns(), e.end_ns(), name[len("bench."):]))
        elif kind == DeviceType.CUDA and e.end_ns() > e.start_ns():
            device.append((e.start_ns(), e.end_ns(), name))
    windows = [s for s in spans if s[2] == "window"]
    if not windows:
        return {}
    w0, w1 = windows[0][0], windows[0][1]
    kernels: dict[str, float] = {}
    for start, end, name in device:
        kernels[name] = kernels.get(name, 0.0) + (end - start) * 1e-9
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # the idle gaps inside the window, split over the innermost span the
    # host was in at each instant
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    segments = _innermost(sorted(s for s in spans if s[2] != "window"), w0, w1)
    i = 0
    for g0, g1 in gaps:
        while i < len(segments) and segments[i][1] <= g0:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < g1:
            s0, s1, label = segments[j]
            overlap = min(s1, g1) - max(s0, g0)
            if overlap > 0:
                idle[label] = idle.get(label, 0.0) + overlap * 1e-9
            j += 1
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": kernels,
        "idle_by_span": idle,
        "breakdown": {
            "device_ops": [[name[:NAME_CHARS], s] for name, s in top_ops],
            "idle_gaps": [[name, s] for name, s in top_idle],
        },
    }
