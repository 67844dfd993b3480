"""Milliseconds per application of the exact operator outside the f32 kernel
route (``SCIHamiltonian._matvec_full`` and ``._matvec_blocked``: the f64
refinement's and the energy's), each call synchronised on both sides."""

SPANS = ("f64_matvec",)


def read(record):
    calls = record.get("calls", {}).get("f64_matvec")
    return 1e3 * sum(c["seconds"] for c in calls) / len(calls) if calls else None
