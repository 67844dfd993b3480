# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Record what ``sqd_tpu``'s sixteen examples print, for their ports.

Runs each ``examples/NN_*.py`` on the CPU (JAX on 8 virtual CPU devices, as
the root ``conftest.py`` sets them) at every size of
``sqd_tpu_torch.examples.records.SIZES``: the guide's own (the size the card
runs) and, for ``07`` and ``14``, the smaller size of the CPU tests.  Writes
``sqd_tpu_torch/data/example_records.json``: for each example and size the
calls made and the printed lines (``records.load_records`` marks each with
its kind: ``exact``, ``loop``, ``time``, ``device`` or ``path``).  Run
from the repository root (a few minutes; ``07`` at its guide size projects
5·10⁶ strings)::

    python tools/make_example_records.py [NAME ...]

Names (``01_quickstart`` ...) rerun those examples alone and keep the other
records.  Rerun an example's record when the ``sqd_tpu`` example changes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(names: list[str]) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sqd_tpu_torch.examples import records

    out = {}
    if names and os.path.exists(records.RECORDS_PATH):
        with open(records.RECORDS_PATH) as f:
            out = json.load(f)
    for name in names or records.EXAMPLES:
        module = records.load_example(name, os.path.join(ROOT, "examples"))
        out[name] = {}
        for size, calls in records.SIZES[name].items():
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                cwd = os.getcwd()
                os.chdir(tmp)  # the examples that write files write them here
                try:
                    lines, _ = records.run_calls(module, calls)
                finally:
                    os.chdir(cwd)
            out[name][size] = {"calls": calls, "lines": lines}
            print(f"{name} [{size}]: {len(lines)} lines in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    out = {name: out[name] for name in records.EXAMPLES if name in out}
    with open(records.RECORDS_PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {records.RECORDS_PATH}")


if __name__ == "__main__":
    main(sys.argv[1:])
