# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Compile a C++ or CUDA source into a shared library at first use.

Outputs go to ``sqd_tpu_torch/_build/`` (git-ignored), named by a hash of the
source text and the compiler command, so an edited source or flag builds
anew and an unchanged one loads the library already built.  Several
processes may build at once: each compiles into its own temporary file and
renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

build_seconds: dict[str, float] = {}
"""Seconds each library took to build and load in this process."""


def load_library(name: str, source: str, command: list[str]) -> ctypes.CDLL:
    """Build ``source`` with ``command`` unless already built, and load it.

    ``command`` is the compiler invocation without the source and output
    paths, e.g. ``["g++", "-O3", "-shared", "-fPIC"]``.  Raises
    ``RuntimeError`` with the compiler's output if the build fails.  Callers
    cache the returned library.
    """
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(command).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [*command, source, "-o", tmp], capture_output=True, text=True, timeout=600
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({' '.join(command)}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(path)
    build_seconds[name] = time.perf_counter() - t0
    return lib
