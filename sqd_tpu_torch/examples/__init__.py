# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The guide examples on the port: ``NN_*.py`` are the counterparts of the
repository's ``examples/NN_*.py`` under the same file names.

Each imports ``sqd_tpu_torch``, NumPy and torch only, prints the same lines
in the same order as its ``sqd_tpu`` counterpart and keeps its asserts.
Each has ``main(..., device="cuda")``: run one on the card from a checkout
with ``python3 sqd_tpu_torch/examples/01_quickstart.py``, or call
``main(device="cpu")`` (there is no CPU fallback: with no card, the default
device raises).  The file names start with digits, so load one by path
(:func:`records.load_example`).  :mod:`records` holds their printed lines
against ``sqd_tpu``'s record (``sqd_tpu_torch/data/example_records.json``).
"""
