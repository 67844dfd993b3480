# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Operator, solver and RDM layers of the PyTorch port."""
