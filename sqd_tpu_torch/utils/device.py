# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The device rule of the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["checked_device"]


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device
