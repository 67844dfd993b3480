# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The device rule of the port's entry points."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["checked_device", "device_label"]


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


def device_label(device) -> str:
    """What a printed time ran on: ``nvidia-smi``'s name and power limit of a
    card (``torch.cuda.get_device_name`` where ``nvidia-smi`` cannot answer),
    else the device's type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(index)
