# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Deprecation decorator with qiskit's ``deprecate_func`` message shape.

A copy of ``sqd_tpu.utils.deprecation``: a plain ``DeprecationWarning`` on
every call of the decorated function.
"""

from __future__ import annotations

import functools
import warnings

__all__ = ["deprecate_func"]


def deprecate_func(
    *,
    since: str,
    package_name: str,
    removal_timeline: str = "in a future release",
    additional_msg: str | None = None,
):
    """Decorate a function to emit a ``DeprecationWarning`` on every call."""

    def decorator(func):
        msg = (
            f"The function ``{func.__module__}.{func.__qualname__}()`` is "
            f"deprecated as of {package_name} {since}. It will be removed "
            f"{removal_timeline}."
        )
        if additional_msg:
            msg += f" {additional_msg}"

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, category=DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        wrapper.__doc__ = (func.__doc__ or "") + f"\n\n.. deprecated:: {since}\n   {msg}\n"
        return wrapper

    return decorator
