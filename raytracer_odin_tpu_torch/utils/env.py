"""The JAX package's environment overrides, read under their own names.

Each knob is an integer the JAX package reads with int(os.environ.get(...)).
The port reads the same variable at the same moment (at import, at scene
build or at call, as the JAX package does) and either honours the value or
raises ValueError naming the variable and the values it takes: on every
device, so that the CPU and the card accept the same settings.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int, ok, takes: str) -> int:
    """The integer value of environment variable `name` (`default` when it
    is unset or empty); ValueError naming it and `takes` when the value is
    not an integer or `ok(value)` is false."""
    raw = os.environ.get(name, "")
    if raw.strip() == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        value = None
    if value is None or not ok(value):
        raise ValueError(f"{name}={raw!r} is not honoured: it takes {takes}")
    return value
