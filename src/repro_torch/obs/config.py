"""Process-wide observability switch (torch port of ``repro.obs.config``).

``REPRO_OBS=0`` turns every instrumentation call in the runtime into a
near-zero-cost no-op (one cached function call, no allocation): span
context managers collapse to a shared singleton and ``names.metric``
returns a no-op metric.  Any other value (or unset) enables recording.
The switch silences recording only: no kernel launch and no result
changes with it.

The flag is read once and cached; tests flip it with :func:`set_enabled`
(``None`` re-reads the environment) instead of mutating ``os.environ``.
"""
from __future__ import annotations

import os

_FALSY = ("0", "false", "False", "no", "off")

_enabled = None


def enabled() -> bool:
    """True iff observability recording is on (cached REPRO_OBS probe)."""
    global _enabled
    if _enabled is None:
        env = os.environ.get("REPRO_OBS")
        _enabled = env is None or env not in _FALSY
    return _enabled


def set_enabled(value) -> None:
    """Force the switch (tests): True/False pins it, None re-reads env."""
    global _enabled
    _enabled = None if value is None else bool(value)
