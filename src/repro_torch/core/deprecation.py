"""Once-per-process ``DeprecationWarning`` for the legacy run shims.

``core.dsba.run`` and ``core.baselines.run_*`` are deprecated delegates to
``core.solvers.solve``. Each shim warns exactly once per process (keyed by
shim name), with ``stacklevel`` resolved so the warning points at the
*caller's* line, not at the shim internals.

``reset()`` clears the seen-set so tests can assert the warning fires.
"""
from __future__ import annotations

import warnings

_SEEN: set[str] = set()


def warn_once(key: str, message: str, *, stacklevel: int = 2) -> None:
    """Emit ``DeprecationWarning`` for ``key`` at most once per process.

    stacklevel counts from the *caller of this function*: 2 (the default)
    attributes the warning to the caller of the function that called
    ``warn_once`` — i.e. the user code invoking a deprecated shim directly.
    Shims wrapping the warn in an extra helper frame add 1 per frame.
    """
    if key in _SEEN:
        return
    _SEEN.add(key)
    # +1 for this frame: the requested level is relative to our caller.
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel + 1)


def reset() -> None:
    """Forget every emitted warning (test isolation)."""
    _SEEN.clear()
