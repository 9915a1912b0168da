"""One-shot deprecation warnings for the legacy serving entry points
(``repro.serving.deprecation``).

Each legacy face warns exactly once per process, pointing at the
``ServeSpec``/``Service`` front door, then stays silent — the shims are
called in tight loops by old benchmarks and tests.  Of the JAX package's
four faces the port has ``simulate`` so far; ``simulate_batched``,
``ServingEngine.run`` and ``BatchedServingEngine.run`` are ROADMAP Queue A
items 4 and 5.
"""
from __future__ import annotations

import warnings

_fired: set = set()


def deprecate_once(key: str, message: str, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` the first time ``key`` is seen."""
    if key in _fired:
        return
    _fired.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def _reset() -> None:
    """Forget fired keys (tests only)."""
    _fired.clear()
