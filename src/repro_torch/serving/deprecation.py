"""One-shot deprecation warnings for the legacy serving entry points
(``repro.serving.deprecation``).

Each legacy face (``simulate``, ``simulate_batched``, ``ServingEngine.run``,
``BatchedServingEngine.run``) warns exactly once per process, pointing at
the ``ServeSpec``/``Service`` front door, then stays silent — the shims are
called in tight loops by old benchmarks and tests.
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
