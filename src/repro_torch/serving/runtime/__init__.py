"""Unified event-driven serving runtime (``repro.serving.runtime``).

``EngineCore`` is the one implementation of the paper's user-space
scheduling loop — admit → expire → dispatch → observe → retire, §II-B
deadline semantics, admission control and result aggregation — over a
``Clock`` (virtual or wall), an ``Executor`` (``OracleExecutor`` over
confidence tables, or ``DeviceExecutor`` in ``device.py`` on the GPU) and
a ``RequestSource`` (closed-loop clients or a request stream).
Everything imported here is numpy-only.
"""
from repro_torch.serving.runtime.clock import Clock, VirtualClock, WallClock
from repro_torch.serving.runtime.core import (EngineCore, ResponseRecorder,
                                              TableRecorder, simulate_runtime)
from repro_torch.serving.runtime.executor import Executor, OracleExecutor
from repro_torch.serving.runtime.sources import (ClosedLoopSource,
                                                 RequestSource, StreamSource)

__all__ = [
    "Clock", "ClosedLoopSource", "EngineCore", "Executor", "OracleExecutor",
    "RequestSource", "ResponseRecorder", "StreamSource", "TableRecorder",
    "VirtualClock", "WallClock", "simulate_runtime",
]
