"""Clock abstraction for the unified serving runtime.

The one event loop in ``repro_torch.serving.runtime.core`` is parameterized by
*where time comes from*:

* ``VirtualClock`` — discrete-event time.  The loop jumps the clock to the
  next interesting instant (arrival or batch completion); host scheduling
  cost is *charged* to the clock only when ``charge_overhead`` is set
  (paper Fig. 12/13 protocol, where scheduler wall time competes with the
  workload for the same timeline).
* ``WallClock`` — real time.  ``now`` reads ``time.perf_counter``; waiting
  is sleeping (capped so arrivals and deadline expiries are polled at the
  same granularity as the legacy engines); host cost charges itself by
  actually elapsing.
"""
from __future__ import annotations

import math
import time


class Clock:
    """Time source driving an :class:`~repro_torch.serving.runtime.core.EngineCore`.

    ``realtime`` distinguishes the two idle semantics: a virtual loop with
    nothing left to dispatch exits (remaining tasks drain at their
    deadlines), a wall-clock loop must keep polling until real deadlines
    expire.
    """

    realtime: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def advance_to(self, t: float) -> None:
        raise NotImplementedError

    def charge(self, dt: float) -> None:
        """Serialize `dt` seconds of host work onto this timeline."""
        raise NotImplementedError


class VirtualClock(Clock):
    realtime = False

    def __init__(self, charge_overhead: bool = False):
        self._now = 0.0
        self.charge_overhead = charge_overhead

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if math.isfinite(t):
            self._now = max(self._now, t)

    def charge(self, dt: float) -> None:
        if self.charge_overhead:
            self._now += dt


class WallClock(Clock):
    """Real time, started on first use.

    ``advance_to`` sleeps toward the target but never more than
    ``max_sleep`` at once — the loop re-polls arrivals and deadline
    expiries at the legacy engines' granularity (5 ms toward a known
    arrival, 0.5 ms when idling against deadline expiry).
    """

    realtime = True

    def __init__(self, max_sleep: float = 0.005):
        self.max_sleep = max_sleep
        self._t0 = None

    def start(self) -> None:
        if self._t0 is None:        # idempotent: a live Service starts the
            self._t0 = time.perf_counter()   # clock before the engine does

    def now(self) -> float:
        if self._t0 is None:
            self.start()
        return time.perf_counter() - self._t0

    def advance_to(self, t: float) -> None:
        if not math.isfinite(t):
            return
        time.sleep(max(0.0, min(t - self.now(), self.max_sleep)))

    def charge(self, dt: float) -> None:
        pass                     # real host work already elapsed on this clock
