"""Request sources: *where tasks come from* for the unified runtime.

* ``ClosedLoopSource`` — the paper's §IV workload: K closed-loop clients,
  each with one outstanding request; completing (or expiring, or being
  rejected) a request immediately reissues the next with a fresh relative
  deadline U[D_l, D_u] and the next sample of a seed-shuffled test set.
  This reproduces the legacy simulators' RNG draw order and event
  tie-breaking exactly (golden-parity tests hold the runtime to it).
* ``StreamSource`` — a pre-materialized ``(offset_seconds, Request)``
  stream for the wall-clock engines; a caller-supplied factory turns each
  Request into an admitted-shape ``Task`` (§II-B deadline adjustment lives
  in the engine, which knows its host overhead and batch pricing).
"""
from __future__ import annotations

import heapq
import math

import numpy as np

from repro_torch.core.task import Task


class RequestSource:
    def has_pending(self) -> bool:
        raise NotImplementedError

    def next_time(self) -> float:
        raise NotImplementedError

    def pop(self, now: float):
        """Materialize the earliest pending arrival (or None if the
        request budget is exhausted / the arrival produced no task)."""
        raise NotImplementedError

    def on_retire(self, task, now: float) -> None:
        """A task left the system (completed / expired / rejected)."""

    def qsize(self) -> int:
        """Arrivals still pending (metrics streaming / backpressure)."""
        return 0


class ClosedLoopSource(RequestSource):
    def __init__(self, workload, n_samples: int, stage_times):
        self.workload = workload
        self.stage_times = tuple(float(x) for x in stage_times)
        rng = np.random.default_rng(workload.seed)
        self.sample_order = rng.permutation(n_samples)
        self.rng = rng
        self.n_samples = n_samples
        self.issued = 0
        self.events = []             # (time, tiebreak, client)
        for c in range(workload.n_clients):
            t0 = float(rng.uniform(0, workload.d_lo))
            heapq.heappush(self.events, (t0, c, c))

    def has_pending(self) -> bool:
        return bool(self.events)

    def next_time(self) -> float:
        return self.events[0][0] if self.events else math.inf

    def pop(self, now: float):
        _, _, client = heapq.heappop(self.events)
        wl = self.workload
        if self.issued >= wl.n_requests:
            return None
        rel = self.rng.uniform(wl.d_lo, wl.d_hi)
        t = Task(arrival=now, deadline=now + rel, stage_times=self.stage_times,
                 mandatory=wl.mandatory_stages,
                 sample=int(self.sample_order[self.issued % self.n_samples]),
                 client=client)
        self.issued += 1
        return t

    def on_retire(self, task, now: float) -> None:
        # closed loop: the client reissues at *completion* time — a request
        # that finishes early frees its client immediately (an expired one
        # retires at its deadline, so `now` is correct in both cases)
        heapq.heappush(self.events, (now, -task.tid, task.client))

    def qsize(self) -> int:
        return len(self.events)


class StreamSource(RequestSource):
    def __init__(self, stream, task_factory):
        """``stream``: iterable of (offset_seconds, Request); ``task_factory``
        maps (request, now) -> Task (already registered with the executor).

        The stream is sorted by offset on construction (stable, so
        same-offset requests keep their input order) — callers may hand
        arrivals in any order without silently mis-ordering admissions
        (property-tested with shuffled offsets in tests/test_traffic.py).
        """
        self.pending = sorted(list(stream), key=lambda p: p[0])
        self.task_factory = task_factory
        self.i = 0

    def has_pending(self) -> bool:
        return self.i < len(self.pending)

    def next_time(self) -> float:
        return self.pending[self.i][0] if self.has_pending() else math.inf

    def pop(self, now: float):
        off, req = self.pending[self.i]
        self.i += 1
        req.arrival = off
        return self.task_factory(req, now)

    def qsize(self) -> int:
        return len(self.pending) - self.i
