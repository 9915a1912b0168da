"""Overload control: bounded intake backpressure + streamed metrics
(``repro.serving.traffic.control``).

**Backpressure** (enforced by ``Service.submit`` — config lives in
``spec.source_args`` for ``source="live"``)::

    {"bound": 32, "overflow": "reject" | "shed-optional"}

* ``bound`` — max pending intake (queued, not yet admitted by the
  engine).  Below it, submissions flow untouched.
* ``"reject"`` — an over-bound ``submit()`` returns an *immediately
  resolved* rejected ``ResponseHandle`` (fail fast: the caller can retry
  elsewhere); the request never reaches the engine.  Counted in
  ``ServiceMetrics.rejected`` and the per-class ``rejected`` breakdown.
* ``"shed-optional"`` — the request is admitted but its depth is pinned
  to the mandatory part through the admission-control channel
  (``Task.depth_cap``, which every policy's depth assignment clamps
  against): under pressure the queue sheds *optional* work instead of
  whole requests — the imprecise-computation answer to overload.
  Counted in ``ServiceMetrics.capped``.

**Metrics streaming**: a :class:`MetricsStreamer` turns retirements into
periodic :class:`ServiceSnapshot` rows — *windowed* miss rate, accuracy,
mean depth, queue depth, utilization — delivered to a callback, so
scenarios can assert on transient behavior (the flash-crowd spike, the
recovery after it) instead of end-of-run aggregates only.  Enable with
``ServeSpec(metrics_interval=0.5)`` + an ``on_metrics`` callable
resource.  Snapshots are emitted as serving events cross interval
boundaries (event-driven, so a virtual clock streams them too).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.service import \
    _OVERFLOW_MODES as OVERFLOW_MODES  # noqa: F401 — public re-export


@dataclasses.dataclass(frozen=True)
class ServiceSnapshot:
    """One streamed metrics window ``(t - interval, t]``."""

    t: float                    # service time at emission
    n: int                      # requests retired in the window
    miss_rate: float            # misses / n (rejected count as misses)
    accuracy: Optional[float]   # oracle-table runs only, else None
    mean_depth: float           # over non-missed retirements
    queue_depth: int            # source arrivals still pending
    active: int                 # tasks currently in the engine
    utilization: float          # device-busy fraction of the window
    rejected: int               # admission + backpressure rejects
    capped: int                 # depth-capped (incl. shed-optional)
    # pending-but-not-admitted intake: source queue + the facade's
    # virtual-clock submit buffer (uniform across sources)
    intake_depth: int = 0
    # tenant -> {"queued": source backlog, "n": retired this window}
    # (the multi-tenant front door, ROADMAP Queue A item 9b: empty here)
    per_tenant: dict = dataclasses.field(default_factory=dict)
    # device-executor telemetry (zero for modeled executors): host/device
    # seconds spent this window and hidden-state-cache residents now
    host_time: float = 0.0
    device_time: float = 0.0
    cache_live: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MetricsStreamer:
    """Windowed snapshot emitter driven by recorder events.

    ``observe(record, now)`` is called per retirement, ``tick(now)`` on
    any other serving event; whenever ``now`` crosses the next interval
    boundary the window is aggregated, handed to ``callback``, and reset.
    """

    def __init__(self, interval: float, callback):
        if interval <= 0:
            raise ValueError("metrics_interval must be > 0")
        self.interval = float(interval)
        self.callback = callback
        self.snapshots: list = []
        self._window: list = []
        self._next_t = self.interval
        self._last_t = 0.0
        self._last_busy = 0.0
        self._last_host = 0.0
        self._last_dev = 0.0
        self._last_rejected = 0
        self._last_capped = 0
        # bound by ServiceRecorder once the engine exists
        self.core = None
        self.source = None
        self.inner = None           # TableRecorder when oracle-backed
        self.service = None         # backpressure counters live here

    def bind(self, core, source, inner, service=None) -> None:
        self.core = core
        self.source = source
        self.inner = inner
        self.service = service

    # ------------------------------------------------------------------
    def observe(self, record: dict, now: float) -> None:
        self._window.append(record)
        self.tick(now)

    def tick(self, now: float) -> None:
        if now >= self._next_t:
            self._emit(now)

    def flush(self, now: float) -> None:
        """End of run: emit whatever the last partial window holds."""
        if self._window or now > self._last_t:
            self._emit(now)

    # ------------------------------------------------------------------
    def _counts(self) -> tuple:
        # with the obs layer on, its registry is the single accumulation
        # point (admission rejects/caps + intake rejects/sheds land there
        # as they happen) — read it instead of re-deriving the split
        tracer = getattr(self.core, "tracer", None) if self.core else None
        reg = tracer.registry if tracer is not None else None
        if reg is not None:
            return (int(reg.counter("requests_rejected").value),
                    int(reg.counter("requests_capped").value))
        adm = getattr(self.core, "admission", None) if self.core else None
        rejected = adm.rejected if adm is not None else 0
        capped = adm.capped if adm is not None else 0
        if self.service is not None:
            rejected += self.service._n_bp_rejected
            capped += self.service._n_shed
        return rejected, capped

    def _emit(self, now: float) -> None:
        w = self._window
        n = len(w)
        missed = sum(1 for r in w if r["missed"])
        ok = [r for r in w if not r["missed"]]
        acc = None
        if self.inner is not None and hasattr(self.inner, "finished"):
            tids = {r["tid"] for r in w}
            fin = [f for f in self.inner.finished if f["tid"] in tids]
            if fin:
                acc = sum(f["correct"] for f in fin) / len(fin)
        ex = self.core.executor if self.core is not None else None
        busy = getattr(ex, "total_busy", 0.0)
        dts = getattr(ex, "device_time_stats", None)
        times = dts() if dts is not None else {}
        host_t = float(times.get("host_time", 0.0))
        dev_t = float(times.get("device_time", 0.0))
        cst = getattr(ex, "cache_stats", None)
        span = max(now - self._last_t, 1e-12)
        rejected, capped = self._counts()
        qsize = self.source.qsize() if self.source is not None else 0
        intake = qsize
        if self.service is not None:
            intake += len(self.service._buffer)
        per_tenant: dict = {}
        if self.source is not None and hasattr(self.source, "tenant_depths"):
            for t, d in self.source.tenant_depths().items():
                per_tenant[t] = dict(queued=d, n=0)
        for r in w:
            if r.get("tenant") is not None:
                entry = per_tenant.setdefault(r["tenant"],
                                              dict(queued=0, n=0))
                entry["n"] += 1
        snap = ServiceSnapshot(
            t=now, n=n, miss_rate=(missed / n) if n else 0.0, accuracy=acc,
            mean_depth=(sum(r["depth"] for r in ok) / len(ok)) if ok else 0.0,
            queue_depth=qsize,
            active=len(self.core._active) if self.core is not None else 0,
            utilization=min(1.0, (busy - self._last_busy) / span),
            rejected=rejected - self._last_rejected,
            capped=capped - self._last_capped,
            intake_depth=intake, per_tenant=per_tenant,
            host_time=host_t - self._last_host,
            device_time=dev_t - self._last_dev,
            cache_live=int(cst()["live"]) if cst is not None else 0)
        self.snapshots.append(snap)
        if self.callback is not None:
            self.callback(snap)
        self._window = []
        self._last_t = now
        self._last_busy = busy
        self._last_host, self._last_dev = host_t, dev_t
        self._last_rejected, self._last_capped = rejected, capped
        while self._next_t <= now:
            self._next_t += self.interval
