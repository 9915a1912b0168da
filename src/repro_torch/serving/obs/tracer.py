"""Per-request span tracing + scheduler decision audit log
(``repro.serving.obs.tracer``).

The :class:`Tracer` is the one observability hook threaded through the
serving stack (``EngineCore``, the executors via window close events,
``AdmissionController`` via decision details, ``Service`` via intake
audit rows).  It is **passive**: every hook only appends to
Python lists using timestamps the engine already computed, so a traced
run schedules bit-for-bit identically to an untraced one on the virtual
clock — the engine never charges host time for tracing and the tracer
never reads the clock itself.

It is also cheap enough to leave on under load: hot-path hooks only
append scalars to per-request accumulator lists; :class:`RequestTrace`
objects (typed spans, sorted) are materialised lazily, on first access
to ``traces``/``trace()`` — after the run, off the timed path.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry

__all__ = ["Span", "RequestTrace", "Tracer", "TRACE_KEYS"]

# allowed keys of the ``ServeSpec.trace`` dict
TRACE_KEYS = ("enabled", "spans", "audit", "metrics", "export", "chrome")

# chronological tie-break priority for spans sharing a timestamp
_SPAN_ORDER = {"queued": 0, "admitted": 1, "batched": 2, "dispatch": 3,
               "device-window": 4, "stage-exit": 5, "retire": 6,
               "expire": 6}

# per-request accumulator slots (a list, not a dict — hot path)
_T_ADMIT, _T_FIRST, _DEV, _BATCHES, _WINDOWS, _EXITS, _DECISION, _DETAIL \
    = range(8)


def _new_entry(t_admit: float) -> list:
    return [t_admit, None, 0.0, [], [], [], None, None]


class Span:
    """One typed interval (or instant, ``t0 == t1``) of a request's life."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.attrs = attrs or {}

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, {self.t0:.4f}..{self.t1:.4f})"


class RequestTrace:
    """Everything observed about one request through the Fig. 2 loop."""

    __slots__ = ("tid", "request_id", "tenant", "slo", "model", "decision",
                 "depth_cap", "latency", "depth", "missed", "rejected",
                 "queue_wait", "host_time", "device_time", "spans")

    def __init__(self, tid: int, spans: List[Span], **meta: Any):
        self.tid = tid
        self.spans = spans
        for k in ("request_id", "tenant", "slo", "model", "decision",
                  "depth_cap", "latency", "depth", "missed", "rejected",
                  "queue_wait", "host_time", "device_time"):
            setattr(self, k, meta.get(k))

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"tid": self.tid}
        for k in ("request_id", "tenant", "slo", "model", "decision",
                  "depth_cap", "latency", "depth", "missed", "rejected",
                  "queue_wait", "host_time", "device_time"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        d["spans"] = [s.to_dict() for s in self.spans]
        return d


class Tracer:
    """Low-overhead observability recorder (see module docstring).

    Built by ``Service`` from the ``ServeSpec.trace`` dict; reachable on a
    finished service as ``service.obs``.  ``spans``/``audit``/``metrics``
    toggles gate the three recording planes independently; ``export`` /
    ``chrome`` are file paths written when the run finishes.
    """

    def __init__(self, *, spans: bool = True, audit: bool = True,
                 metrics: bool = True, export: Optional[str] = None,
                 chrome: Optional[str] = None):
        self.spans_on = bool(spans)
        self.audit_on = bool(audit)
        self.registry = MetricsRegistry.serving_default() if metrics else None
        self.export_path = export
        self.chrome_path = chrome
        self.time_model = None          # set by Service._build when known
        # live per-request accumulators, keyed by task tid (see slot
        # constants above)
        self._req: Dict[int, list] = {}
        self._open: deque = deque()     # in-flight device windows
        self.windows: List[dict] = []   # closed device windows
        self.audit_log: List[dict] = []
        # retired requests: raw (entry, outcome) tuples, materialised into
        # RequestTrace objects lazily by the ``traces`` property
        self._done: Dict[int, tuple] = {}
        self._traces: Dict[int, RequestTrace] = {}
        self._by_rid: Dict[str, int] = {}
        self._buckets_cache: Dict[int, int] = {}
        # cached instrument refs for the hot path
        reg = self.registry
        self._h_latency = reg.histogram("latency") if reg else None
        self._h_qwait = reg.histogram("queue_wait") if reg else None
        self._h_qdepth = reg.histogram("queue_depth_sampled") if reg else None
        self._h_occ = reg.histogram("batch_occupancy") if reg else None
        self._h_depth = reg.histogram("depth_served") if reg else None
        self._g_qdepth = reg.gauge("queue_depth") if reg else None
        self._c_admitted = reg.counter("requests_admitted") if reg else None
        self._c_dispatch = reg.counter("dispatches") if reg else None
        self._c_windows = reg.counter("windows_closed") if reg else None

    @classmethod
    def from_config(cls, conf: dict) -> "Tracer":
        return cls(spans=conf.get("spans", True),
                   audit=conf.get("audit", True),
                   metrics=conf.get("metrics", True),
                   export=conf.get("export"),
                   chrome=conf.get("chrome"))

    # -- engine hooks (called with engine-computed timestamps only) --------

    def on_admit(self, task, now: float, n_active: int) -> None:
        """Task popped from the source; spans start, queue depth sampled."""
        self._req[task.tid] = _new_entry(now)
        if self._g_qdepth is not None:
            self._g_qdepth.value = float(n_active)
            self._h_qdepth.observe(n_active)

    def on_admission(self, task, now: float, dec) -> None:
        """Admission decided (``dec is None`` means no controller)."""
        e = self._req.get(task.tid)
        reg = self.registry
        if dec is None or (dec.admitted and dec.depth_cap is None):
            if e is not None:
                e[_DECISION] = "admitted" if dec is None else dec.reason
            if self._c_admitted is not None:
                self._c_admitted.value += 1
            return
        if e is not None:
            e[_DECISION] = dec.reason
            e[_DETAIL] = dec.detail
        if reg is not None:
            if not dec.admitted:
                reg.counter("requests_rejected").inc()
            else:
                self._c_admitted.value += 1
                reg.counter("requests_capped").inc()
        if self.audit_on:
            self.audit(dec.reason, now, dec.detail, tid=task.tid,
                       model=getattr(task, "model", None))

    def on_dispatch(self, stage: int, batch, now: float,
                    wcet: float) -> None:
        """Batch handed to the executor; opens a device-window record."""
        n = len(batch)
        bucket = self._bucket(n)
        tids = tuple(t.tid for t in batch)
        self._open.append({"stage": stage, "t0": now, "n": n,
                           "bucket": bucket, "wcet": wcet, "tids": tids})
        spans = self.spans_on
        for t in batch:
            e = self._req.get(t.tid)
            if e is not None:
                if e[_T_FIRST] is None:
                    e[_T_FIRST] = now
                if spans:
                    e[_BATCHES].append((now, stage, n, bucket, wcet))
        if self._c_dispatch is not None:
            self._c_dispatch.value += 1
            self._h_occ.observe(n)

    def on_window_close(self, stage: int, batch, t1: float) -> None:
        """Executor completed a window; charge device time to every rider."""
        tids = tuple(t.tid for t in batch)
        w = None
        for cand in self._open:
            if cand["stage"] == stage and cand["tids"] == tids:
                w = cand
                break
        if w is None:                       # unmatched (foreign executor)
            w = {"stage": stage, "t0": t1, "n": len(batch),
                 "bucket": self._bucket(len(batch)), "wcet": None,
                 "tids": tids}
        else:
            self._open.remove(w)
        w["t1"] = t1
        self.windows.append(w)
        dur = t1 - w["t0"]
        t0 = w["t0"]
        spans = self.spans_on
        for t in batch:
            e = self._req.get(t.tid)
            if e is not None:
                e[_DEV] += dur
                if spans:
                    e[_WINDOWS].append((stage, t0, t1, w["n"]))
        if self._c_windows is not None:
            self._c_windows.value += 1

    def on_stage_exit(self, task, now: float) -> None:
        if not self.spans_on:
            return
        e = self._req.get(task.tid)
        if e is not None:
            conf = task.confidences[-1] if task.confidences else None
            e[_EXITS].append((now, task.executed, conf))

    def on_topoff(self, stage: int, presel_tids, final_tids,
                  now: float) -> None:
        """Preselected batch was revalidated into a different seating."""
        if self.registry is not None:
            self.registry.counter("topoffs").inc()
        if self.audit_on:
            added = [t for t in final_tids if t not in presel_tids]
            removed = [t for t in presel_tids if t not in final_tids]
            self.audit("batch-top-off", now,
                       {"stage": stage, "presel_n": len(presel_tids),
                        "final_n": len(final_tids), "added": added,
                        "removed": removed})

    def on_pullin(self, task, now: float, cap: int) -> None:
        """Live cancel pulled the task's depth down to ``cap``."""
        if self.registry is not None:
            self.registry.counter("pullins").inc()
        if self.audit_on:
            self.audit("cancel-pullin", now,
                       {"executed": task.executed, "cap": cap,
                        "mandatory": task.mandatory}, tid=task.tid)

    # -- audit log ---------------------------------------------------------

    def audit(self, rule: str, t: float, detail: Optional[dict] = None,
              *, tid: Optional[int] = None,
              request_id: Optional[str] = None,
              tenant: Optional[str] = None, slo: Optional[str] = None,
              model: Optional[str] = None) -> None:
        row: Dict[str, Any] = {"t": float(t), "rule": rule,
                               "detail": detail or {}}
        if tid is not None:
            row["tid"] = tid
        if request_id is not None:
            row["request_id"] = request_id
        if tenant is not None:
            row["tenant"] = tenant
        if slo is not None:
            row["slo"] = slo
        if model is not None:
            row["model"] = model
        self.audit_log.append(row)

    def ingest_pending(self, rows: List[dict]) -> None:
        """Drain intake-side audit rows buffered before/outside the engine.

        Each row is an audit dict plus a ``kind`` key mapping it onto the
        registry counters (``reject`` -> requests_rejected, ``shed`` ->
        requests_capped, matching the ``MetricsStreamer`` split)."""
        while rows:
            row = dict(rows.pop(0))
            kind = row.pop("kind", None)
            if self.registry is not None:
                if kind == "reject":
                    self.registry.counter("requests_rejected").inc()
                elif kind == "shed":
                    self.registry.counter("requests_capped").inc()
            if self.audit_on:
                self.audit_log.append(row)

    # -- retire ------------------------------------------------------------

    def finalize(self, task, now: float, rejected: bool, t0: float,
                 rec: dict) -> None:
        """Close out a request: inject time splits into its per-request
        row (emit-only-when-set) and stash the raw accumulators for lazy
        RequestTrace materialisation."""
        e = self._req.pop(task.tid, None)
        latency = rec.get("latency", now - t0)
        if e is None:                     # tracer attached mid-flight
            e = _new_entry(t0)
        t_first = e[_T_FIRST]
        queue_wait = (t_first - t0) if t_first is not None else latency
        device_time = e[_DEV]
        host_time = latency - queue_wait - device_time
        if host_time < 0.0:
            host_time = 0.0
        decision = e[_DECISION]
        if decision is None:
            decision = "rejected" if rejected else "admitted"
        rec["queue_wait"] = queue_wait
        rec["host_time"] = host_time
        rec["device_time"] = device_time
        rec["decision"] = decision
        if self.registry is not None:
            self._h_latency.observe(latency)
            self._h_qwait.observe(queue_wait)
            if not rejected:
                self._h_depth.observe(rec.get("depth", task.executed))
            if rec.get("missed"):
                self.registry.counter("requests_missed").inc()
        if not self.spans_on:
            return
        meta = (rec.get("request_id"), rec.get("tenant"), rec.get("slo"),
                rec.get("model"), latency, rec.get("depth", task.executed),
                bool(rec.get("missed")))
        self._done[task.tid] = (e, t0, now, bool(rejected), decision,
                                task.depth_cap, queue_wait, host_time,
                                device_time, meta)
        rid = meta[0]
        if rid is not None:
            self._by_rid[str(rid)] = task.tid

    def _materialize(self, tid: int) -> RequestTrace:
        (e, t0, now, rejected, decision, depth_cap, queue_wait, host_time,
         device_time, meta) = self._done.pop(tid)
        rid, tenant, slo, model, latency, depth, missed = meta
        t_first = e[_T_FIRST]
        spans = [Span("queued", t0, t_first if t_first is not None else now)]
        if not rejected:
            adm_attrs: Dict[str, Any] = {"decision": decision}
            if e[_DETAIL]:
                adm_attrs["detail"] = e[_DETAIL]
            if depth_cap is not None:
                adm_attrs["depth_cap"] = depth_cap
            spans.append(Span("admitted", e[_T_ADMIT], e[_T_ADMIT],
                              adm_attrs))
        for (t, stage, n, bucket, wcet) in e[_BATCHES]:
            spans.append(Span("batched", t, t,
                              {"stage": stage, "n": n, "bucket": bucket}))
            spans.append(Span("dispatch", t, t,
                              {"stage": stage, "wcet": wcet}))
        for (stage, w0, w1, n) in e[_WINDOWS]:
            spans.append(Span("device-window", w0, w1,
                              {"stage": stage, "n": n}))
        for (t, stage, conf) in e[_EXITS]:
            attrs: Dict[str, Any] = {"stage": stage}
            if conf is not None:
                attrs["conf"] = float(conf)
            spans.append(Span("stage-exit", t, t, attrs))
        end = "expire" if (missed and not rejected) else "retire"
        end_attrs: Dict[str, Any] = {"latency": latency, "depth": depth}
        if rejected:
            end_attrs["rejected"] = True
        spans.append(Span(end, now, now, end_attrs))
        spans.sort(key=lambda s: (s.t0, _SPAN_ORDER.get(s.name, 9)))
        tr = RequestTrace(tid, spans, request_id=rid, tenant=tenant,
                          slo=slo, model=model, decision=decision,
                          depth_cap=depth_cap, latency=latency, depth=depth,
                          missed=missed, rejected=rejected,
                          queue_wait=queue_wait, host_time=host_time,
                          device_time=device_time)
        self._traces[tid] = tr
        return tr

    # -- lookup / export ---------------------------------------------------

    @property
    def traces(self) -> Dict[int, RequestTrace]:
        """Finished requests as RequestTrace objects, keyed by tid
        (materialised on first access — off the hot path)."""
        while self._done:
            self._materialize(next(iter(self._done)))
        return self._traces

    def trace(self, key) -> Optional[RequestTrace]:
        """Look up a finished request by tid (int) or request_id (str)."""
        if isinstance(key, str) and not key.isdigit():
            tid = self._by_rid.get(key)
        else:
            tid = int(key)
        if tid is None:
            return None
        if tid in self._done:
            return self._materialize(tid)
        return self._traces.get(tid)

    def audit_for(self, key) -> List[dict]:
        """Audit rows for one request, matched by tid or request_id."""
        tr = self.trace(key)
        rows = []
        for row in self.audit_log:
            if tr is not None and row.get("tid") == tr.tid:
                rows.append(row)
            elif isinstance(key, str) and row.get("request_id") == key:
                rows.append(row)
        return rows

    def _bucket(self, n: int) -> int:
        b = self._buckets_cache.get(n)
        if b is not None:
            return b
        tm = self.time_model
        buckets = getattr(tm, "buckets", None) if tm is not None else None
        b = n
        if buckets:
            b = int(buckets[-1])
            for cand in buckets:
                if cand >= n:
                    b = int(cand)
                    break
        self._buckets_cache[n] = b
        return b

    def export_jsonl(self, path: str) -> str:
        from .export import write_jsonl
        return write_jsonl(self, path)

    def chrome_trace(self) -> dict:
        from .export import chrome_trace
        return chrome_trace(self)

    def close(self) -> None:
        """Write any configured export files (called when a run finishes)."""
        if self.export_path:
            self.export_jsonl(self.export_path)
        if self.chrome_path:
            import json
            with open(self.chrome_path, "w") as fh:
                json.dump(self.chrome_trace(), fh)
