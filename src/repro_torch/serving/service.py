"""One public serving API: declarative ``ServeSpec`` + ``Service`` facade.

The paper's user-space scheduler (Fig. 2, §II-B) is one admission point in
front of the anytime model; this module is that front door for the whole
package.  Instead of hand-wiring Clock x Executor x Source x Policy per
caller, a **ServeSpec** *names* every component by string key (resolved
through :mod:`repro_torch.serving.registry`, so new schedulers/executors plug in
without touching core modules) and round-trips through JSON; a **Service**
built from it owns the engine lifecycle:

* ``Service.from_spec(spec, **resources)`` — resources are the
  non-serializable runtime objects (oracle tables, params, workloads,
  request streams, or ready-made component *instances*, which skip the
  registry lookup for that slot).
* ``run(stream=None) -> ServiceMetrics`` — one-shot batch mode: drive the
  configured source (closed-loop workload or request stream) to
  completion.
* ``submit(request, slo="gold") -> ResponseHandle`` — live mode
  (``source="live"``): a future with ``result(timeout)``, ``cancel()``
  and ``stages()`` — an iterator streaming each anytime
  (prediction, confidence) exit as it lands, the paper's
  anytime-prediction contract made API-visible.  On a wall clock the
  engine serves from a background thread; on a virtual clock submissions
  buffer until ``drain()`` replays them discrete-event.
* per-request **SLO classes** — named tiers mapping to relative deadline,
  utility weight and depth cap (``spec.slo_classes``), applied at
  admission and further clamped by the ``AdmissionController``.
* ``metrics() -> ServiceMetrics`` — structured superset of ``SimResult``
  (per-class breakdown, admission/cancellation counts), JSON-exportable.
* graceful ``drain()`` / ``close()``.

A copy of ``repro.serving.service`` for the port, with its traffic
(metrics streaming, :mod:`repro_torch.serving.traffic`) and tracing
(``trace``, :mod:`repro_torch.serving.obs`) plumbing.  What the port has
not taken up yet raises ``NotImplementedError`` naming its ROADMAP queue
item: the ``models`` and ``tenants`` fields and forecast admission
(``ServeSpec.validate``), the zoo and durable-plane resources
(``Service.__init__``), and unported registry keys
(``repro_torch.serving.registry.NOT_PORTED``).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import math
import queue
import threading
from concurrent.futures import CancelledError
from typing import Any, Optional

from repro_torch.core.simulator import SimResult
from repro_torch.core.task import Task
from repro_torch.serving.batch.admission import AdmissionController
from repro_torch.serving.batch.batcher import DEFAULT_BUCKETS, BatchTimeModel
from repro_torch.serving.batch.policy import as_batch_policy
from repro_torch.serving.registry import BuildContext, resolve
from repro_torch.serving.runtime.core import (EngineCore, ResponseRecorder,
                                        TableRecorder)
from repro_torch.serving.runtime.sources import RequestSource, StreamSource

_SENTINEL = object()

# resources of the JAX package's zoo and durable-plane subsystems
_NOT_PORTED_RESOURCES = ("zoo", "zoo_tables", "observer")

# backpressure overflow policies for a bounded live intake (semantics in
# repro_torch.serving.traffic.control, which re-exports this as
# OVERFLOW_MODES)
_OVERFLOW_MODES = ("reject", "shed-optional")


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named service tier: the §II-B deadline/utility contract per class.

    ``rel_deadline`` fills in requests that carry none; ``utility_weight``
    becomes ``Task.weight`` (the paper's weighted-accuracy importance);
    ``depth_cap`` pins ``Task.depth_cap`` before admission control (which
    may clamp it further under overload).
    """
    name: str
    rel_deadline: Optional[float] = None
    utility_weight: float = 1.0
    depth_cap: Optional[int] = None

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "SLOClass":
        return cls(name=name,
                   rel_deadline=d.get("rel_deadline"),
                   utility_weight=float(d.get("utility_weight", 1.0)),
                   depth_cap=d.get("depth_cap"))


# ---------------------------------------------------------------------------
# ServeSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeSpec:
    """Declarative engine description — JSON/dict round-trippable.

    Component slots (``policy``/``executor``/``clock``/``source``) are
    registry keys (:mod:`repro_torch.serving.registry`); their ``*_args`` dicts
    are passed to the factories verbatim.

    ``batching`` describes the ``BatchTimeModel`` and batch discipline:

    * ``{"mode": "none", "stage_times": [...]}`` — singleton dispatch,
      single-bucket pricing, legacy unbatched accounting (formation time
      not billed) — exactly the old ``simulate``/``ServingEngine``.
    * ``{"buckets": [...], "stage_times": [...], "marginal": 0.15}`` —
      analytic linear model (``BatchTimeModel.linear``).
    * ``{"buckets": [...], "times": [[...]]}`` — explicit per-bucket WCET
      rows (a profiled model, serialized).
    * a ``time_model`` *resource* overrides all of the above;
      ``max_batch``/``charge_formation`` keys still apply.

    ``admission``: ``{"mode": "reject"|"depth_cap", "headroom": 1.0}``
    (empty dict = no admission control; the predictive ``forecast`` key is
    not ported yet).  ``slo_classes``: name ->
    ``{rel_deadline, utility_weight, depth_cap}``.

    Full field reference: ``docs/serving-api.md`` (kept in sync by the
    docs-check CI job).  Example — declare, round-trip, validate, run:

    ```python
    import numpy as np
    from repro_torch.serving import ServeSpec, Service

    rng = np.random.default_rng(0)
    conf = np.sort(rng.uniform(0.3, 1.0, (50, 3)), axis=1)
    correct = rng.uniform(size=(50, 3)) < conf
    spec = ServeSpec(policy="edf",
                     batching={"mode": "none", "stage_times": [0.01] * 3},
                     source_args={"n_clients": 4, "d_lo": 0.02,
                                  "d_hi": 0.2, "n_requests": 20})
    spec = ServeSpec.from_json(spec.to_json()).validate()
    res = Service.from_spec(spec, conf_table=conf,
                            correct_table=correct).run()
    assert res.n_requests == 20
    ```
    """
    policy: str = "rtdeepiot"
    policy_args: dict = dataclasses.field(default_factory=dict)
    executor: str = "oracle"
    executor_args: dict = dataclasses.field(default_factory=dict)
    clock: str = "virtual"
    clock_args: dict = dataclasses.field(default_factory=dict)
    source: str = "closed-loop"
    source_args: dict = dataclasses.field(default_factory=dict)
    batching: dict = dataclasses.field(default_factory=dict)
    admission: dict = dataclasses.field(default_factory=dict)
    slo_classes: dict = dataclasses.field(default_factory=dict)
    default_slo: Optional[str] = None
    pipeline_depth: int = 1
    dispatch_overhead: float = 0.0
    policy_cost: Optional[float] = None
    charge_overhead: bool = False
    host_overhead: float = 0.0
    # > 0: stream windowed ServiceSnapshot rows to the ``on_metrics``
    # callback resource every `metrics_interval` service seconds
    # (repro_torch.serving.traffic.control)
    metrics_interval: float = 0.0
    # ``tenants`` and ``models`` belong to subsystems not ported yet (ROADMAP
    # Queue A item 9b): validate() raises NotImplementedError when set.
    tenants: dict = dataclasses.field(default_factory=dict)
    models: dict = dataclasses.field(default_factory=dict)
    # observability (repro_torch.serving.obs): ``{"enabled": True}``
    # attaches a passive Tracer (per-request spans + decision audit log +
    # metrics registry, reachable as ``service.obs`` after a run).
    # Optional keys: ``spans``/``audit``/``metrics`` (bools, default True)
    # gate the three recording planes; ``export``/``chrome`` are file
    # paths written when the run finishes (JSONL / Chrome trace_event
    # JSON).  Empty dict = tracing off, zero overhead.
    trace: dict = dataclasses.field(default_factory=dict)

    # -- round trip ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeSpec keys: {sorted(unknown)}")
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ServeSpec":
        return cls.from_dict(json.loads(s))

    # -- validation ----------------------------------------------------
    def validate(self) -> "ServeSpec":
        """Resolve every registry key and sanity-check the scalar fields;
        raises with the available keys on a miss.  Returns self."""
        for kind, name in (("policy", self.policy),
                           ("executor", self.executor),
                           ("clock", self.clock), ("source", self.source)):
            resolve(kind, name)
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        mode = self.admission.get("mode")
        if mode is not None and mode not in ("off", "reject", "depth_cap"):
            raise ValueError(f"admission mode {mode!r} not in "
                             "('off', 'reject', 'depth_cap')")
        for field, value, item in (
                ("admission['forecast']", self.admission.get("forecast"),
                 "Queue A item 9b"),
                ("models", self.models, "Queue A item 9b"),
                ("tenants", self.tenants, "Queue A item 9b")):
            if value:
                raise NotImplementedError(
                    f"ServeSpec.{field} is not ported to repro_torch yet "
                    f"(ROADMAP {item})")
        for name, d in self.slo_classes.items():
            c = SLOClass.from_dict(name, d)
            if c.rel_deadline is not None and c.rel_deadline <= 0:
                raise ValueError(f"SLO {name!r}: rel_deadline must be > 0")
            if c.depth_cap is not None and c.depth_cap < 1:
                raise ValueError(f"SLO {name!r}: depth_cap must be >= 1")
        if self.default_slo is not None \
                and self.default_slo not in self.slo_classes:
            raise ValueError(f"default_slo {self.default_slo!r} is not a "
                             f"defined SLO class")
        if self.metrics_interval < 0:
            raise ValueError("metrics_interval must be >= 0")
        if self.executor == "device-kernel":
            self._validate_kernel_args()
        if self.trace:
            from repro_torch.serving.obs import TRACE_KEYS
            unknown = set(self.trace) - set(TRACE_KEYS)
            if unknown:
                raise ValueError(f"unknown trace keys: {sorted(unknown)} "
                                 f"(allowed: {TRACE_KEYS})")
            for key in ("export", "chrome"):
                v = self.trace.get(key)
                if v is not None and not isinstance(v, str):
                    raise ValueError(f"trace {key!r} must be a file path")
        if self.source == "live":
            bound = self.source_args.get("bound")
            if bound is not None and int(bound) < 1:
                raise ValueError("live source 'bound' must be >= 1")
            ov = self.source_args.get("overflow")
            if ov is not None and ov not in _OVERFLOW_MODES:
                raise ValueError(f"live source overflow {ov!r} not in "
                                 f"{_OVERFLOW_MODES}")
        return self

    def _validate_kernel_args(self) -> None:
        """Shape-level checks for ``executor="device-kernel"`` args (the
        factory lives in :mod:`repro_torch.launch.kernel`).  Fail at spec time,
        not at first dispatch on a warm engine."""
        # lazy: the factory (and its arg list) lives with the executor it
        # validates; repro_torch.launch.kernel does not import this module back
        from repro_torch.launch.kernel import KERNEL_ARGS
        ea = self.executor_args
        unknown = set(ea) - set(KERNEL_ARGS)
        if unknown:
            raise ValueError(f"unknown device-kernel executor_args: "
                             f"{sorted(unknown)}; known: "
                             f"{sorted(KERNEL_ARGS)}")
        mode = ea.get("mode", "classifier")
        if mode not in ("classifier", "decode"):
            raise ValueError(f"device-kernel mode {mode!r} not in "
                             "('classifier', 'decode')")
        lbs = ea.get("len_buckets")
        if lbs is not None:
            if (not isinstance(lbs, (list, tuple)) or not lbs
                    or any(isinstance(b, bool) or not isinstance(b, int)
                           or b < 1 for b in lbs)
                    or list(lbs) != sorted(set(lbs))):
                raise ValueError(
                    "device-kernel 'len_buckets' must be a strictly "
                    f"ascending list of integers >= 1, got {lbs!r}")
        lm = ea.get("len_marginal")
        if lm is not None and not 0 <= float(lm) <= 1:
            raise ValueError("device-kernel 'len_marginal' must be in "
                             "[0, 1]")

    def slo_class(self, name: Optional[str]) -> Optional[SLOClass]:
        if name is None:
            name = self.default_slo
        if name is None:
            return None
        try:
            return SLOClass.from_dict(name, self.slo_classes[name])
        except KeyError:
            raise KeyError(f"unknown SLO class {name!r}; defined: "
                           f"{sorted(self.slo_classes)}") from None


# ---------------------------------------------------------------------------
# results / metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceResponse:
    """What a resolved ``ResponseHandle`` yields (executor-agnostic: the
    oracle executor has no predictions, so ``prediction`` may be None)."""
    sample: int
    prediction: Optional[int]
    confidence: float
    depth: int
    missed: bool
    latency: float
    deadline: float
    slo: Optional[str] = None
    rejected: bool = False
    tid: int = -1


@dataclasses.dataclass(frozen=True)
class StageExit:
    """One anytime exit: stage ``depth`` finished in time at service time
    ``t`` with this (prediction, confidence)."""
    depth: int
    prediction: Optional[int]
    confidence: float
    t: float


@dataclasses.dataclass
class ServiceMetrics(SimResult):
    """``SimResult`` plus the service-level dimensions: per-SLO-class
    breakdown, admission-control counts, cancellations, and the resolved
    component keys.  ``to_json`` exports the whole structure.

    ``miss_rate``/``accuracy`` keep the legacy semantics (a rejected
    request counts as a miss); ``admitted_miss_rate`` /
    ``admitted_accuracy`` score only what the service accepted — the
    overload-control question is whether *admitted* work meets its
    deadlines while rejects fail fast."""
    per_class: dict = dataclasses.field(default_factory=dict)
    per_tenant: dict = dataclasses.field(default_factory=dict)
    # model id -> {n, served, rejected, miss_rate, mean_depth,
    # mean_latency, accuracy, weighted_accuracy} — the multi-model zoo's
    # breakdown (empty when no request carried a model id); accuracy
    # fields are None when correctness is unmeasurable for that executor
    per_model: dict = dataclasses.field(default_factory=dict)
    rejected: int = 0
    capped: int = 0
    cancelled: int = 0
    admitted_miss_rate: float = 0.0
    admitted_accuracy: Optional[float] = None
    components: dict = dataclasses.field(default_factory=dict)
    # device-executor telemetry (empty for modeled/oracle executors):
    # measured per-stage host vs device seconds and hidden-state-cache
    # lifecycle counts (live/peak/evictions) — see DeviceExecutor
    executor_times: dict = dataclasses.field(default_factory=dict)
    executor_cache: dict = dataclasses.field(default_factory=dict)

    def to_json(self, *, per_request: bool = False, **kw) -> str:
        return json.dumps(self.to_dict(per_request=per_request), **kw)


# ---------------------------------------------------------------------------
# response futures
# ---------------------------------------------------------------------------

class ResponseHandle:
    """Future for one submitted request.

    * ``result(timeout)`` — block for the final ``ServiceResponse``
      (raises ``TimeoutError`` on timeout, ``CancelledError`` if
      cancelled).  On a virtual clock, call ``Service.drain()`` first.
    * ``stages()`` — iterate the request's anytime exits
      (:class:`StageExit`) as they land; the iterator ends when the
      request retires.  One-shot: exits are consumed.
    * ``cancel()`` — before admission: withdraws the request outright
      (``result()`` raises ``CancelledError``).  After admission (a live
      wall-clock service), the request's remaining *optional* stages are
      shed — the engine pulls the depth target in to the mandatory part
      and retires it at the next loop tick — and ``result()`` still
      returns the deepest in-time exit (the anytime contract survives
      cancellation).  Returns True when either took effect.

    Example — stream the anytime exits of one request:

    ```python
    import numpy as np
    from repro_torch.serving import ServeSpec, Service
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    conf = np.sort(rng.uniform(0.5, 1.0, (10, 3)), axis=1)
    correct = rng.uniform(size=(10, 3)) < conf
    spec = ServeSpec(source="live", default_slo="gold",
                     slo_classes={"gold": {"rel_deadline": 0.5}},
                     batching={"mode": "none",
                               "stage_times": [0.01] * 3})
    with Service.from_spec(spec, conf_table=conf,
                           correct_table=correct) as svc:
        handle = svc.submit(Request(inputs=None, sample=0))
        svc.drain()
        exits = list(handle.stages())        # each in-time (pred, conf)
        assert handle.result().depth == len(exits)
    ```
    """

    def __init__(self, service: "Service", request):
        self._service = service
        self._request = request
        self._event = threading.Event()
        self._stage_q: queue.Queue = queue.Queue()
        self._result: Optional[ServiceResponse] = None
        self._cancelled = False
        self._claimed = False          # the engine admitted the request
        self._lock = threading.Lock()  # cancel vs engine-claim exclusion
        self._error: Optional[BaseException] = None
        self._task = None

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            if self._claimed:
                task = self._task
            else:
                self._cancelled = True
                task = None
        if task is not None:
            # admitted: shed the remaining optional stages (deadline
            # pull-in) via the engine loop — wall-clock live only (a
            # virtual-clock drain() admits and runs synchronously)
            live = self._service._live
            if live is None:
                return False
            self._service._n_cancelled += 1
            live.core.request_pullin(task)
            return True
        self._service._n_cancelled += 1
        self._service._submitted.discard(self)
        self._event.set()
        self._stage_q.put(_SENTINEL)
        return True

    def result(self, timeout: Optional[float] = None) -> ServiceResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("request not resolved within timeout "
                               "(virtual-clock services resolve at drain())")
        if self._cancelled:
            raise CancelledError()
        if self._error is not None:
            raise RuntimeError("serving engine failed before this request "
                               "resolved") from self._error
        return self._result

    def stages(self, timeout: Optional[float] = None):
        while True:
            try:
                item = self._stage_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("no stage exit within timeout") from None
            if item is _SENTINEL:
                self._stage_q.put(_SENTINEL)   # keep the stream terminated
                return
            yield item

    # called from the engine (possibly a background thread) -------------
    def _push_stage(self, exit_: StageExit) -> None:
        self._stage_q.put(exit_)

    def _resolve(self, result: ServiceResponse) -> None:
        self._result = result
        self._stage_q.put(_SENTINEL)
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        """The engine died before this request resolved — unblock waiters."""
        if self._event.is_set():
            return
        self._error = exc
        self._stage_q.put(_SENTINEL)
        self._event.set()


# ---------------------------------------------------------------------------
# live source (Service.submit queue)
# ---------------------------------------------------------------------------

class LiveSource(RequestSource):
    """Thread-safe request intake for a wall-clock live service.

    ``has_pending`` stays true while the intake is open, so the engine
    loop keeps polling (at ``poll`` granularity) instead of exiting when
    the queue momentarily runs dry; ``close()`` (from ``drain``) lets the
    loop finish the backlog and fall through.
    """

    def __init__(self, task_factory, clock, poll: float = 0.002):
        self.task_factory = task_factory
        self.clock = clock
        self.poll = poll
        self._heap: list = []
        self._n = 0
        self._lock = threading.Lock()
        self._closed = False

    def push(self, offset: float, request) -> None:
        with self._lock:
            heapq.heappush(self._heap, (offset, self._n, request))
            self._n += 1

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    def close(self) -> None:
        self._closed = True

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._heap) or not self._closed

    def next_time(self) -> float:
        with self._lock:
            if self._heap:
                return self._heap[0][0]
        if self._closed:
            return math.inf
        return self.clock.now() + self.poll

    def pop(self, now: float):
        with self._lock:
            off, _, req = heapq.heappop(self._heap)
        req.arrival = off
        return self.task_factory(req, now)


# ---------------------------------------------------------------------------
# recorder: engine retirements -> handles + uniform records
# ---------------------------------------------------------------------------

class ServiceRecorder:
    """Wraps the runtime recorders: keeps the golden-parity aggregation
    (``TableRecorder``) / legacy ``Response`` list (``ResponseRecorder``)
    intact while resolving futures, streaming stage exits, and collecting
    the uniform per-request records ``ServiceMetrics`` is built from."""

    def __init__(self, service: "Service", inner, executor, streamer=None):
        self.service = service
        self.inner = inner
        self.executor = executor
        self.streamer = streamer       # MetricsStreamer (traffic.control)
        self.records: list = []
        self.core = None               # set by Service._build

    # -- helpers -------------------------------------------------------
    def _pred_conf(self, task):
        pred, conf = None, task.last_confidence
        states = getattr(self.executor, "states", None)
        if states is not None:
            st = states.get(task.tid)
            if st is not None and st[2] is not None:
                pred, conf = st[2]
        return pred, (float(conf) if conf is not None else 0.0)

    # -- engine hooks ----------------------------------------------------
    def on_stage(self, task, now: float) -> None:
        if self.streamer is not None:
            self.streamer.tick(now)
        h = self.service._handles.get(task.tid)
        if h is None:
            return
        pred, conf = self._pred_conf(task)
        h._push_stage(StageExit(depth=task.executed, prediction=pred,
                                confidence=conf, t=now))

    def on_retire(self, task, now: float, rejected: bool = False) -> None:
        pred, conf = self._pred_conf(task)
        if self.inner is not None:
            self.inner.on_retire(task, now, rejected)
        missed = task.executed == 0
        slo = self.service._slo_names.get(task.tid)
        # latency from *request* arrival where known (stream/live modes);
        # closed-loop tasks are admitted at issue time, so task.arrival is
        # already the true arrival
        t0 = self.service._req_arrivals.pop(task.tid, task.arrival)
        latency = now - t0
        tenant, rid = self.service._req_meta.pop(task.tid, (None, None))
        rec = dict(
            tid=task.tid, sample=task.sample, client=task.client, slo=slo,
            depth=task.executed, missed=missed, conf=conf, prediction=pred,
            arrival=task.arrival, deadline=task.deadline, offset=t0,
            rel_deadline=self.service._req_rels.pop(task.tid, None),
            depth_cap=task.depth_cap, tenant=tenant, request_id=rid,
            latency=latency, rejected=rejected, weight=task.weight,
            model=getattr(task, "model", None))
        tracer = self.core.tracer if self.core is not None else None
        if tracer is not None:
            # injects queue_wait / host_time / device_time / decision into
            # the row (emit-only-when-set) and closes the RequestTrace
            tracer.finalize(task, now, rejected, t0, rec)
        self.records.append(rec)
        if self.streamer is not None:
            self.streamer.observe(rec, now)
        self.service._slo_names.pop(task.tid, None)
        h = self.service._handles.pop(task.tid, None)
        if h is not None:
            h._resolve(ServiceResponse(
                sample=task.sample, prediction=pred, confidence=conf,
                depth=task.executed, missed=missed, latency=latency,
                deadline=task.deadline, slo=slo, rejected=rejected,
                tid=task.tid))
            # resolved handles no longer need failure fanout — prune so a
            # long-lived live service does not grow without bound
            self.service._submitted.discard(h)

    # -- aggregation -----------------------------------------------------
    def _base_fields(self, core) -> dict:
        if isinstance(self.inner, TableRecorder):
            d = dataclasses.asdict(self.inner.result(core))
            # aggregates keep the golden-parity TableRecorder math, but the
            # per-request rows are the uniform service records (offset /
            # rel_deadline / slo / depth_cap — what trace replay needs)
            d["per_request"] = self.records
            return d
        recs = self.records
        n = len(recs)
        labels = self.service.resources.get("labels")
        ok = [r for r in recs if not r["missed"]]

        def _correct(r):
            p = r.get("prediction")
            return p is not None and p == labels[r["sample"]]
        # prediction correctness needs a ``labels`` resource; without it
        # this executor cannot measure accuracy — report None, not a
        # plausible-looking 0.0
        acc = (sum(_correct(r) for r in recs) / n) if n and labels is not None \
            else None
        busy = getattr(self.executor, "total_busy", 0.0)
        sched = core.policy.sched_time
        denom, hdenom = busy + sched, busy + core.host_serial
        makespan = core.makespan
        return dict(
            accuracy=acc,
            miss_rate=(sum(r["missed"] for r in recs) / n) if n else 0.0,
            mean_depth=(sum(r["depth"] for r in ok) / len(ok)) if ok else 0.0,
            mean_conf=(sum(r["conf"] for r in ok) / len(ok)) if ok else 0.0,
            overhead_frac=sched / denom if denom else 0.0,
            n_requests=n, per_request=recs, makespan=makespan,
            throughput=len(ok) / makespan if makespan > 0 else 0.0,
            sched_charged=core.sched_charged, host_serial=core.host_serial,
            host_overhead_frac=core.host_serial / hdenom if hdenom else 0.0,
            n_dispatches=core.n_dispatches, presel_hits=core.presel_hits,
            presel_misses=core.presel_misses)

    def result(self, core) -> ServiceMetrics:
        per_class: dict = {}
        for r in self.records:
            if r["slo"] is None:
                continue
            c = per_class.setdefault(r["slo"], dict(
                n=0, missed=0, rejected=0, depth_sum=0, latency_sum=0.0))
            c["n"] += 1
            c["missed"] += int(r["missed"])
            c["rejected"] += int(r["rejected"])
            c["depth_sum"] += r["depth"]
            c["latency_sum"] += r["latency"]
        for name, c in per_class.items():
            n = c["n"]
            per_class[name] = dict(
                n=n, miss_rate=c["missed"] / n, rejected=c["rejected"],
                mean_depth=c["depth_sum"] / n,
                mean_latency=c["latency_sum"] / n)
        # backpressure rejects never became tasks: they appear in the
        # rejected counters (total and per class), not in n_requests
        for name, cnt in self.service._bp_per_class.items():
            entry = per_class.setdefault(name, dict(
                n=0, miss_rate=0.0, rejected=0, mean_depth=0.0,
                mean_latency=0.0))
            entry["rejected"] += cnt
        per_tenant: dict = {}
        for r in self.records:
            if r.get("tenant") is None:
                continue
            t = per_tenant.setdefault(r["tenant"], dict(
                n=0, served=0, missed=0, rejected=0, depth_sum=0,
                latency_sum=0.0))
            t["n"] += 1
            t["missed"] += int(r["missed"])
            t["rejected"] += int(r["rejected"])
            t["served"] += int(not r["rejected"] and not r["missed"])
            t["depth_sum"] += r["depth"]
            t["latency_sum"] += r["latency"]
        for name, t in per_tenant.items():
            n = t["n"]
            per_tenant[name] = dict(
                n=n, served=t["served"], rejected=t["rejected"],
                miss_rate=t["missed"] / n, mean_depth=t["depth_sum"] / n,
                mean_latency=t["latency_sum"] / n)
        # front-door quota rejects never became tasks: count them per
        # tenant the same way backpressure rejects count per class
        for name, cnt in self.service._tenant_rejects.items():
            entry = per_tenant.setdefault(name, dict(
                n=0, served=0, rejected=0, miss_rate=0.0, mean_depth=0.0,
                mean_latency=0.0))
            entry["rejected"] += cnt
        # per-model breakdown (by ``Request.model``): correctness comes from
        # the TableRecorder's finished rows (matched by tid) or a
        # ``labels`` resource; None where neither can measure it
        correct_by_tid = {}
        if isinstance(self.inner, TableRecorder):
            correct_by_tid = {f["tid"]: f["correct"]
                              for f in self.inner.finished}
        labels = self.service.resources.get("labels")

        def _rec_correct(r):
            if r["tid"] in correct_by_tid:
                return bool(correct_by_tid[r["tid"]])
            if labels is not None and r.get("prediction") is not None:
                return bool(r["prediction"] == labels[r["sample"]])
            return None
        per_model: dict = {}
        for r in self.records:
            if r.get("model") is None:
                continue
            m = per_model.setdefault(r["model"], dict(
                n=0, served=0, missed=0, rejected=0, depth_sum=0,
                latency_sum=0.0, correct=0, measured=0, w_sum=0.0,
                w_correct=0.0))
            m["n"] += 1
            m["missed"] += int(r["missed"])
            m["rejected"] += int(r["rejected"])
            m["served"] += int(not r["rejected"] and not r["missed"])
            m["depth_sum"] += r["depth"]
            m["latency_sum"] += r["latency"]
            c = _rec_correct(r)
            if c is not None and not r["rejected"]:
                w = float(r.get("weight", 1.0))
                m["measured"] += 1
                m["correct"] += int(c)
                m["w_sum"] += w
                m["w_correct"] += w * int(c)
        for name, m in per_model.items():
            n = m["n"]
            per_model[name] = dict(
                n=n, served=m["served"], rejected=m["rejected"],
                miss_rate=m["missed"] / n, mean_depth=m["depth_sum"] / n,
                mean_latency=m["latency_sum"] / n,
                accuracy=(m["correct"] / m["measured"]
                          if m["measured"] else None),
                weighted_accuracy=(m["w_correct"] / m["w_sum"]
                                   if m["w_sum"] else None))
        adm_recs = [r for r in self.records if not r["rejected"]]
        admitted_miss = (sum(r["missed"] for r in adm_recs) / len(adm_recs)
                         if adm_recs else 0.0)
        admitted_acc = None
        if isinstance(self.inner, TableRecorder):
            fin = [f for f in self.inner.finished if not f["rejected"]]
            if fin:
                admitted_acc = sum(f["correct"] for f in fin) / len(fin)
        else:
            labels = self.service.resources.get("labels")
            if labels is not None and adm_recs:
                admitted_acc = sum(
                    r.get("prediction") is not None
                    and r["prediction"] == labels[r["sample"]]
                    for r in adm_recs) / len(adm_recs)
        adm = core.admission
        spec = self.service.spec
        ex = core.executor
        dts = getattr(ex, "device_time_stats", None)
        cst = getattr(ex, "cache_stats", None)
        return ServiceMetrics(
            executor_times=dts() if dts is not None else {},
            executor_cache=cst() if cst is not None else {},
            **self._base_fields(core), per_class=per_class,
            per_tenant=per_tenant, per_model=per_model,
            rejected=(adm.rejected if adm is not None else 0)
            + self.service._n_bp_rejected,
            capped=(adm.capped if adm is not None else 0)
            + self.service._n_shed,
            cancelled=self.service._n_cancelled,
            admitted_miss_rate=admitted_miss,
            admitted_accuracy=admitted_acc,
            components=dict(policy=spec.policy, executor=spec.executor,
                            clock=spec.clock, source=spec.source))


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Built:
    core: EngineCore
    recorder: ServiceRecorder
    clock: Any
    source: Any


class Service:
    """Engine lifecycle behind one admission point (see module docstring).

    Components are rebuilt fresh on every :meth:`run` (so repeated runs do
    not leak policy state across workloads); component *instances* passed
    as resources (``policy=``, ``executor=``, ``clock=``, ``source=``,
    ``admission=``) are reused as-is, skipping the registry.

    Example — live mode on a virtual clock (submissions buffer, ``drain``
    replays them discrete-event and resolves every handle):

    ```python
    import numpy as np
    from repro_torch.serving import ServeSpec, Service
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    conf = np.sort(rng.uniform(0.5, 1.0, (10, 3)), axis=1)
    correct = rng.uniform(size=(10, 3)) < conf
    spec = ServeSpec(source="live", default_slo="gold",
                     slo_classes={"gold": {"rel_deadline": 0.5}},
                     batching={"mode": "none",
                               "stage_times": [0.01] * 3})
    with Service.from_spec(spec, conf_table=conf,
                           correct_table=correct) as svc:
        h = svc.submit(Request(inputs=None, sample=3))
        metrics = svc.drain()
        assert h.result().sample == 3 and metrics.n_requests == 1
    ```
    """

    def __init__(self, spec: ServeSpec, resources: dict):
        self.spec = spec.validate()
        self.resources = resources
        self.policy = None              # base policy of the last build
        self.executor = None
        self.clock = None
        self.responses: list = []       # device-mode legacy Response list
        self._handles: dict = {}
        self._slo_names: dict = {}
        self._req_arrivals: dict = {}   # tid -> request (stream) arrival
        self._req_rels: dict = {}       # tid -> relative deadline as issued
        self._n_cancelled = 0
        self._n_bp_rejected = 0         # backpressure: rejected at submit()
        self._n_shed = 0                # backpressure: depth shed at submit()
        self._bp_per_class: dict = {}   # slo name -> backpressure rejects
        self._req_meta: dict = {}       # tid -> (tenant, request_id)
        self._tenant_rejects: dict = {}  # tenant -> front-door quota rejects
        self._closed = False
        self._live: Optional[_Built] = None
        self._live_error: Optional[BaseException] = None
        self._live_realtime: Optional[bool] = None
        self._submitted: set = set()    # unresolved live handles (failure
                                        # fanout; pruned on retire)
        self._thread: Optional[threading.Thread] = None
        self._buffer: list = []         # virtual-clock live submissions
        self._last: Optional[ServiceMetrics] = None
        self.snapshots: list = []       # streamed metrics of the last run
        self.obs = None                 # Tracer of the latest build
        # intake-side audit rows (bound rejects, sheds) raised before or
        # outside the engine loop — drained into the tracer at build time
        # and again when the run finishes
        self._pending_audit: list = []
        for key in _NOT_PORTED_RESOURCES:
            if key in resources:
                raise NotImplementedError(
                    f"resource {key!r} belongs to a subsystem not ported to "
                    "repro_torch yet (ROADMAP Queue A item 9b)")

    @classmethod
    def from_spec(cls, spec: ServeSpec, resources: dict = None,
                  **kw) -> "Service":
        return cls(spec, {**(resources or {}), **kw})

    # -- batching resolution -------------------------------------------
    def _resolve_batching(self):
        b = dict(self.spec.batching or {})
        tm = self.resources.get("time_model")
        mode = b.get("mode")
        if mode is None:
            mode = "bucketed" if (tm is not None or b.get("buckets")
                                  or b.get("times")) else "none"
        if tm is None:
            stage_times = b.get("stage_times")
            if stage_times is None:
                stage_times = self.resources.get("stage_times")
            if stage_times is None and b.get("times") is None:
                raise ValueError(
                    "batching needs 'stage_times' (spec or resource), "
                    "explicit 'times' rows, or a 'time_model' resource")
            if mode == "none":
                tm = BatchTimeModel.linear(
                    tuple(float(x) for x in stage_times), (1,))
            elif b.get("times") is not None:
                if not b.get("buckets"):
                    raise ValueError("batching 'times' rows need a matching "
                                     "'buckets' list")
                tm = BatchTimeModel(
                    buckets=tuple(int(x) for x in b["buckets"]),
                    times=tuple(tuple(float(t) for t in row)
                                for row in b["times"]))
            else:
                tm = BatchTimeModel.linear(
                    tuple(float(x) for x in stage_times),
                    buckets=tuple(b.get("buckets", DEFAULT_BUCKETS)),
                    marginal=float(b.get("marginal", 0.15)))
        if mode == "none":
            return tm, 1, False
        return tm, b.get("max_batch"), bool(b.get("charge_formation", True))

    # -- component build -----------------------------------------------
    def _component(self, kind: str, name: str, args: dict,
                   ctx: BuildContext):
        inst = self.resources.get(kind)
        if inst is not None:
            return inst
        return resolve(kind, name)(args, ctx)

    def _build(self, stream=None) -> _Built:
        spec = self.spec
        tm, max_batch, charge_formation = self._resolve_batching()
        ctx = BuildContext(spec=spec, resources=self.resources,
                           time_model=tm, max_batch=max_batch)
        policy = self._component("policy", spec.policy, spec.policy_args, ctx)
        ctx.policy = policy
        clock = self._component("clock", spec.clock, spec.clock_args, ctx)
        ctx.clock = clock
        executor = self._component("executor", spec.executor,
                                   spec.executor_args, ctx)
        ctx.executor = executor
        if ctx.time_model is not tm:
            # an executor factory may refine the time model (device-sharded
            # swaps in the dp-scaled bucket set); everything downstream —
            # batcher, admission, §II-B deadline adjustment — prices with it
            tm = ctx.time_model
        admission = self.resources.get("admission")
        if admission is None \
                and spec.admission.get("mode") not in (None, "off"):
            admission = AdmissionController(
                tm, mode=spec.admission["mode"],
                headroom=float(spec.admission.get("headroom", 1.0)))
        eff_mb = min(max_batch or tm.max_batch, tm.max_batch)
        ctx.task_factory = self._make_task_factory(executor, tm, eff_mb)
        ctx.stream = stream
        if spec.source == "live" and (stream is not None
                                      or not clock.realtime):
            # buffered live mode: drain() replays the buffered submissions
            # as a (discrete-event) stream
            source = StreamSource(stream or [], ctx.task_factory)
        else:
            source = self._component("source", spec.source, spec.source_args,
                                     ctx)
        self.responses = []
        if hasattr(executor, "pop_state"):
            inner = ResponseRecorder(executor, self.responses)
        elif "conf_table" in self.resources \
                and "correct_table" in self.resources:
            inner = TableRecorder(self.resources["conf_table"],
                                  self.resources["correct_table"])
        else:
            inner = None
        streamer = None
        if spec.metrics_interval > 0:
            # local import: the traffic subsystem layers on top of Service
            from repro_torch.serving.traffic.control import MetricsStreamer
            streamer = MetricsStreamer(spec.metrics_interval,
                                       self.resources.get("on_metrics"))
        recorder = ServiceRecorder(self, inner, executor, streamer=streamer)
        tracer = None
        if spec.trace and spec.trace.get("enabled", True):
            from repro_torch.serving.obs import Tracer
            tracer = Tracer.from_config(spec.trace)
            tracer.time_model = tm
            tracer.ingest_pending(self._pending_audit)
        self.obs = tracer
        pol = as_batch_policy(policy, tm, max_batch=max_batch,
                              charge_formation=charge_formation,
                              dp=getattr(executor, "dp", 1))
        core = EngineCore(pol, clock, executor, source, recorder,
                          admission=admission,
                          pipeline_depth=spec.pipeline_depth,
                          dispatch_overhead=spec.dispatch_overhead,
                          policy_cost=spec.policy_cost, max_batch=eff_mb,
                          tracer=tracer)
        recorder.core = core
        if streamer is not None:
            streamer.bind(core, source,
                          inner if isinstance(inner, TableRecorder) else None,
                          service=self)
        # telemetry handles on the latest build (policy.sched_time, custom
        # executor counters, ...)
        self.policy, self.executor, self.clock = policy, executor, clock
        return _Built(core=core, recorder=recorder, clock=clock,
                      source=source)

    def _make_task_factory(self, executor, tm, eff_mb):
        spec = self.spec
        # §II-B deadline adjustment: host overhead + the non-preemptible
        # region, priced at the largest batch this service dispatches.
        # At pipeline_depth <= 2 that region is one batched stage (the
        # legacy engines' rule); at depth >= 3 the executor queues up to
        # depth-1 windows behind the running one, so a newly urgent task
        # can be blocked for that many worst-case stages before it runs
        worst = max(tm.wcet(s, eff_mb) for s in range(tm.num_stages))
        adj = spec.host_overhead + worst * max(1, spec.pipeline_depth - 1)
        cfg = self.resources.get("cfg")
        mandatory = cfg.mandatory_stages if cfg is not None \
            else int(spec.source_args.get("mandatory_stages", 1))

        def factory(request, now):
            handle = getattr(request, "_handle", None)
            if handle is not None:
                # claim the request under the handle lock so a concurrent
                # cancel() either wins outright or fails — never both
                with handle._lock:
                    if handle._cancelled:
                        return None
                    handle._claimed = True
            slo = spec.slo_class(getattr(request, "slo", None))
            rel = request.rel_deadline
            if rel is None:
                if slo is None or slo.rel_deadline is None:
                    raise ValueError(
                        "request has no rel_deadline and its SLO class "
                        "defines none")
                rel = slo.rel_deadline
            task = Task(arrival=now,
                        deadline=request.arrival + rel - adj,
                        stage_times=tm.single_times(), mandatory=mandatory,
                        sample=request.sample, client=request.client,
                        seq_len=getattr(request, "seq_len", None),
                        model=getattr(request, "model", None))
            if slo is not None:
                task.weight = slo.utility_weight
                if slo.depth_cap is not None:
                    task.depth_cap = max(task.mandatory, slo.depth_cap)
                self._slo_names[task.tid] = slo.name
            tenant = getattr(request, "tenant", None)
            rid = getattr(request, "request_id", None)
            if tenant is not None or rid is not None:
                self._req_meta[task.tid] = (tenant, rid)
            if getattr(request, "_shed", False):
                # backpressure shed-optional: admitted, but only the
                # mandatory part survives (traffic.control semantics)
                task.depth_cap = task.mandatory
            if hasattr(executor, "register"):
                executor.register(task, request)
            # latency is measured from *request* arrival (the stream
            # offset), not admission time — a request queued behind a long
            # device window still pays its wait (legacy Response semantics)
            self._req_arrivals[task.tid] = request.arrival
            self._req_rels[task.tid] = rel
            if handle is not None:
                self._handles[task.tid] = handle
                handle._task = task
            return task
        return factory

    # -- batch mode ----------------------------------------------------
    def run(self, stream=None) -> ServiceMetrics:
        """Drive the configured source to completion and return metrics.

        ``stream``: (offset_seconds, Request) iterable for
        ``source="stream"`` (may instead be passed as the ``requests``
        resource); ignored by ``closed-loop``."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self.spec.source == "live":
            raise RuntimeError("live services are driven by submit()/"
                               "drain(), not run()")
        if stream is None:
            stream = self.resources.get("requests")
        if stream is not None:
            stream = list(stream)       # StreamSource sorts by offset itself
        built = self._build(stream)
        if stream:
            warmup = getattr(built.core.executor, "warmup", None)
            if warmup is not None:
                # compile before the clock starts (deadlines are ms-scale)
                warmup(min(stream, key=lambda p: p[0])[1].inputs)
        built.core.run()
        self._finish_streamer(built)
        self._finish_obs(built)
        self._last = built.recorder.result(built.core)
        self._reset_run_counters()
        return self._last

    # -- live mode -----------------------------------------------------
    def _ensure_live(self) -> _Built:
        if self._live is None:
            self._live = self._build()
            if self._live.clock.realtime:
                self._live.clock.start()
                self._thread = threading.Thread(
                    target=self._run_live, daemon=True,
                    name="repro_torch-serving-live")
                self._thread.start()
        return self._live

    def _run_live(self) -> None:
        """Engine-thread body: an engine failure must not strand waiters
        blocked in ``result()`` — fan the error out to every outstanding
        handle and surface it again at ``drain()``."""
        try:
            self._live.core.run()
        except BaseException as exc:        # noqa: BLE001 — fanout, re-raised
            self._live_error = exc
            for h in list(self._submitted):   # snapshot: cancel() mutates
                h._fail(exc)

    def _source_is_live(self) -> bool:
        """Whether this spec's source accepts submissions: ``"live"``, a
        source *resource*, registered factory, or source class carrying a
        truthy ``live`` attribute (e.g. the durable plane's front door)."""
        if self.spec.source == "live":
            return True
        inst = self.resources.get("source")
        target = inst if inst is not None \
            else resolve("source", self.spec.source)
        return bool(getattr(target, "live", False))

    def submit(self, request, slo: Optional[str] = None,
               at: Optional[float] = None, *,
               tenant: Optional[str] = None,
               request_id: Optional[str] = None) -> ResponseHandle:
        """Admit one request (``source="live"`` or any live-capable
        source).  ``slo`` picks the SLO class (``spec.default_slo``
        otherwise); ``at`` is the virtual arrival offset for
        discrete-event services (defaults to 0); ``tenant`` /
        ``request_id`` label the request in the per-request records.

        With a bounded intake (``source_args={"bound": N, "overflow":
        ...}``), an over-bound
        submission either returns an immediately-resolved *rejected*
        handle (``"reject"``) or is admitted with its optional stages
        shed (``"shed-optional"``)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if not self._source_is_live():
            raise RuntimeError("submit() needs a live-capable source "
                               "(spec.source='live'/'frontdoor', or a "
                               "source with live=True; got "
                               f"{self.spec.source!r})")
        if self._live_error is not None:
            raise RuntimeError("serving engine failed while live") \
                from self._live_error
        if tenant is not None:
            request.tenant = tenant
        if request_id is not None:
            request.request_id = request_id
        # fail fast on what the engine thread would otherwise die on:
        # unknown class names and no deadline from any source
        cls = self.spec.slo_class(slo if slo is not None
                                  else getattr(request, "slo", None))
        if request.rel_deadline is None and \
                (cls is None or cls.rel_deadline is None):
            raise ValueError("request has no rel_deadline and its SLO class "
                             "defines none")
        request.slo = slo if slo is not None else getattr(request, "slo",
                                                          None)
        handle = ResponseHandle(self, request)
        bound = self.spec.source_args.get("bound")
        if bound is not None and self._intake_depth() >= int(bound):
            t_sub = 0.0 if at is None else float(at)
            detail = {"bound": int(bound),
                      "intake_depth": self._intake_depth()}
            if self.spec.source_args.get("overflow",
                                         "reject") == "reject":
                return self._reject_overflow(handle, request, cls,
                                             rule="intake-bound",
                                             detail=detail, t=t_sub)
            request._shed = True
            self._n_shed += 1
            self._audit_intake("intake-shed", t_sub, detail, request,
                               cls.name if cls is not None else None,
                               kind="shed")
        request._handle = handle
        self._submitted.add(handle)
        if self._is_realtime():
            live = self._ensure_live()
            live.source.push(live.clock.now() if at is None else at, request)
        else:
            self._buffer.append((0.0 if at is None else float(at), request))
        return handle

    def _intake_depth(self) -> int:
        """Pending (queued, not yet engine-admitted) live submissions."""
        if not self._is_realtime():
            return len(self._buffer)
        return self._ensure_live().source.qsize()

    def _reject_overflow(self, handle: ResponseHandle, request,
                         cls: Optional[SLOClass], *,
                         rule: str = "intake-bound", detail: dict = None,
                         t: float = 0.0) -> ResponseHandle:
        """Bounded-intake fail-fast: resolve the handle rejected without
        the request ever reaching the engine.  ``rule``/``detail`` name
        the decision for the obs audit log."""
        self._n_bp_rejected += 1
        name = cls.name if cls is not None else None
        if name is not None:
            self._bp_per_class[name] = self._bp_per_class.get(name, 0) + 1
        self._audit_intake(rule, t, detail, request, name, kind="reject")
        handle._resolve(ServiceResponse(
            sample=request.sample, prediction=None, confidence=0.0,
            depth=0, missed=True, latency=0.0, deadline=0.0, slo=name,
            rejected=True))
        return handle

    def _audit_intake(self, rule: str, t: float, detail: Optional[dict],
                      request, slo: Optional[str], *, kind: str) -> None:
        """Record an intake-side scheduler decision (reject/shed before
        the engine ever saw the request) in the obs audit log.  Routed
        straight into the live tracer when one is running, buffered in
        ``_pending_audit`` otherwise (drained at build / run finish)."""
        if not (self.spec.trace and self.spec.trace.get("enabled", True)):
            return
        row = {"rule": rule, "t": float(t), "detail": detail or {},
               "kind": kind}
        rid = getattr(request, "request_id", None)
        if rid is not None:
            row["request_id"] = rid
        tenant = getattr(request, "tenant", None)
        if tenant is not None:
            row["tenant"] = tenant
        if slo is not None:
            row["slo"] = slo
        tracer = self._live.core.tracer if self._live is not None else None
        if tracer is not None:
            tracer.ingest_pending([row])
        else:
            self._pending_audit.append(row)

    def _is_realtime(self) -> bool:
        """Whether live submissions go to a background engine (wall clock)
        or buffer for drain() — decided from the actual clock the build
        will use (a clock *resource* overrides the spec key)."""
        if self._live_realtime is None:
            clock = self.resources.get("clock")
            if clock is None:
                ctx = BuildContext(spec=self.spec, resources=self.resources)
                clock = resolve("clock", self.spec.clock)(
                    self.spec.clock_args, ctx)
            self._live_realtime = bool(getattr(clock, "realtime", False))
        return self._live_realtime

    def drain(self) -> ServiceMetrics:
        """Stop intake, finish everything in flight, return final metrics.

        Idempotent and exception-safe: the live build is detached
        *before* anything can raise, so an engine failure surfaces here
        exactly once (outstanding handles were already resolved with the
        same error by the fanout) and a second ``drain()``/``close()``
        returns instead of raising again or hanging on a dead engine."""
        live, self._live = self._live, None
        if live is not None:
            live.source.close()
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            err, self._live_error = self._live_error, None
            if err is not None:
                raise RuntimeError("serving engine failed while live") \
                    from err
            self._finish_streamer(live)
            self._finish_obs(live)
            self._last = live.recorder.result(live.core)
            self._reset_run_counters()
            return self._last
        if self._buffer:
            buf, self._buffer = self._buffer, []
            built = self._build(sorted(buf, key=lambda p: p[0]))
            try:
                built.core.run()
            except BaseException as exc:
                # same contract as the wall-clock path: no waiter is left
                # stranded on a handle whose engine died
                for h in list(self._submitted):
                    h._fail(exc)
                raise
            self._finish_streamer(built)
            self._finish_obs(built)
            self._last = built.recorder.result(built.core)
            self._reset_run_counters()
            return self._last
        return self._last if self._last is not None else self.metrics()

    def _finish_streamer(self, built: _Built) -> None:
        streamer = built.recorder.streamer
        if streamer is not None:
            streamer.flush(built.core.makespan)
            self.snapshots = list(streamer.snapshots)

    def _finish_obs(self, built: _Built) -> None:
        tracer = built.core.tracer
        if tracer is not None:
            tracer.ingest_pending(self._pending_audit)
            tracer.close()          # writes configured export files

    def _reset_run_counters(self) -> None:
        """Fresh-per-run semantics for the intake/backpressure counters on
        a reused Service: the metrics just returned keep this run's
        counts; the next ``run()``/``drain()`` starts from zero, matching
        ``DeviceExecutor.device_time_stats()`` / ``cache_stats()`` (and
        keeping ``MetricsStreamer`` window deltas from going stale)."""
        self._n_cancelled = 0
        self._n_bp_rejected = 0
        self._n_shed = 0
        self._bp_per_class = {}
        self._tenant_rejects = {}

    def close(self) -> None:
        """Graceful shutdown: drain, then refuse further work.

        Idempotent, and exception-safe against a failed engine: the
        failure already reached every outstanding handle (``result()``
        raises it), so close() completes the shutdown instead of
        re-raising — callers that want the error call ``drain()``."""
        if self._closed:
            return
        self._closed = True
        try:
            self.drain()
        except Exception:
            # the engine error was fanned out to the handles; shutdown
            # itself must still finish (context-manager exit paths)
            pass

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- telemetry -----------------------------------------------------
    def metrics(self) -> ServiceMetrics:
        """Latest metrics: a live snapshot while serving, else the last
        completed run's result."""
        if self._live is not None:
            return self._live.recorder.result(self._live.core)
        if self._last is not None:
            return self._last
        return ServiceMetrics(
            accuracy=0.0, miss_rate=0.0, mean_depth=0.0, mean_conf=0.0,
            overhead_frac=0.0, n_requests=0, per_request=[],
            components=dict(policy=self.spec.policy,
                            executor=self.spec.executor,
                            clock=self.spec.clock, source=self.spec.source))
