"""Trace record/replay: regression-grade load tests from recorded runs
(``repro.serving.traffic.trace``).

**Record**: :class:`TraceRecorder` captures a finished run's request
sequence — ``(offset, sample, slo, rel_deadline, client)`` straight from
``ServiceMetrics.per_request`` (which the :class:`ServiceRecorder` orders
by admission) — plus each request's observed outcome (depth, missed,
rejected, latency, deadline) into a JSONL trace: one header line, one
event line per request, sorted by admission order.

**Replay**: ``register_source("replay")`` re-injects a trace through the
engine's task factory as a plain request stream.  Under the virtual clock
with the same ``ServeSpec`` (same batching/time model, SLO classes,
admission config and policy), the engine is a deterministic function of
the arrival sequence — so a replay reproduces the original run's arrival
order *and* admission decisions bit-for-bit
(:func:`verify_replay` checks exactly that).  On the wall clock the
arrival order still holds; admission decisions then follow wall time.

Scope: bit-for-bit holds for factory-built sources (``traffic`` /
``stream`` / ``live``), where ``rel_deadline`` passes through the same
§II-B adjustment again.  Closed-loop traces replay with re-adjusted
deadlines (the legacy source applies no adjustment), which is useful for
load shape but not bit-exact.

Schema: a trace line is a
:class:`~repro_torch.serving.plane.records.Record` (the codec the JAX
package's durable-plane journal shares) with the default ``EVENT`` kind::

    {"type": "header", "version": 2, "n_events": N,
     "source": "...", "spec": {...}?}            # spec: optional ServeSpec
    {"offset": 0.0123, "sample": 42, "client": 0, "slo": "gold",
     "rel_deadline": 0.2,
     "outcome": {"depth": 2, "missed": false, "rejected": false,
                 "latency": 0.017, "deadline": 0.2023, "conf": 0.91,
                 "weight": 2.0}}

Version history: 1 — the same event lines, before the schema was unified
with the journal (no ``kind``/``tenant``/``request_id`` fields).
Version-1 traces load unchanged (``EVENT`` is the default kind), and
``EVENT`` rows without plane fields still serialize byte-identically to
version 1.  A trace written by either package loads in the other.
"""
from __future__ import annotations

import json

from repro_torch.serving.engine import Request  # noqa: F401 — legacy re-export
from repro_torch.serving.plane.records import RECORD_VERSION, Record
from repro_torch.serving.registry import register_source
from repro_torch.serving.runtime.sources import StreamSource

TRACE_VERSION = RECORD_VERSION

_OUTCOME_KEYS = ("depth", "missed", "rejected", "latency", "deadline",
                 "conf", "weight", "depth_cap")

#: one schema for traces and the journal (repro_torch.serving.plane.records):
#: a trace event is a Record of the default ``EVENT`` kind
TraceEvent = Record


class TraceRecorder:
    """Collects :class:`TraceEvent` rows from finished runs.

    ``capture(metrics)`` pulls every request of a ``ServiceMetrics`` /
    ``SimResult`` (its ``per_request`` rows must be present — run the
    service, then capture); ``write(path)`` emits the JSONL file.
    """

    def __init__(self, source: str = "unknown", spec=None):
        self.source = source
        self.spec = spec            # optional ServeSpec (stored in header)
        self.events: list = []

    def capture(self, metrics) -> list:
        recs = sorted(metrics.per_request, key=lambda r: r["tid"])
        for r in recs:
            offset = float(r.get("offset", r["arrival"]))
            rel = r.get("rel_deadline")
            if rel is None:
                # closed-loop records: effective (already-adjusted) slack
                rel = float(r["deadline"]) - offset
            outcome = {k: r[k] for k in _OUTCOME_KEYS if k in r}
            self.events.append(TraceEvent(
                offset=offset, sample=int(r["sample"]),
                client=int(r.get("client", 0)), slo=r.get("slo"),
                rel_deadline=float(rel), outcome=outcome,
                tenant=r.get("tenant"), request_id=r.get("request_id"),
                model=r.get("model")))
        return self.events

    def header(self) -> dict:
        h = dict(type="header", version=TRACE_VERSION,
                 n_events=len(self.events), source=self.source)
        if self.spec is not None:
            h["spec"] = self.spec.to_dict()
        return h

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(json.dumps(self.header()) + "\n")
            for ev in self.events:
                f.write(ev.to_json() + "\n")
        return path


def record_trace(metrics, path: str, *, source: str = "unknown",
                 spec=None) -> TraceRecorder:
    """One-shot: capture ``metrics`` and write the JSONL trace."""
    rec = TraceRecorder(source=source, spec=spec)
    rec.capture(metrics)
    rec.write(path)
    return rec


def load_trace(path: str) -> tuple:
    """Parse a JSONL trace -> (header dict, [TraceEvent]).  Reads both
    version-1 (pre-unification) and version-2 files."""
    header, events = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type") == "header":
                header = d
            else:
                events.append(TraceEvent.from_dict(d))
    v = header.get("version")
    if v is not None and int(v) > TRACE_VERSION:
        raise ValueError(f"trace {path!r} is version {v}; this reader "
                         f"handles <= {TRACE_VERSION}")
    n = header.get("n_events")
    if n is not None and n != len(events):
        raise ValueError(f"trace {path!r} declares {n} events, "
                         f"found {len(events)}")
    return header, events


def replay_stream(events, inputs_fn=None) -> list:
    """[(offset, Request)] re-materialized from trace events, in recorded
    admission order.  A trace records sample indices, not inputs:
    ``inputs_fn`` (sample index -> input dict, the ``traffic_inputs``
    resource) gives each request its inputs back for device executors."""
    stream = [(ev.offset, ev.request()) for ev in events]
    if inputs_fn is not None:
        for _, req in stream:
            req.inputs = inputs_fn(req.sample)
    return stream


def arrival_signature(per_request) -> list:
    """The replay-comparable arrival sequence of a run: per admitted-order
    request, (offset, sample, slo, rel_deadline)."""
    recs = sorted(per_request, key=lambda r: r["tid"])
    return [(round(float(r.get("offset", r["arrival"])), 12), r["sample"],
             r.get("slo"), r.get("rel_deadline"), r.get("model"))
            for r in recs]


def admission_signature(per_request) -> list:
    """The replay-comparable admission/outcome sequence: per
    admitted-order request, (rejected, depth_cap, depth, missed)."""
    recs = sorted(per_request, key=lambda r: r["tid"])
    return [(bool(r["rejected"]), r.get("depth_cap"), r["depth"],
             bool(r["missed"])) for r in recs]


def verify_replay(original, replayed) -> dict:
    """Compare two runs' per_request rows: did the replay reproduce the
    original's arrival order and admission decisions bit-for-bit?"""
    arr_ok = arrival_signature(original) == arrival_signature(replayed)
    adm_ok = admission_signature(original) == admission_signature(replayed)
    return dict(arrival_order=arr_ok, admission_decisions=adm_ok,
                bitwise=arr_ok and adm_ok)


@register_source("replay")
def _make_replay(args: dict, ctx):
    """Trace replay.  ``source_args={"path": ...}`` or a ``trace``
    resource ([TraceEvent] or a parsed (header, events) pair); an optional
    ``traffic_inputs`` resource re-attaches each request's inputs."""
    trace = ctx.resources.get("trace")
    if trace is None:
        path = args.get("path")
        if path is None:
            raise KeyError("source='replay' needs source_args={'path': ...} "
                           "or a 'trace' resource")
        _, events = load_trace(path)
    else:
        events = trace[1] if isinstance(trace, tuple) else trace
    return StreamSource(replay_stream(events,
                                      ctx.resources.get("traffic_inputs")),
                        ctx.task_factory)
