"""Exports for the observability layer: JSONL and Chrome trace_event
(``repro.serving.obs.export``).

``write_jsonl``/``load_obs`` round-trip everything a :class:`Tracer`
recorded (traces, audit rows, device windows, metrics snapshot) through
one self-describing JSONL file — the JAX package's format, which its
``tools/planectl.py trace|why|top`` reads, so post-hoc debugging needs
no live process.  Files written by either package load in the other.

``chrome_trace`` renders the same run in Chrome ``trace_event`` format
(the JSON-object flavour: ``{"traceEvents": [...]}``) so it opens in
Perfetto / ``chrome://tracing``: device windows on overlap-free lanes
under one "device" process, each request's life on its own row under a
"requests" process, audit rows as instant events.  Timestamps are
microseconds as the format requires.
"""
from __future__ import annotations

import json
from typing import IO, List, Tuple

__all__ = ["write_jsonl", "load_obs", "chrome_trace",
           "validate_chrome_trace"]

OBS_VERSION = 1

_US = 1e6   # trace_event timestamps are microseconds


def write_jsonl(tracer, path: str) -> str:
    """Serialise ``tracer`` to ``path`` (one JSON object per line)."""
    with open(path, "w") as fh:
        _dump(tracer, fh)
    return path


def _dump(tracer, fh: IO[str]) -> None:
    head = {"type": "header", "obs_version": OBS_VERSION,
            "n_traces": len(tracer.traces),
            "n_audit": len(tracer.audit_log),
            "n_windows": len(tracer.windows)}
    fh.write(json.dumps(head) + "\n")
    for tid in sorted(tracer.traces):
        row = tracer.traces[tid].to_dict()
        row["type"] = "trace"
        fh.write(json.dumps(row) + "\n")
    for row in tracer.audit_log:
        fh.write(json.dumps({"type": "audit", **row}) + "\n")
    for w in tracer.windows:
        fh.write(json.dumps({"type": "window", "stage": w["stage"],
                             "t0": w["t0"], "t1": w["t1"], "n": w["n"],
                             "bucket": w["bucket"],
                             "tids": list(w["tids"])}) + "\n")
    if tracer.registry is not None:
        fh.write(json.dumps({"type": "metrics",
                             "metrics": tracer.registry.to_dict()}) + "\n")


def load_obs(path: str) -> dict:
    """Parse a JSONL export back into ``{header, traces, audit, windows,
    metrics}`` — traces keyed by tid, with a ``by_request_id`` index."""
    out = {"header": None, "traces": {}, "audit": [], "windows": [],
           "metrics": None, "by_request_id": {}}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.pop("type", None)
            if kind == "header":
                out["header"] = row
            elif kind == "trace":
                out["traces"][row["tid"]] = row
                rid = row.get("request_id")
                if rid is not None:
                    out["by_request_id"][rid] = row["tid"]
            elif kind == "audit":
                out["audit"].append(row)
            elif kind == "window":
                out["windows"].append(row)
            elif kind == "metrics":
                out["metrics"] = row["metrics"]
    return out


def _assign_lanes(windows: List[dict]) -> List[Tuple[int, dict]]:
    """Greedy interval-graph colouring: overlapping windows get distinct
    lanes so Perfetto draws them side by side instead of merged."""
    lanes_end: List[float] = []
    placed = []
    for w in sorted(windows, key=lambda w: (w["t0"], w["t1"])):
        lane = None
        for i, end in enumerate(lanes_end):
            if w["t0"] >= end - 1e-12:
                lane = i
                break
        if lane is None:
            lane = len(lanes_end)
            lanes_end.append(w["t1"])
        else:
            lanes_end[lane] = w["t1"]
        placed.append((lane, w))
    return placed


def chrome_trace(tracer) -> dict:
    """Render the tracer's run as a Chrome ``trace_event`` document."""
    ev: List[dict] = []
    ev.append({"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
               "args": {"name": "device"}})
    ev.append({"ph": "M", "name": "process_name", "pid": 2, "tid": 0,
               "args": {"name": "requests"}})
    placed = _assign_lanes(tracer.windows)
    n_lanes = 1 + max((lane for lane, _ in placed), default=-1)
    for lane in range(n_lanes):
        ev.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": lane,
                   "args": {"name": f"window lane {lane}"}})
    for lane, w in placed:
        ev.append({"ph": "X", "name": f"stage {w['stage']} x{w['n']}",
                   "cat": "device-window", "pid": 1, "tid": lane,
                   "ts": w["t0"] * _US,
                   "dur": max(w["t1"] - w["t0"], 0.0) * _US,
                   "args": {"stage": w["stage"], "n": w["n"],
                            "bucket": w["bucket"]}})
    for tid in sorted(tracer.traces):
        tr = tracer.traces[tid]
        label = tr.request_id or f"tid {tid}"
        ev.append({"ph": "M", "name": "thread_name", "pid": 2, "tid": tid,
                   "args": {"name": str(label)}})
        for s in tr.spans:
            if s.t1 > s.t0:
                ev.append({"ph": "X", "name": s.name, "cat": "request",
                           "pid": 2, "tid": tid, "ts": s.t0 * _US,
                           "dur": (s.t1 - s.t0) * _US,
                           "args": dict(s.attrs)})
            else:
                ev.append({"ph": "i", "name": s.name, "cat": "request",
                           "pid": 2, "tid": tid, "ts": s.t0 * _US,
                           "s": "t", "args": dict(s.attrs)})
    for row in tracer.audit_log:
        ev.append({"ph": "i", "name": row["rule"], "cat": "audit",
                   "pid": 2, "tid": row.get("tid", 0),
                   "ts": row["t"] * _US, "s": "p",
                   "args": dict(row.get("detail", {}))})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: dict) -> List[str]:
    """Check ``doc`` against the trace_event schema essentials; returns a
    list of problems (empty == valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    ev = doc.get("traceEvents")
    if not isinstance(ev, list):
        return ["missing traceEvents array"]
    for i, e in enumerate(ev):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if "name" not in e:
            problems.append(f"{where}: missing name")
        if "pid" not in e or "tid" not in e:
            problems.append(f"{where}: missing pid/tid")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("t", "p", "g", None):
            problems.append(f"{where}: bad scope {e.get('s')!r}")
    return problems
