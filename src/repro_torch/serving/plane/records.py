"""One record codec for traces *and* the write-ahead journal
(``repro.serving.plane.records``).

A :class:`Record` is one JSONL line — when/what arrived, who sent it, and
(optionally) what happened.  Trace record/replay
(:mod:`repro_torch.serving.traffic.trace`) writes and reads it; the
durable plane's journal, which shares the format in the JAX package, is
not ported yet (ROADMAP Queue A item 9b).  ``kind`` distinguishes the
journal's state transitions; plain trace events keep the default
``EVENT`` and serialize byte-identically to the version-1 lines, so
checked-in traces keep replaying and old readers keep working.

Record kinds (the journal's)::

    SUBMIT   a request was accepted for durable execution
    ADMIT    the engine turned the request into a Task
    STAGE    one anytime stage exit completed in time
    RETIRE   the request left the system with its final outcome
    REJECT   the request was refused (admission control / tenant quota)
    EVENT    a plain trace row (record/replay; the version-1 schema)

Version history: 1 — trace events only (no ``kind``); 2 — this unified
schema (``kind`` + ``tenant``/``request_id``/``seq`` fields, emitted
only when set, so EVENT rows are unchanged on disk).  The optional
``model`` field follows the same emit-only-when-set rule, so v1 and v2
files without it round-trip byte-identically, in this package and the
JAX one alike.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.serving.engine import Request

RECORD_VERSION = 2

RECORD_KINDS = ("SUBMIT", "ADMIT", "STAGE", "RETIRE", "REJECT", "EVENT")

#: terminal kinds: the request left the system, outcome attached
TERMINAL_KINDS = ("RETIRE", "REJECT")


@dataclasses.dataclass(frozen=True)
class Record:
    """One recorded request event: arrival identity + optional outcome."""

    offset: float
    sample: int = 0
    client: int = 0
    slo: Optional[str] = None
    rel_deadline: Optional[float] = None
    outcome: Optional[dict] = None
    kind: str = "EVENT"
    tenant: Optional[str] = None
    request_id: Optional[str] = None
    seq: Optional[int] = None          # journal offset (monotonic append)
    model: Optional[str] = None        # model-zoo id (emitted only when set)

    def to_json(self) -> str:
        d = dict(offset=self.offset, sample=self.sample, client=self.client,
                 slo=self.slo, rel_deadline=self.rel_deadline)
        if self.kind != "EVENT":
            d["kind"] = self.kind
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.model is not None:
            d["model"] = self.model
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.seq is not None:
            d["seq"] = self.seq
        if self.outcome is not None:
            d["outcome"] = self.outcome
        return json.dumps(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Record":
        # tolerant of version-1 lines: no kind/tenant/request_id/seq
        kind = d.get("kind", "EVENT")
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown record kind {kind!r}; "
                             f"known: {RECORD_KINDS}")
        seq = d.get("seq")
        return cls(offset=float(d["offset"]), sample=int(d.get("sample", 0)),
                   client=int(d.get("client", 0)), slo=d.get("slo"),
                   rel_deadline=d.get("rel_deadline"),
                   outcome=d.get("outcome"), kind=kind,
                   tenant=d.get("tenant"), request_id=d.get("request_id"),
                   seq=int(seq) if seq is not None else None,
                   model=d.get("model"))

    def request(self) -> Request:
        """Re-materialize the submission this record describes."""
        return Request(inputs=None, rel_deadline=self.rel_deadline,
                       sample=self.sample, client=self.client,
                       arrival=self.offset, slo=self.slo,
                       tenant=self.tenant, request_id=self.request_id,
                       model=self.model)

    def dedup_key(self):
        """Idempotent-append key: a journal refuses a second record with
        the same key (``None`` — anonymous records — never dedup).
        STAGE records key on depth too: one request exits many stages."""
        if self.request_id is None:
            return None
        if self.kind == "STAGE":
            return (self.kind, self.request_id,
                    (self.outcome or {}).get("depth"))
        return (self.kind, self.request_id)
