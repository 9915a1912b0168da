"""Per-class request mixes: *what* arrives, composed with *when*
(``repro.serving.traffic.mix``).

An arrival process (:mod:`repro_torch.serving.traffic.generators`) produces the
offsets; a :class:`RequestMix` stamps each offset into a concrete
:class:`~repro_torch.serving.engine.Request` — which SLO class it belongs to
(deadline / utility weight / depth cap come from ``spec.slo_classes`` at
admission), which dataset sample it carries, and optionally an explicit
per-class relative deadline or deadline range overriding the SLO default.

Classes are drawn independently per request with probability proportional
to ``share`` and samples uniformly from ``[0, n_samples)`` — both from the
same seeded generator as the arrival offsets, so a traffic trace is one
deterministic function of (arrival args, mix args, seed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serving.engine import Request


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One slice of the mix.

    ``slo`` names a ``spec.slo_classes`` tier (may be None when
    ``rel_deadline``/``rel_range`` is given here); ``share`` is the
    relative mix probability.  ``rel_deadline`` pins a fixed relative
    deadline; ``rel_range = (lo, hi)`` draws one per request U[lo, hi]
    (the paper's §IV deadline model).  When both are None the SLO class
    supplies the deadline at admission.  ``seq_range = (lo, hi)`` draws a
    ragged input length U{lo..hi} per request and stamps it into
    ``Request.seq_len`` — admission and batching then price the request
    by its length bucket (``LengthBucketTimeModel``), and same-stage
    co-runners batch only within a bucket.  ``model`` stamps a model-zoo
    id into ``Request.model`` (the zoo that routes it to its own model is
    ROADMAP Queue A item 9b); ``None`` keeps the single-model path
    untouched.
    """

    slo: Optional[str] = None
    share: float = 1.0
    rel_deadline: Optional[float] = None
    rel_range: Optional[tuple] = None
    seq_range: Optional[tuple] = None
    model: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficClass":
        rr = d.get("rel_range")
        sr = d.get("seq_range")
        return cls(slo=d.get("slo"), share=float(d.get("share", 1.0)),
                   rel_deadline=d.get("rel_deadline"),
                   rel_range=tuple(rr) if rr is not None else None,
                   seq_range=tuple(sr) if sr is not None else None,
                   model=d.get("model"))

    def to_dict(self) -> dict:
        d = {"slo": self.slo, "share": self.share}
        if self.rel_deadline is not None:
            d["rel_deadline"] = self.rel_deadline
        if self.rel_range is not None:
            d["rel_range"] = list(self.rel_range)
        if self.seq_range is not None:
            d["seq_range"] = list(self.seq_range)
        if self.model is not None:
            d["model"] = self.model
        return d


class RequestMix:
    """Stamp arrival offsets into concrete per-class requests.

    ``inputs_fn`` (optional) maps a sample index to the request's input
    dict — required only by device executors; the oracle executor reads
    per-sample tables and ignores inputs.
    """

    def __init__(self, classes, n_samples: int, inputs_fn=None):
        self.classes = tuple(
            c if isinstance(c, TrafficClass) else TrafficClass.from_dict(c)
            for c in classes) or (TrafficClass(),)
        shares = np.asarray([c.share for c in self.classes], dtype=float)
        if (shares <= 0).any():
            raise ValueError("every TrafficClass.share must be > 0")
        self._probs = shares / shares.sum()
        self.n_samples = int(n_samples)
        self.inputs_fn = inputs_fn

    def make_request(self, rng: np.random.Generator, offset: float,
                     client: int) -> Request:
        ci = int(rng.choice(len(self.classes), p=self._probs))
        c = self.classes[ci]
        rel = c.rel_deadline
        if c.rel_range is not None:
            rel = float(rng.uniform(*c.rel_range))
        sample = int(rng.integers(self.n_samples))
        seq_len = None
        if c.seq_range is not None:
            lo, hi = c.seq_range
            seq_len = int(rng.integers(int(lo), int(hi) + 1))
        inputs = self.inputs_fn(sample) if self.inputs_fn is not None else None
        return Request(inputs=inputs, rel_deadline=rel, sample=sample,
                       client=client, arrival=float(offset), slo=c.slo,
                       seq_len=seq_len, model=c.model)

    def stream(self, rng: np.random.Generator, offsets) -> list:
        """The full open-loop stream: [(offset, Request)] in arrival order
        (``client`` numbers the arrivals)."""
        return [(float(off), self.make_request(rng, float(off), i))
                for i, off in enumerate(offsets)]

    def to_dicts(self) -> list:
        return [c.to_dict() for c in self.classes]
