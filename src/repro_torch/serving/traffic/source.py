"""``register_source("traffic")`` — the open-loop front of the subsystem
(``repro.serving.traffic.source``).

A ``TrafficSource`` composes a seeded arrival process with a per-class
request mix into a pre-materialized ``(offset, Request)`` stream and
feeds it through the engine's task factory, exactly like ``StreamSource``
— which is the point: arrivals keep their schedule regardless of
completions (unlike ``ClosedLoopSource``, whose clients wait for their
previous request), so sustained overload, bursts, flash crowds and
diurnal ramps are all expressible.

Registered from *outside* ``repro_torch.serving.runtime`` — the registry
extension-point proof at subsystem scale: no core-loop changes.

``source_args`` (all JSON-able, so the whole scenario round-trips through
``ServeSpec``)::

    {"arrival": {"kind": "poisson", "rate": 80.0},   # generators.py kinds
     "mix": [{"slo": "gold", "share": 1.0}, ...],    # mix.py classes
     "n_requests": 500,          # and/or "horizon": seconds
     "seed": 0}

Resources: ``n_samples`` (or a ``conf_table`` whose first axis is the
sample count) sizes the sample draw; an optional ``traffic_inputs``
callable maps sample index -> input dict for device executors.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.registry import register_source
from repro_torch.serving.runtime.sources import StreamSource
from repro_torch.serving.traffic.generators import (ArrivalProcess,
                                              make_arrival_process)
from repro_torch.serving.traffic.mix import RequestMix


class TrafficSource(StreamSource):
    """Open-loop generated traffic behind the ``StreamSource`` contract."""

    def __init__(self, arrival: ArrivalProcess, mix: RequestMix,
                 task_factory, *, n_requests: int = None,
                 horizon: float = None, seed: int = 0):
        rng = np.random.default_rng(seed)
        offsets = arrival.sample(rng, n=n_requests, horizon=horizon)
        super().__init__(mix.stream(rng, offsets), task_factory)
        self.arrival = arrival
        self.mix = mix
        self.seed = seed

    @property
    def offsets(self) -> np.ndarray:
        return np.asarray([off for off, _ in self.pending])


@register_source("traffic")
def _make_traffic(args: dict, ctx):
    arrival_cfg = dict(args.get("arrival") or {"kind": "poisson", "rate": 1.0})
    arrival = make_arrival_process(arrival_cfg.pop("kind"), **arrival_cfg)
    n_samples = ctx.resources.get("n_samples")
    if n_samples is None:
        table = ctx.resources.get("conf_table")
        if table is None:
            raise KeyError("source='traffic' needs an 'n_samples' or "
                           "'conf_table' resource to size the sample draw")
        n_samples = int(np.asarray(table).shape[0])
    mix = RequestMix(args.get("mix") or [{}], n_samples,
                     inputs_fn=ctx.resources.get("traffic_inputs"))
    n_requests = args.get("n_requests")
    horizon = args.get("horizon")
    if n_requests is None and horizon is None:
        raise ValueError("source='traffic' needs 'n_requests' and/or "
                         "'horizon' in source_args")
    return TrafficSource(arrival, mix, ctx.task_factory,
                         n_requests=n_requests, horizon=horizon,
                         seed=int(args.get("seed", 0)))
