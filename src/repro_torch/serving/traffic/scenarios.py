"""Named traffic scenarios — the catalog the launchers and tests share
(``repro.serving.traffic.scenarios``).

A :class:`Scenario` is a JSON-able description of *offered load relative
to service capacity*: its arrival-process rates are load **factors**
scaled at build time by the nominal full-depth service rate
``1 / sum(stage_times)`` (the unbatched engine's best sustained
throughput when every request runs all stages).  A factor of 2.0 is the
"2x sustained overload" regime of the headline claim — impossible to
express with the closed-loop workload, which can never offer more than
the server completes.

Catalog (see README for the table):

==============  ============================================================
``steady``      Poisson at 0.6x capacity — the in-regime baseline.
``2x-overload`` Poisson at 2.0x capacity, sustained — the headline claim:
                admission/shedding holds deadline misses near zero with
                bounded accuracy loss; uncontrolled EDF collapses.
``flash-crowd`` 0.7x base with a 5x rectangular spike — transient
                overload; assert on windowed metrics, not aggregates.
``diurnal``     sinusoidal 0.3x–1.8x ramp — rankings under a moving
                operating point.
``model-mix``   two-model zoo (llm + vision) at 2.0x capacity — the
                cross-model shedding claim: each class stamps a model id
                into ``Request.model``.  The zoo is ROADMAP Queue A item
                9b: :func:`scenario_spec` raises ``NotImplementedError``
                for it.
==============  ============================================================

Every scenario shares one three-tier SLO mix (gold/silver/bronze:
descending deadline and utility weight), so per-class breakdowns compare
across scenarios.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.service import ServeSpec

# arrival-config keys that are load factors (scaled by the nominal rate);
# everything else (dwell times, spike instants, periods) is absolute seconds
_RATE_KEYS = ("rate", "rate_on", "rate_off", "base_rate", "peak_rate",
              "spike_rate")

#: shared SLO tiers: relative deadline (s), utility weight — the per-class
#: request mix every scenario draws from
SLO_CLASSES = {
    "gold": {"rel_deadline": 0.24, "utility_weight": 2.0},
    "silver": {"rel_deadline": 0.14, "utility_weight": 1.0},
    "bronze": {"rel_deadline": 0.07, "utility_weight": 0.5},
}

DEFAULT_MIX = ({"slo": "gold", "share": 0.2},
               {"slo": "silver", "share": 0.5},
               {"slo": "bronze", "share": 0.3})

#: two-model zoo mix (the zoo is ROADMAP Queue A item 9b): an expensive
#: high-value "llm" head and a cheap "vision" model sharing one device,
#: split across the SLO tiers — what the ``model-mix`` scenario stamps into
#: ``Request.model``
MODEL_MIX = ({"slo": "gold", "share": 0.15, "model": "llm"},
             {"slo": "silver", "share": 0.25, "model": "llm"},
             {"slo": "gold", "share": 0.15, "model": "vision"},
             {"slo": "silver", "share": 0.25, "model": "vision"},
             {"slo": "bronze", "share": 0.2, "model": "vision"})


def nominal_rate(stage_times) -> float:
    """Full-depth, singleton-batch service rate (requests/second)."""
    return 1.0 / float(sum(stage_times))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named load shape; ``arrival`` rates are load factors."""

    name: str
    description: str
    arrival: dict
    n_requests: int = 600
    mix: tuple = DEFAULT_MIX

    def scaled_arrival(self, stage_times=None, *,
                       capacity: float = None) -> dict:
        """Arrival rates scaled by ``nominal_rate(stage_times)``, or by a
        measured ``capacity`` (requests/second) when one is given — a
        batching device serves far more than the singleton rate, so load
        legs on the card scale from what it sustains."""
        nom = float(capacity) if capacity is not None \
            else nominal_rate(stage_times)
        return {k: (v * nom if k in _RATE_KEYS else v)
                for k, v in self.arrival.items()}

    def source_args(self, stage_times=None, *, n_requests: int = None,
                    seed: int = 0, capacity: float = None) -> dict:
        return dict(arrival=self.scaled_arrival(stage_times,
                                                capacity=capacity),
                    mix=[dict(c) for c in self.mix],
                    n_requests=n_requests or self.n_requests, seed=seed)


SCENARIOS = {
    s.name: s for s in (
        Scenario("steady",
                 "Poisson at 0.6x capacity: everyone should do well",
                 {"kind": "poisson", "rate": 0.6}),
        Scenario("2x-overload",
                 "sustained 2x capacity: the admission-control claim",
                 {"kind": "poisson", "rate": 2.0}),
        Scenario("flash-crowd",
                 "0.7x base, 5x spike at t=2s for 1.5s: transient overload",
                 {"kind": "flash-crowd", "base_rate": 0.7, "spike_rate": 5.0,
                  "spike_at": 2.0, "spike_len": 1.5}),
        Scenario("diurnal",
                 "sinusoidal 0.3x-1.8x ramp, 8s period: moving load",
                 {"kind": "diurnal", "base_rate": 0.3, "peak_rate": 1.8,
                  "period": 8.0}),
        Scenario("model-mix",
                 "two-model zoo (llm + vision) at 2x capacity: "
                 "cross-model shedding under mixed overload",
                 {"kind": "poisson", "rate": 2.0}, mix=MODEL_MIX),
    )
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"no scenario named {name!r}; "
                       f"available: {sorted(SCENARIOS)}") from None


def scenario_spec(name: str, *, policy: str = "rtdeepiot",
                  policy_args: dict = None, admission: dict = None,
                  stage_times, n_requests: int = None, seed: int = 0,
                  metrics_interval: float = 0.0, **spec_kw) -> ServeSpec:
    """The scenario as a ready-to-run ``ServeSpec`` (oracle executor,
    virtual clock, ``traffic`` source, unbatched pricing) — resources
    (``conf_table``/``correct_table``) still come from the caller.
    ``model-mix`` needs the model zoo, which is not ported yet."""
    scen = get_scenario(name)
    if any(c.get("model") is not None for c in scen.mix):
        raise NotImplementedError(
            f"scenario {name!r} routes requests through the model zoo, which "
            "is not ported to repro_torch yet (ROADMAP Queue A item 9b)")
    return ServeSpec(
        policy=policy, policy_args=policy_args or {},
        executor="oracle", clock="virtual", source="traffic",
        source_args=scen.source_args(stage_times, n_requests=n_requests,
                                     seed=seed),
        batching={"mode": "none",
                  "stage_times": [float(x) for x in stage_times]},
        admission=admission or {}, slo_classes=dict(SLO_CLASSES),
        metrics_interval=metrics_interval, **spec_kw)
