"""Seeded open-loop arrival processes (paper §IV's missing other half;
``repro.serving.traffic.generators``).

The paper evaluates the scheduler under one *closed-loop* K-client
workload — the server's own completions pace the offered load, so the
system can never be pushed past saturation.  Real services face the
opposite regime: arrivals keep coming on *their* schedule whether or not
the server keeps up (DeepRT's bursty admission-control evaluation; the
"Adaptive Scheduling for Edge-Assisted DNN Serving" observation that
policy rankings flip between steady and bursty traffic).  This module
provides the arrival half of that regime as composable, seeded processes:

* ``PoissonArrivals``    — homogeneous rate λ (steady traffic).
* ``MMPPArrivals``       — 2-state Markov-modulated Poisson process
  (on/off bursts: exponential dwell in a quiet and a burst state, Poisson
  arrivals at the state's rate).
* ``DiurnalArrivals``    — sinusoidal rate ramp between a trough and a
  peak over a configurable period (the day/night load curve, compressed).
* ``FlashCrowdArrivals`` — constant base rate with a rectangular spike
  (rate × ``spike_rate`` during ``[spike_at, spike_at + spike_len]``).

Every process is a pure function of the ``numpy`` Generator handed to
``sample`` — same seed, same arrival sequence, across processes and hosts
(tests/test_torch_traffic.py holds them to the JAX package's offsets
bit for bit).  Time-varying processes sample by
Lewis–Shedler thinning against their rate bound, so one uniform draw pair
per candidate keeps the draw order reproducible.

Example — every kind builds from its JSON-able description, and the same
seed always reproduces the same offsets:

```python
import numpy as np
from repro_torch.serving.traffic.generators import make_arrival_process

for kind, args in (("poisson", {"rate": 50.0}),
                   ("mmpp", {"rate_on": 120.0, "rate_off": 10.0,
                             "mean_on": 0.2, "mean_off": 0.8}),
                   ("diurnal", {"base_rate": 10.0, "peak_rate": 80.0,
                                "period": 4.0}),
                   ("flash-crowd", {"base_rate": 30.0, "spike_rate": 5.0,
                                    "spike_at": 1.0, "spike_len": 0.5})):
    p = make_arrival_process(kind, **args)
    offs = p.sample(np.random.default_rng(7), n=100)
    assert len(offs) == 100 and (np.diff(offs) >= 0).all()
    again = p.sample(np.random.default_rng(7), n=100)
    assert (offs == again).all()          # seeded determinism
```
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# registry of arrival kinds: name -> constructor (dataclass below)
ARRIVAL_KINDS: dict = {}


def register_arrival(kind: str):
    def deco(cls):
        ARRIVAL_KINDS[kind] = cls
        cls.kind = kind
        return cls
    return deco


def make_arrival_process(kind: str, **args) -> "ArrivalProcess":
    """Build an arrival process from its JSON-able description."""
    try:
        cls = ARRIVAL_KINDS[kind]
    except KeyError:
        raise KeyError(f"no arrival process registered under {kind!r}; "
                       f"available: {sorted(ARRIVAL_KINDS)}") from None
    return cls(**args)


class ArrivalProcess:
    """Base: a (possibly time-varying) rate λ(t) sampled into offsets."""

    kind = "base"

    @property
    def mean_rate(self) -> float:
        """Long-run average arrivals/second (tests check empirical rates
        against this)."""
        raise NotImplementedError

    def rate_at(self, t: float) -> float:
        """Instantaneous rate λ(t)."""
        raise NotImplementedError

    def rate_bound(self) -> float:
        """An upper bound on λ(t) — the thinning envelope."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def sample(self, rng: np.random.Generator, *, n: int = None,
               horizon: float = None) -> np.ndarray:
        """Sorted arrival offsets: the first ``n`` arrivals, or every
        arrival in ``[0, horizon)`` (at least one bound required).

        Default implementation: thinning against ``rate_bound()``.
        """
        if n is None and horizon is None:
            raise ValueError("sample() needs n and/or horizon")
        lam = self.rate_bound()
        if lam <= 0:
            return np.empty(0)
        out, t = [], 0.0
        while (n is None or len(out) < n) \
                and (horizon is None or t < horizon):
            t += rng.exponential(1.0 / lam)
            if horizon is not None and t >= horizon:
                break
            if rng.uniform() * lam <= self.rate_at(t):
                out.append(t)
        return np.asarray(out)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@register_arrival("poisson")
@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` per second."""

    rate: float

    @property
    def mean_rate(self) -> float:
        return self.rate

    def rate_at(self, t: float) -> float:
        return self.rate

    def rate_bound(self) -> float:
        return self.rate

    def sample(self, rng, *, n=None, horizon=None) -> np.ndarray:
        # exact gap sampling (no thinning rejections to replay)
        if n is None and horizon is None:
            raise ValueError("sample() needs n and/or horizon")
        if self.rate <= 0:
            return np.empty(0)
        if n is not None:
            t = np.cumsum(rng.exponential(1.0 / self.rate, size=n))
            return t if horizon is None else t[t < horizon]
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t >= horizon:
                return np.asarray(out)
            out.append(t)


@register_arrival("mmpp")
@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (on/off bursts).

    Dwell times in the quiet (``rate_off``) and burst (``rate_on``)
    states are exponential with means ``mean_off`` / ``mean_on`` seconds;
    within a state, arrivals are Poisson at that state's rate.  The
    process starts quiet.
    """

    rate_on: float
    rate_off: float
    mean_on: float = 0.5
    mean_off: float = 1.5

    @property
    def mean_rate(self) -> float:
        tot = self.mean_on + self.mean_off
        return (self.rate_on * self.mean_on
                + self.rate_off * self.mean_off) / tot

    def rate_bound(self) -> float:
        return max(self.rate_on, self.rate_off)

    def sample(self, rng, *, n=None, horizon=None) -> np.ndarray:
        if n is None and horizon is None:
            raise ValueError("sample() needs n and/or horizon")
        out, t, on = [], 0.0, False
        while (n is None or len(out) < n) \
                and (horizon is None or t < horizon):
            dwell = rng.exponential(self.mean_on if on else self.mean_off)
            rate = self.rate_on if on else self.rate_off
            t_end = t + dwell
            while rate > 0:
                t += rng.exponential(1.0 / rate)
                if t >= t_end or (horizon is not None and t >= horizon):
                    break
                out.append(t)
                if n is not None and len(out) >= n:
                    break
            t = min(t, t_end) if rate > 0 else t_end
            on = not on
        return np.asarray(out[:n] if n is not None else out)

    def rate_at(self, t: float) -> float:    # pragma: no cover - not thinned
        raise NotImplementedError("MMPP rate is state-dependent")


@register_arrival("diurnal")
@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal ramp: λ(t) sweeps ``base_rate`` → ``peak_rate`` → back
    over each ``period`` seconds (trough at t = 0)."""

    base_rate: float
    peak_rate: float
    period: float = 10.0

    @property
    def mean_rate(self) -> float:
        return 0.5 * (self.base_rate + self.peak_rate)

    def rate_at(self, t: float) -> float:
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period))
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def rate_bound(self) -> float:
        return max(self.base_rate, self.peak_rate)


@register_arrival("flash-crowd")
@dataclasses.dataclass(frozen=True)
class FlashCrowdArrivals(ArrivalProcess):
    """Constant ``base_rate`` with a rectangular spike to ``spike_rate``
    during ``[spike_at, spike_at + spike_len]`` — the load a scheduler
    cannot have planned for."""

    base_rate: float
    spike_rate: float
    spike_at: float = 1.0
    spike_len: float = 1.0

    @property
    def mean_rate(self) -> float:
        """Rate averaged over ``[0, spike_at + 2 * spike_len]`` (a
        representative window; the process is not periodic)."""
        span = self.spike_at + 2.0 * self.spike_len
        burst = self.spike_len * (self.spike_rate - self.base_rate)
        return self.base_rate + burst / span

    def rate_at(self, t: float) -> float:
        if self.spike_at <= t < self.spike_at + self.spike_len:
            return self.spike_rate
        return self.base_rate

    def rate_bound(self) -> float:
        return max(self.base_rate, self.spike_rate)
