"""The port's ``simulate_batched`` against the JAX function's live output.

Both packages run the same closed-loop workload over the same oracle
tables and batch time model; the result must agree field for field (all
but ``overhead_frac``, a ratio over the policies' own wall time, and each
request's process-wide task id) for every built-in policy, and with an
``AdmissionController``, ``charge_overhead``, ``dispatch_overhead`` and
``max_batch``.  The runtime core measures the host time of each scheduling
call (its ``sched_charged`` / ``host_serial`` telemetry, and with
``charge_overhead`` the virtual clock's charges); both cores' clocks are
replaced by one that advances a fixed binary step a reading, so what is
measured is the same in both.  ``tests/test_batching.py``'s claim, batched
serving beating unbatched throughput, is held on the port.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest

import repro.serving.runtime.core as jax_core
import repro_torch.serving.runtime.core as port_core
from repro import core as jax_core_pkg
from repro.serving.batch import AdmissionController as JaxAdmission
from repro.serving.batch import BatchTimeModel as JaxBatchTimeModel
from repro.serving.batch import simulate_batched as jax_simulate_batched
from repro.serving.deprecation import _reset as jax_reset_deprecations
from repro_torch import core
from repro_torch.serving.batch import (AdmissionController, BatchTimeModel,
                                       simulate_batched)
from repro_torch.serving import deprecation

STAGE_TIMES = (0.004, 0.007, 0.010)
BUCKETS = (1, 2, 4, 8, 16)


def oracle_tables(n=600, L=3, seed=0):
    rng = np.random.default_rng(seed)
    conf = np.sort(rng.uniform(0.3, 1.0, (n, L)), axis=1)
    correct = rng.uniform(size=(n, L)) < conf
    return conf, correct.astype(bool)


def _policy(pkg, name, conf):
    if name in ("rtdeepiot", "rtdeepiot-weighted"):
        cls = pkg.RTDeepIoT if name == "rtdeepiot" else pkg.WeightedRTDeepIoT
        return cls(pkg.make_predictor("exp", prior_curve=conf.mean(0)))
    return getattr(pkg, name.upper())()


def _fields(res):
    d = dataclasses.asdict(res)
    d.pop("overhead_frac")
    for row in d["per_request"]:
        row.pop("tid")
    return d


def _both(name, *, wl=None, admission=None, **kw):
    """(port result, JAX result) of one simulate_batched call."""
    conf, correct = oracle_tables()
    wl = wl or dict(n_clients=32, d_lo=0.01, d_hi=0.3, n_requests=300,
                    seed=0)
    out = []
    for pkg, sim, tm_cls, adm_cls in (
            (core, simulate_batched, BatchTimeModel, AdmissionController),
            (jax_core_pkg, jax_simulate_batched, JaxBatchTimeModel,
             JaxAdmission)):
        tm = tm_cls.linear(STAGE_TIMES, BUCKETS, marginal=0.15)
        adm = adm_cls(tm, **admission) if admission else None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            res = sim(_policy(pkg, name, conf), pkg.Workload(**wl), tm, conf,
                      correct, admission=adm, **kw)
        out.append((res, adm))
    return out


class _StepClock:
    """``time`` stand-in for the runtime core: every ``perf_counter``
    reading advances 2**-17 s, so each measured host cost is exactly one
    step."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 2.0 ** -17
        return self.t


@pytest.fixture(autouse=True)
def step_clocks(monkeypatch):
    for mod in (jax_core, port_core):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=_StepClock().perf_counter))


@pytest.mark.parametrize("policy", ("rtdeepiot", "edf", "lcf", "rr",
                                    "rtdeepiot-weighted"))
def test_simulate_batched_matches_jax(policy):
    (got, _), (want, _) = _both(policy)
    assert got.n_requests == want.n_requests == 300
    assert got.n_dispatches < sum(r["depth"] for r in got.per_request)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("option", ("admission", "charge_overhead",
                                    "dispatch_overhead", "max_batch"))
def test_simulate_batched_options_match_jax(option):
    kw = {"admission": dict(admission={"mode": "reject", "headroom": 1.0}),
          "charge_overhead": dict(charge_overhead=True),
          "dispatch_overhead": dict(dispatch_overhead=0.0015),
          "max_batch": dict(max_batch=4)}[option]
    (got, adm), (want, jadm) = _both("rtdeepiot", **kw)
    assert _fields(got) == _fields(want)
    if option == "admission":
        assert adm.rejected == jadm.rejected > 0
        n_rej = sum(1 for f in got.per_request if f.get("rejected"))
        assert n_rej == adm.rejected
    if option == "charge_overhead":
        (free, _), _ = _both("rtdeepiot")
        assert _fields(got) != _fields(free)    # the charges told
    if option == "max_batch":
        (free, _), _ = _both("rtdeepiot")
        assert got.n_dispatches > free.n_dispatches


def test_simulate_batched_rejects_stage_count_mismatch():
    conf, correct = oracle_tables(n=20)
    tm = BatchTimeModel.linear((0.004, 0.007), (1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="2 stages, oracle tables have 3"):
            simulate_batched(core.EDF(), core.Workload(n_requests=4), tm,
                             conf, correct)


def test_batched_sim_beats_unbatched_throughput():
    """``tests/test_batching.py``'s deterministic overload run on the port:
    the batched path sustains >= 3x the goodput of the unbatched path at
    no-worse miss rate and accuracy."""
    conf, correct = oracle_tables()
    tm = BatchTimeModel.linear(STAGE_TIMES, BUCKETS, marginal=0.15)
    wl = core.Workload(n_clients=64, d_lo=0.01, d_hi=0.3, n_requests=500,
                       seed=0)

    def policy():
        return core.RTDeepIoT(core.make_predictor("exp",
                                                  prior_curve=conf.mean(0)))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res_u = core.simulate(policy(), wl, STAGE_TIMES, conf, correct)
        res_b = simulate_batched(policy(), wl, tm, conf, correct)
    assert res_b.throughput >= 3.0 * res_u.throughput
    assert res_b.miss_rate <= res_u.miss_rate
    assert res_b.accuracy >= res_u.accuracy - 0.01


def test_simulate_batched_warns_once_with_the_jax_message():
    conf, correct = oracle_tables(n=20)
    msgs = []
    for reset, sim, tm_cls, pkg in (
            (jax_reset_deprecations, jax_simulate_batched, JaxBatchTimeModel,
             jax_core_pkg),
            (deprecation._reset, simulate_batched, BatchTimeModel, core)):
        reset()
        tm = tm_cls.linear(STAGE_TIMES, (1, 2))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                sim(pkg.EDF(), pkg.Workload(n_clients=2, n_requests=6), tm,
                    conf, correct)
        msgs.append([str(w.message) for w in caught
                     if issubclass(w.category, DeprecationWarning)])
    want, got = msgs
    assert len(want) == len(got) == 1
    assert got[0] == want[0].replace("repro.serving", "repro_torch.serving")
