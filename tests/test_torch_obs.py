"""The port's observability layer against the JAX package's, on the CPU.

* passivity: a traced run's per-request records are bit for bit the
  untraced run's (every built-in policy, oracle executor, virtual clock);
* the port's traces, audit rows, device windows and metrics registry
  equal the JAX tracer's on the same oracle run (task ids shifted to the
  run's first: each package numbers tasks from its own counter);
* the port's JSONL export loads in the JAX ``load_obs`` and the JAX
  export in the port's; both ``validate_chrome_trace``s accept both
  packages' Chrome documents and flag the same bad ones;
* ``device-kernel`` on the CPU (plain exit) with tracing: span order and
  one device-window span a dispatch;
* every rejected or capped request under overload has an audit row whose
  rule is one of its admission mode's rules (the port's statement of
  ``tests/test_obs.py::test_audit_covers_every_shed_request_at_2x_overload``,
  one of ROADMAP C-ref 2's failures, which asserts that 2x-overload sheds
  something; with singleton-priced stages RTDeepIoT sheds optional
  stages itself there and admission refuses nothing, in both packages).
"""
import json

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.serving.obs import load_obs as jax_load_obs
from repro.serving.obs import validate_chrome_trace as jax_validate
from repro.serving.traffic import scenario_spec as jax_scenario_spec
from repro_torch.serving.obs import (MetricsRegistry, Tracer, load_obs,
                                     validate_chrome_trace)
from repro_torch.serving.traffic import scenario_spec

STAGE_TIMES = [0.004, 0.007, 0.010]
OBS_KEYS = ("queue_wait", "host_time", "device_time", "decision")
ADMISSION_RULES = {"reject": {"overload", "mandatory-infeasible"},
                   "depth_cap": {"overload-capped", "deadline-capped",
                                 "mandatory-infeasible"}}


def oracle_tables(n=600, L=3, seed=0):
    rng = np.random.default_rng(seed)
    conf = np.sort(rng.uniform(0.3, 1.0, (n, L)), axis=1)
    correct = rng.uniform(size=(n, L)) < conf
    return conf, correct.astype(bool)


def _spec(serving, policy, trace, **kw):
    base = dict(policy=policy,
                policy_args={"delta": 0.3} if policy == "rtdeepiot" else {},
                batching={"stage_times": STAGE_TIMES,
                          "buckets": [1, 2, 4, 8], "marginal": 0.15},
                source_args={"n_clients": 12, "d_lo": 0.01, "d_hi": 0.25,
                             "n_requests": 120},
                trace=trace, admission={"mode": "depth_cap"},
                pipeline_depth=2)
    base.update(kw)
    return serving.ServeSpec(**base)


def _run(serving, spec):
    conf, correct = oracle_tables()
    svc = serving.Service.from_spec(spec, conf_table=conf,
                                    correct_table=correct)
    return svc, svc.run()


def _shift(obj, base):
    """Task ids relative to the run's first: tids inside traces, audit
    rows (and a top-off's added/removed lists) and windows."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "tid" and isinstance(v, int):
                out[k] = v - base
            elif k in ("tids", "added", "removed"):
                out[k] = [t - base for t in v]
            else:
                out[k] = _shift(v, base)
        return out
    if isinstance(obj, (list, tuple)):
        return [_shift(v, base) for v in obj]
    return obj


def _obs_view(svc, res):
    """Everything the tracer recorded, tids shifted to the run's first."""
    base = min(r["tid"] for r in res.per_request)
    obs = svc.obs
    return dict(
        traces=[_shift(obs.traces[t].to_dict(), base)
                for t in sorted(obs.traces)],
        audit=_shift(obs.audit_log, base),
        windows=_shift(obs.windows, base),
        metrics=obs.registry.to_dict())


# ---------------------------------------------------------------------------
# passivity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["rtdeepiot", "edf", "lcf", "rr"])
def test_traced_run_is_bitwise_untraced(policy):
    _, off = _run(tserving, _spec(tserving, policy, {}))
    svc, on = _run(tserving, _spec(tserving, policy, {"enabled": True}))
    strip = [{k: v for k, v in r.items() if k not in OBS_KEYS + ("tid",)}
             for r in on.per_request]
    assert strip == [{k: v for k, v in r.items() if k != "tid"}
                     for r in off.per_request]
    assert (on.makespan, on.n_dispatches, on.accuracy) == \
        (off.makespan, off.n_dispatches, off.accuracy)
    assert len(svc.obs.traces) == on.n_requests == 120
    assert all(not any(k in r for k in OBS_KEYS) for r in off.per_request)


# ---------------------------------------------------------------------------
# parity with the JAX tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["rtdeepiot", "edf"])
def test_traces_audit_and_registry_match_jax(policy):
    views = []
    for serving in (jserving, tserving):
        svc, res = _run(serving, _spec(serving, policy, {"enabled": True}))
        views.append((_obs_view(svc, res),
                      [{k: v for k, v in r.items() if k != "tid"}
                       for r in res.per_request]))
    (want, wrows), (got, grows) = views
    assert got == want and grows == wrows
    assert got["windows"] and got["traces"]
    if policy == "rtdeepiot":
        assert got["audit"]                     # depth caps were audited


def test_intake_audit_rows_match_jax():
    """Bounded live intake, reject and shed-optional: the intake-bound /
    intake-shed audit rows and their registry counts."""
    conf, correct = oracle_tables()
    out = []
    for serving in (jserving, tserving):
        rows = []
        for overflow in ("reject", "shed-optional"):
            spec = serving.ServeSpec(
                policy="edf", source="live",
                batching={"stage_times": STAGE_TIMES, "buckets": [1, 2, 4],
                          "marginal": 0.15},
                source_args={"bound": 2, "overflow": overflow},
                trace={"enabled": True})
            svc = serving.Service.from_spec(spec, conf_table=conf,
                                            correct_table=correct)
            for i in range(5):
                svc.submit(serving.Request(inputs=None, rel_deadline=0.5,
                                           sample=i), at=0.001 * i,
                           request_id=f"q{i}")
            res = svc.drain()
            base = min(r["tid"] for r in res.per_request)
            rows.append((_shift(svc.obs.audit_log, base),
                         svc.obs.registry.to_dict()))
        out.append(rows)
    assert out[1] == out[0]
    (rej_audit, rej_reg), (shed_audit, shed_reg) = out[1]
    assert [r["rule"] for r in rej_audit] == ["intake-bound"] * 3
    assert [r["rule"] for r in shed_audit] == ["intake-shed"] * 3
    assert rej_reg["requests_rejected"]["value"] == 3
    assert shed_reg["requests_capped"]["value"] == 3


def test_registry_instruments_match_jax():
    from repro.serving.obs import MetricsRegistry as JaxRegistry
    regs = []
    for cls in (JaxRegistry, MetricsRegistry):
        reg = cls.serving_default()
        reg.counter("a").inc(3)
        reg.gauge("g").set(7)
        h = reg.histogram("h", buckets=[1, 2, 4])
        for v in (0.5, 1.5, 3.0, 100.0):
            h.observe(v)
        regs.append(reg.to_dict())
        with pytest.raises(ValueError):
            reg.histogram("bad", buckets=[3, 1])
    assert regs[1] == regs[0]
    assert regs[1]["h"]["counts"] == [1, 1, 1, 1]


# ---------------------------------------------------------------------------
# exports across packages
# ---------------------------------------------------------------------------

def test_jsonl_and_chrome_exports_load_across_packages(tmp_path):
    docs, loaded = {}, {}
    for name, serving in (("jax", jserving), ("torch", tserving)):
        trace = {"enabled": True, "export": str(tmp_path / f"{name}.jsonl"),
                 "chrome": str(tmp_path / f"{name}.json")}
        svc, res = _run(serving, _spec(serving, "rtdeepiot", trace))
        docs[name] = json.loads((tmp_path / f"{name}.json").read_text())
        loaded[name] = (min(r["tid"] for r in res.per_request),
                        svc.obs.registry.to_dict())
    for reader in (load_obs, jax_load_obs):
        views = []
        for name in ("jax", "torch"):
            obs = reader(str(tmp_path / f"{name}.jsonl"))
            base, metrics = loaded[name]
            assert obs["metrics"] == metrics
            views.append(dict(
                header=obs["header"], metrics=obs["metrics"],
                traces=[_shift(obs["traces"][t], base)
                        for t in sorted(obs["traces"])],
                audit=_shift(obs["audit"], base),
                windows=_shift(obs["windows"], base)))
        assert views[1] == views[0] and len(views[1]["traces"]) == 120
    for validate in (validate_chrome_trace, jax_validate):
        for doc in docs.values():
            assert validate(doc) == []
        bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0,
                                "ts": -1.0, "dur": 1.0},
                               {"ph": "Q", "name": "b", "pid": 1, "tid": 0},
                               {"ph": "i", "name": "c", "ts": 0.0,
                                "s": "z", "pid": 1, "tid": 0}]}
        assert validate(bad) == jax_validate(bad) and len(validate(bad)) == 3
        assert validate([]) == ["document is not a JSON object"]


def test_spec_trace_validation():
    with pytest.raises(ValueError, match="unknown trace keys"):
        tserving.ServeSpec(trace={"enable": True}).validate()
    with pytest.raises(ValueError, match="file path"):
        tserving.ServeSpec(trace={"enabled": True, "export": 7}).validate()
    spec = tserving.ServeSpec(trace={"enabled": True, "spans": False})
    assert tserving.ServeSpec.from_json(spec.to_json()).trace == spec.trace
    assert Tracer.from_config({"spans": False}).spans_on is False


# ---------------------------------------------------------------------------
# device-kernel on the CPU, traced
# ---------------------------------------------------------------------------

def test_device_kernel_trace_spans_on_cpu():
    import repro_torch.launch.kernel  # noqa: F401 — registers device-kernel
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import DifficultyDataset

    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    test = DifficultyDataset(num_classes=10, seed=0).sample(30, seed=9)
    stream = tserving.closed_loop_stream(
        test["inputs"], test["labels"], n_clients=4, d_lo=0.006, d_hi=0.02,
        n_requests=16, seed=1, spacing=0.001)
    spec = tserving.ServeSpec(
        policy="rtdeepiot",
        policy_args={"predictor": "exp", "prior_curve": [0.5, 0.7, 0.85]},
        executor="device-kernel", clock="virtual", source="stream",
        pipeline_depth=3, trace={"enabled": True},
        batching={"buckets": [1, 2, 4], "stage_times": [0.002, 0.003, 0.004],
                  "marginal": 0.25})
    svc = tserving.Service.from_spec(spec, cfg=cfg, params=params)
    res = svc.run(stream)
    obs = svc.obs
    assert len(obs.traces) == res.n_requests == 16
    assert len(obs.windows) == res.n_dispatches > 0
    assert all(w["bucket"] >= w["n"] >= 1 for w in obs.windows)
    for tr in obs.traces.values():
        names = tr.span_names()
        assert names[0] == "queued" and names[-1] in ("retire", "expire")
        assert [s.t0 for s in tr.spans] == sorted(s.t0 for s in tr.spans)
        assert names.count("device-window") == names.count("dispatch")
        if not tr.missed:
            assert names.count("stage-exit") == tr.depth
            assert names.count("device-window") >= tr.depth
        assert abs(tr.queue_wait + tr.host_time + tr.device_time
                   - tr.latency) <= 1e-9 or tr.host_time == 0.0


# ---------------------------------------------------------------------------
# audit coverage under overload (the port's statement of a C-ref 2 test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["reject", "depth_cap"])
@pytest.mark.parametrize("name", ["2x-overload", "flash-crowd"])
def test_audit_covers_every_shed_request_under_overload(name, mode):
    """Every rejected or capped request has an audit row naming one of the
    admission mode's rules, with the slack behind it (and the backlog for
    the overload rules), and the port's rows equal the JAX package's.  The
    test does not assert how much is shed: that is the run's outcome."""
    conf, correct = oracle_tables()
    out = []
    for serving, spec_fn in ((jserving, jax_scenario_spec),
                             (tserving, scenario_spec)):
        spec = spec_fn(name, stage_times=STAGE_TIMES, n_requests=300,
                       admission={"mode": mode}, trace={"enabled": True})
        svc = serving.Service.from_spec(spec, conf_table=conf,
                                        correct_table=correct)
        res = svc.run()
        audited = {row["tid"] for row in svc.obs.audit_log}
        degraded = [tr for tr in svc.obs.traces.values()
                    if tr.rejected or tr.depth_cap is not None]
        assert all(tr.tid in audited for tr in degraded)
        for row in svc.obs.audit_log:
            assert row["rule"] in ADMISSION_RULES[mode]
            assert "slack" in row["detail"]
            if row["rule"] in ("overload", "overload-capped"):
                assert "backlog" in row["detail"]
        out.append((len(degraded), _obs_view(svc, res)["audit"]))
    assert out[1] == out[0]
    if name == "flash-crowd":
        assert out[1][0] > 0            # this crowd does shed
