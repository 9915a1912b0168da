"""The port's ``Service`` against the JAX package's, end to end.

The ``device-kernel`` executor serves the anytime classifier on bridged
weights over the same request stream on the virtual clock, at
``pipeline_depth`` 1 and 3: each response's (sample, prediction, depth,
missed) must be equal and its confidence within rtol 1e-5.  The numpy
scheduling path (oracle executor) must agree bit for bit for every
built-in policy.  What the port has not taken up yet must raise
``NotImplementedError``; the plain device executors must validate
(their parity is ``tests/test_torch_executors.py``).  Live mode
(``Service.submit`` / ``drain``) is held to the JAX package too: buffered
on the virtual clock with an unbounded and a bounded intake (reject and
shed-optional overflow), and on the wall clock through the background
engine thread.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.launch.serve  # noqa: F401 — registers the JAX device-kernel
import repro_torch.launch.kernel  # noqa: F401 — registers the port's
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServeSpec as JaxServeSpec
from repro.serving import Service as JaxService
from repro.serving import closed_loop_stream as jax_closed_loop_stream
from repro.training import DifficultyDataset as JaxDifficultyDataset
from repro_torch.configs import get_config
from repro_torch.interop import from_reference
from repro_torch.serving import (Request, ServeSpec, Service, available,
                                 closed_loop_stream)
from repro_torch.serving.registry import NOT_PORTED
from repro_torch.training import DifficultyDataset

STAGE_TIMES = (0.002, 0.003, 0.004)


def _stream_spec(spec_cls, executor, executor_args, depth=1):
    """The spec of the JAX package's kernel-serving tests."""
    return spec_cls(
        policy="rtdeepiot",
        policy_args={"predictor": "exp", "prior_curve": [0.5, 0.7, 0.85]},
        executor=executor, executor_args=executor_args,
        clock="virtual", source="stream", pipeline_depth=depth,
        batching={"buckets": [1, 2, 4], "stage_times": list(STAGE_TIMES),
                  "marginal": 0.25})


def _classifier_stream(ds_cls, stream_fn, n_requests=12):
    test = ds_cls(num_classes=10, seed=0).sample(30, seed=9)
    return list(stream_fn(test["inputs"], test["labels"], n_clients=4,
                          d_lo=0.2, d_hi=0.5, n_requests=n_requests, seed=1))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("anytime-classifier")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("anytime-classifier")
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return jcfg, jparams, cfg, params


def _key(responses):
    return [(r.sample, r.prediction, r.depth, r.missed) for r in responses]


@pytest.mark.parametrize("depth", (1, 3))
def test_device_kernel_service_matches_jax(models, depth):
    jcfg, jparams, cfg, params = models
    ref = JaxService.from_spec(
        _stream_spec(JaxServeSpec, "device-kernel", {}, depth),
        cfg=jcfg, params=jparams)
    ref_res = ref.run(_classifier_stream(JaxDifficultyDataset,
                                         jax_closed_loop_stream))
    svc = Service.from_spec(_stream_spec(ServeSpec, "device-kernel", {},
                                         depth), cfg=cfg, params=params)
    res = svc.run(_classifier_stream(DifficultyDataset, closed_loop_stream))
    assert _key(svc.responses) == _key(ref.responses)
    np.testing.assert_allclose([r.confidence for r in svc.responses],
                               [r.confidence for r in ref.responses],
                               rtol=1e-5)
    ex = svc.executor
    assert ex.max_inflight == max(1, depth - 1)
    assert res.n_requests == 12 and len(ex._inflight) == 0
    assert ex.cache_stats() == dict(live=0, peak=ex.peak_cached,
                                    evictions=12)
    assert ex.cache_stats() == ref.executor.cache_stats()
    assert res.n_dispatches == ref_res.n_dispatches > 0


@pytest.mark.parametrize("policy", ("rtdeepiot", "edf", "lcf", "rr",
                                    "rtdeepiot-weighted"))
def test_oracle_service_bit_for_bit(policy):
    """The numpy scheduling path: closed-loop clients on the oracle
    executor, same tables and seeds, every result field equal."""
    rng = np.random.default_rng(0)
    conf = np.sort(rng.uniform(0.3, 1.0, (60, 3)), axis=1)
    correct = rng.uniform(size=(60, 3)) < conf
    kw = dict(policy=policy,
              policy_args={"predictor": "exp"}
              if policy.startswith("rtdeepiot") else {},
              batching={"buckets": [1, 2, 4], "stage_times": [0.01, 0.02,
                                                              0.03],
                        "marginal": 0.25},
              source_args={"n_clients": 8, "d_lo": 0.02, "d_hi": 0.2,
                           "n_requests": 80, "seed": 3},
              pipeline_depth=2, policy_cost=1e-4)
    ref = JaxService.from_spec(JaxServeSpec(**kw), conf_table=conf,
                               correct_table=correct).run()
    got = Service.from_spec(ServeSpec(**kw), conf_table=conf,
                            correct_table=correct).run()
    ref_d, got_d = dataclasses.asdict(ref), dataclasses.asdict(got)
    # overhead_frac divides by measured policy wall time; the timeline
    # itself is charged with the deterministic policy_cost
    ref_d.pop("overhead_frac"), got_d.pop("overhead_frac")
    # task ids come from a process-wide counter in each package, so they
    # depend on what ran before; the rows must agree in everything else
    for d in (ref_d, got_d):
        for row in d["per_request"]:
            row.pop("tid")
    assert got_d == ref_d


def _live_spec(spec_cls, source_args):
    """A live ``device-kernel`` service on the virtual clock with two SLO
    classes (bronze is capped at depth 1)."""
    spec = _stream_spec(spec_cls, "device-kernel", {}, depth=3)
    return dataclasses.replace(
        spec, source="live", source_args=source_args,
        slo_classes={"gold": {"rel_deadline": 0.3, "utility_weight": 2.0},
                     "bronze": {"rel_deadline": 0.05, "depth_cap": 1}},
        default_slo="gold")


def _serve_live(svc, stream):
    """Submit the stream (every third request bronze), cancel the last
    one before admission, drain; returns (handles, metrics)."""
    handles = [svc.submit(req, slo="bronze" if i % 3 == 2 else None, at=t)
               for i, (t, req) in enumerate(stream)]
    cancelled = handles[-1].cancel()
    met = svc.drain()
    return handles, cancelled, met


def _live_key(handles):
    return [(r.sample, r.prediction, r.depth, r.missed, r.rejected, r.slo)
            for r in (h.result() for h in handles[:-1])]


@pytest.mark.parametrize("intake", (
    {}, {"bound": 5, "overflow": "reject"},
    {"bound": 5, "overflow": "shed-optional"}))
def test_live_buffered_service_matches_jax(models, intake):
    jcfg, jparams, cfg, params = models
    ref = JaxService.from_spec(_live_spec(JaxServeSpec, intake), cfg=jcfg,
                               params=jparams)
    ref_h, ref_cancel, ref_met = _serve_live(
        ref, _classifier_stream(JaxDifficultyDataset, jax_closed_loop_stream))
    svc = Service.from_spec(_live_spec(ServeSpec, intake), cfg=cfg,
                            params=params)
    got_h, got_cancel, got_met = _serve_live(
        svc, _classifier_stream(DifficultyDataset, closed_loop_stream))
    assert got_cancel == ref_cancel
    assert _live_key(got_h) == _live_key(ref_h)
    np.testing.assert_allclose(
        [h.result().confidence for h in got_h[:-1]],
        [h.result().confidence for h in ref_h[:-1]], rtol=1e-5)
    for h_got, h_ref in zip(got_h[:-1], ref_h[:-1]):
        assert [e.depth for e in h_got.stages()] == \
            [e.depth for e in h_ref.stages()]
    for name in ("n_requests", "rejected", "capped", "cancelled",
                 "n_dispatches"):
        assert getattr(got_met, name) == getattr(ref_met, name), name
    assert {c: (d["n"], d.get("rejected")) for c, d in
            got_met.per_class.items()} == \
        {c: (d["n"], d.get("rejected")) for c, d in ref_met.per_class.items()}
    assert svc.executor.cache_stats()["live"] == 0
    # 12 submissions into a bound of 5: the 7 over it (the cancelled one
    # among them) are rejected, or admitted with their optional stages shed
    if intake.get("overflow") == "reject":
        assert got_met.rejected == 7 and not got_cancel
    elif intake:
        assert got_met.capped >= 6


@pytest.mark.wallclock
def test_live_wall_clock_service_matches_jax():
    """The background engine thread on the wall clock: every submission
    resolves at full depth with its anytime exits, as in the JAX
    package (oracle executor, generous deadlines)."""
    rng = np.random.default_rng(0)
    conf = np.sort(rng.uniform(0.3, 1.0, (20, 3)), axis=1)
    correct = rng.uniform(size=(20, 3)) < conf
    kw = dict(policy="edf", executor="oracle", clock="wall", source="live",
              batching={"mode": "none", "stage_times": [0.002] * 3},
              slo_classes={"gold": {"rel_deadline": 0.5}},
              default_slo="gold")
    rows = []
    for spec_cls, svc_cls, req_cls in ((JaxServeSpec, JaxService, JaxRequest),
                                       (ServeSpec, Service, Request)):
        with svc_cls.from_spec(spec_cls(**kw), conf_table=conf,
                               correct_table=correct) as svc:
            handles = [svc.submit(req_cls(None, sample=i)) for i in range(6)]
            results = [h.result(timeout=10.0) for h in handles]
            exits = [[e.depth for e in h.stages()] for h in handles]
            met = svc.drain()
        rows.append(([(r.sample, r.prediction, r.depth, r.missed)
                      for r in results], exits, met.n_requests,
                     met.miss_rate))
    assert rows[1] == rows[0]
    assert rows[1][1] == [[1, 2, 3]] * 6 and rows[1][2] == 6


@pytest.mark.parametrize("field,value", [
    ("models", {"a": {"stage_times": [0.01]}}),
    ("tenants", {"t": {"weight": 2.0}}),
    ("admission", {"mode": "reject",
                   "forecast": {"process": {"kind": "poisson"}}}),
    ("source", "frontdoor"),
    ("executor", "device-sharded"), ("executor", "zoo-oracle"),
    ("source", "durable"),
])
def test_unported_spec_raises(field, value):
    spec = _stream_spec(ServeSpec, "device-kernel", {})
    spec = dataclasses.replace(spec, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        spec.validate()


@pytest.mark.parametrize("field,value", [
    ("trace", {"enabled": True}),
    ("metrics_interval", 0.5),
    ("source", "traffic"), ("source", "replay"),
])
def test_ported_traffic_and_obs_spec_validates(field, value):
    """The traffic subsystem's sources, metrics streaming and the request
    tracer resolve in the port (their parity: tests/test_torch_traffic.py
    and tests/test_torch_obs.py)."""
    spec = _stream_spec(ServeSpec, "device-kernel", {})
    spec = dataclasses.replace(spec, **{field: value})
    assert spec.validate() is spec
    if field == "source":
        assert value in available("source")
        assert ("source", value) not in NOT_PORTED


@pytest.mark.parametrize("executor", ("device-single", "device-batched"))
def test_ported_executor_spec_validates(executor):
    """The plain device executors resolve in the port's registry."""
    spec = dataclasses.replace(_stream_spec(ServeSpec, "device-kernel", {}),
                               executor=executor)
    assert spec.validate() is spec
    assert executor in available("executor")
    assert ("executor", executor) not in NOT_PORTED


@pytest.mark.parametrize("resource", ("zoo", "zoo_tables", "observer"))
def test_unported_resource_raises(resource):
    spec = _stream_spec(ServeSpec, "device-kernel", {})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        Service.from_spec(spec, **{resource: object()})


def test_on_metrics_resource_receives_snapshots():
    """``on_metrics`` (refused before the traffic subsystem was ported)
    now receives the streamed snapshots."""
    conf = np.full((20, 3), 0.8)
    correct = conf > 0.5
    spec = ServeSpec(policy="edf", metrics_interval=0.05,
                     batching={"mode": "none", "stage_times": [0.01] * 3},
                     source_args={"n_clients": 2, "d_lo": 0.05, "d_hi": 0.2,
                                  "n_requests": 10})
    got = []
    svc = Service.from_spec(spec, conf_table=conf, correct_table=correct,
                            on_metrics=got.append)
    res = svc.run()
    assert got and got == svc.snapshots
    assert sum(s.n for s in got) == res.n_requests == 10


def test_unknown_kernel_arg_rejected():
    """The JAX package's TPU-only ``interpret`` arg has no meaning here."""
    spec = _stream_spec(ServeSpec, "device-kernel", {"interpret": True})
    with pytest.raises(ValueError, match="unknown device-kernel"):
        spec.validate()
