"""The classifier's plain device executors against the JAX package's.

``device-single`` (one request's stage at a time, ``make_stage_fns``) and
``device-batched`` (padded, bucketed micro-batches of the plain
``stage_forward`` body, also pipelined at ``pipeline_depth`` 2) serve the
anytime classifier on bridged weights over the same request streams on the
virtual clock: each response's (sample, prediction, depth, missed) must be
equal, its confidence within rtol 1e-5, and the hidden-state cache and the
dispatch count the JAX executor's.  The stage functions are held to the
JAX ``stage_forward`` at every batch bucket with padding rows (h, logits
and conf within 1e-5, predictions equal), the profilers to their shapes,
the legacy ``ServingEngine`` / ``BatchedServingEngine`` faces to one
deprecation warning each and the responses of the spec they wrap, and the
launcher ``repro_torch.launch.serve_anytime`` to a smoke run on the CPU.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import repro_torch.launch.kernel  # noqa: F401 — registers device-kernel
from repro.configs import get_config as jax_get_config
from repro.core import EDF as JaxEDF
from repro.models import init_params as jax_init_params
from repro.serving import BatchedServingEngine as JaxBatchedServingEngine
from repro.serving import ServeSpec as JaxServeSpec
from repro.serving import Service as JaxService
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import closed_loop_stream as jax_closed_loop_stream
from repro.serving import make_stage_fns as jax_make_stage_fns
from repro.serving.batch import BatchedStageFns as JaxBatchedStageFns
from repro.serving.batch import BatchTimeModel as JaxBatchTimeModel
from repro.serving.batch import pad_batch as jax_pad_batch
from repro.serving.batch import split_rows as jax_split_rows
from repro.serving.deprecation import _reset as jax_reset_deprecations
from repro.training import DifficultyDataset as JaxDifficultyDataset
from repro_torch.configs import get_config
from repro_torch.core import EDF
from repro_torch.interop import from_reference
from repro_torch.launch import serve_anytime
from repro_torch.serving import (BatchedServingEngine, BatchedStageFns,
                                 BatchTimeModel, ServeSpec, Service,
                                 ServingEngine, closed_loop_stream,
                                 make_stage_fns, profile_batched_stages,
                                 profile_stages)
from repro_torch.serving import deprecation
from repro_torch.serving.batch import split_rows
from repro_torch.training import DifficultyDataset

STAGE_TIMES = (0.002, 0.003, 0.004)
BUCKETS = (1, 2, 4)
TOL = 1e-5
# (d_lo, d_hi, spacing) of the 12-request virtual-clock streams: the
# kernel-serving tests' stream (every request alone, full depth) and a
# dense one whose requests overlap, so batches form and stages are shed
STREAMS = {"sparse": (0.2, 0.5, None), "dense": (0.006, 0.02, 0.001)}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("anytime-classifier")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("anytime-classifier")
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_stage_fns(models):
    """One set of jitted JAX stage fns per executor, shared by the tests
    so each shape compiles once (bucket 8 only for the stage-body test:
    the services' time model stops at 4)."""
    jcfg = models[0]
    return {"device-single": jax_make_stage_fns(jcfg),
            "device-batched": JaxBatchedStageFns(jcfg, BUCKETS + (8,))}


def _spec(spec_cls, executor, depth):
    batching = ({"mode": "none", "stage_times": list(STAGE_TIMES)}
                if executor == "device-single" else
                {"buckets": list(BUCKETS), "stage_times": list(STAGE_TIMES),
                 "marginal": 0.25})
    return spec_cls(
        policy="rtdeepiot",
        policy_args={"predictor": "exp", "prior_curve": [0.5, 0.7, 0.85]},
        executor=executor, clock="virtual", source="stream",
        pipeline_depth=depth, batching=batching)


def _stream(ds_cls, stream_fn, kind, n_requests=12):
    d_lo, d_hi, spacing = STREAMS[kind]
    test = ds_cls(num_classes=10, seed=0).sample(30, seed=9)
    return list(stream_fn(test["inputs"], test["labels"], n_clients=4,
                          d_lo=d_lo, d_hi=d_hi, n_requests=n_requests,
                          seed=1, spacing=spacing))


def _key(responses):
    return [(r.sample, r.prediction, r.depth, r.missed) for r in responses]


@pytest.mark.parametrize("kind", sorted(STREAMS))
@pytest.mark.parametrize("executor,depth", [("device-single", 1),
                                            ("device-batched", 1),
                                            ("device-batched", 2)])
def test_device_executor_service_matches_jax(models, jax_stage_fns, executor,
                                             depth, kind):
    jcfg, jparams, cfg, params = models
    ref = JaxService.from_spec(_spec(JaxServeSpec, executor, depth),
                               cfg=jcfg, params=jparams,
                               stage_fns=jax_stage_fns[executor])
    ref_res = ref.run(_stream(JaxDifficultyDataset, jax_closed_loop_stream,
                              kind))
    svc = Service.from_spec(_spec(ServeSpec, executor, depth), cfg=cfg,
                            params=params)
    res = svc.run(_stream(DifficultyDataset, closed_loop_stream, kind))
    assert _key(svc.responses) == _key(ref.responses)
    np.testing.assert_allclose([r.confidence for r in svc.responses],
                               [r.confidence for r in ref.responses],
                               rtol=1e-5)
    ex = svc.executor
    assert type(ex).__name__ == "DeviceExecutor" and ex.max_inflight == 1
    assert res.n_requests == 12 and not ex.busy
    assert ex.cache_stats() == ref.executor.cache_stats()
    assert ex.cache_stats()["live"] == 0
    assert ex.cache_stats()["evictions"] == 12
    assert res.n_dispatches == ref_res.n_dispatches > 0
    assert sum(ex.stage_dispatches.values()) == res.n_dispatches
    if kind == "dense" and executor == "device-batched":
        assert ex.peak_cached > 1               # requests shared batches
        assert res.n_dispatches < 3 * 12
    assert ex.device == torch.device("cpu")     # where the params live


def _inputs(n, seed=3):
    test = DifficultyDataset(num_classes=10, seed=0).sample(n, seed=seed)
    return [{"features": test["inputs"]["features"][i:i + 1]}
            for i in range(n)]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bucket,n_valid", [(1, 1), (2, 1), (4, 3), (8, 5)])
def test_batched_stage_body_matches_jax(models, jax_stage_fns, bucket,
                                       n_valid):
    """The plain ``BatchedStageFns`` body on a padded batch against the JAX
    ``stage_forward`` (jitted, as ``device-batched`` runs it) on the JAX
    package's padded batch: every row, padding included."""
    jcfg, jparams, cfg, params = models
    jfns = jax_stage_fns["device-batched"]
    rows = _inputs(n_valid)
    fns = BatchedStageFns(cfg, (bucket,))
    jh, mask = jax_pad_batch(rows, bucket)
    hs = rows
    for s in range(cfg.num_stages):
        h, logits, conf, got_mask = fns.run(s, params, hs)
        jh, jlogits, jconf = jfns.fn(s)(jparams, jh)
        assert list(got_mask) == list(mask)
        _close(h, jh)
        _close(logits, jlogits)
        _close(conf, jconf)
        assert logits.argmax(-1).tolist() == \
            np.asarray(jlogits).argmax(-1).tolist()
        assert (s, bucket) in fns.warm
        hs = split_rows(h, n_valid)
        assert len(hs) == n_valid and hs[-1].shape[0] == 1


def test_make_stage_fns_match_jax(models):
    """Each eager per-stage fn against the jitted JAX one, sample by
    sample (stage 0 takes the host input dict), and bitwise against the
    batched body at bucket 1 on the same input."""
    jcfg, jparams, cfg, params = models
    fns, jfns = make_stage_fns(cfg), jax_make_stage_fns(jcfg)
    bfns = BatchedStageFns(cfg, (1,))
    assert len(fns) == cfg.num_stages
    for x in _inputs(3, seed=5):
        h, jh, hb = x, x, bfns.pad(params, [x], 1)[0]
        for s in range(cfg.num_stages):
            out, jout, bout = fns[s](params, h), jfns[s](jparams, jh), \
                bfns.call(s, params, hb)
            for got, want, same in zip(out, jout, bout):
                _close(got, want)
                assert torch.equal(got, same)
            h, jh, hb = out[0], jout[0], bout[0]


def test_split_rows_matches_jax():
    tree = {"a": np.arange(12, dtype=np.float32).reshape(4, 3),
            "b": np.arange(8, dtype=np.int32).reshape(4, 2)}
    got, want = split_rows(tree, 3), jax_split_rows(tree, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in tree:
            assert g[k].shape == (1,) + tree[k].shape[1:]
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    t = torch.arange(6.0).reshape(3, 2)
    assert [r.tolist() for r in split_rows(t, 2)] == [[[0.0, 1.0]],
                                                      [[2.0, 3.0]]]


def test_profile_stages_on_cpu(models):
    cfg, params = models[2], models[3]
    wcet, times, host = profile_stages(cfg, params, make_stage_fns(cfg),
                                       _inputs(1)[0], n_runs=5)
    assert wcet.shape == (cfg.num_stages,)
    assert times.shape == (cfg.num_stages, 5)
    assert np.all(times > 0) and host > 0
    assert np.all(wcet >= np.median(times, axis=1))


def test_profile_batched_stages_plain_body(models):
    cfg, params = models[2], models[3]
    fns = BatchedStageFns(cfg, (1, 2))
    tm, mat = profile_batched_stages(cfg, params, fns, _inputs(1)[0],
                                     n_runs=5)
    assert mat.shape == (cfg.num_stages, 2)
    assert np.all(mat > 0) and tm.buckets == (1, 2)
    assert [[tm.wcet(s, b) for b in (1, 2)]
            for s in range(cfg.num_stages)] == mat.tolist()
    assert fns.warm == {(s, b) for s in range(cfg.num_stages)
                        for b in (1, 2)}


# ---------------------------------------------------------------------------
# the legacy wall-clock faces
# ---------------------------------------------------------------------------

def _legacy_stream(ds_cls, stream_fn):
    """Four requests that all arrive within 2 ms, each with a 60 s
    deadline: EDF serves every one to full depth even on a loaded host
    (the run ends when the last request retires, not at a deadline)."""
    test = ds_cls(num_classes=10, seed=0).sample(30, seed=9)
    return list(stream_fn(test["inputs"], test["labels"], n_clients=2,
                          d_lo=60.0, d_hi=60.0, n_requests=4, seed=1,
                          spacing=0.001))


def _deprecations(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)]


def _engines(cfg, params, policy, tm, cls_single, cls_batched):
    return {
        "ServingEngine": (cls_single(cfg, params, policy,
                                     stage_wcet=STAGE_TIMES), None),
        "BatchedServingEngine": (cls_batched(cfg, params, policy,
                                             time_model=tm), 1),
        "pipelined": (cls_batched(cfg, params, policy,
                                  time_model=tm).pipelined(), 2),
    }


@pytest.mark.wallclock
@pytest.mark.parametrize("name", ("ServingEngine", "BatchedServingEngine",
                                  "pipelined"))
def test_legacy_engine_warns_once_and_serves_its_spec(models, name):
    jcfg, jparams, cfg, params = models
    tm = BatchTimeModel.linear(STAGE_TIMES, BUCKETS)
    eng, depth = _engines(cfg, params, EDF(), tm, ServingEngine,
                          BatchedServingEngine)[name]
    jeng, _ = _engines(jcfg, jparams, JaxEDF(),
                       JaxBatchTimeModel.linear(STAGE_TIMES, BUCKETS),
                       JaxServingEngine, JaxBatchedServingEngine)[name]
    jax_reset_deprecations()
    _, jax_msgs = _deprecations(lambda: jeng.run([]))
    deprecation._reset()
    stream = _legacy_stream(DifficultyDataset, closed_loop_stream)
    got, msgs = _deprecations(lambda: eng.run(stream))
    _, again = _deprecations(lambda: eng.run([]))
    assert len(msgs) == 1 and again == []
    assert msgs[0] == jax_msgs[0].replace("repro.serving",
                                          "repro_torch.serving")
    assert got is eng.responses and len(got) == 4
    if depth is None:
        spec = ServeSpec(executor="device-single", clock="wall",
                         source="stream",
                         batching={"mode": "none",
                                   "stage_times": list(STAGE_TIMES)})
    else:
        spec = ServeSpec(executor="device-batched", clock="wall",
                         source="stream", pipeline_depth=depth,
                         batching={"max_batch": tm.max_batch})
        assert eng._pipeline_depth == depth
    svc = Service.from_spec(spec, policy=EDF(), cfg=cfg, params=params,
                            time_model=tm)
    svc.run(stream)
    assert _key(got) == _key(svc.responses)
    assert [r.depth for r in got] == [cfg.num_stages] * 4


def test_smoke_launcher_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve_anytime --smoke --device cpu
    --kernels`` in-process: every leg answers its 8 requests, leaves its
    hidden-state cache empty, and the stage times carry the JAX example's
    keys.  The deadlines are given, since the stream's offsets scale with
    them.  How many requests are served is not held: a CPU stage's 99th
    percentile over 5 runs can read half a second on a loaded host, and
    the §II-B adjustment then leaves no request a feasible deadline (the
    served responses are held to the JAX package's on the virtual clock
    above)."""
    out = serve_anytime.main(["--smoke", "--device", "cpu", "--kernels",
                              "--out", str(tmp_path), "--d-lo", "0.2",
                              "--d-hi", "0.4",
                              "--ckpt", str(tmp_path / "none.ckpt")])
    assert sorted(out["legs"]) == sorted(
        [f"{pre}{p}" for pre in ("", "batched-", "pipelined-")
         for p in ("rtdeepiot", "edf")] + ["kernel-rtdeepiot"])
    for leg in out["legs"].values():
        assert leg["n"] == 8 and leg["cache"] == dict(
            live=0, peak=leg["cache"]["peak"], evictions=8)
    assert out["batched_wcet"].shape == (3, 2)
    with np.load(tmp_path / "stage_times.npz") as z:
        assert sorted(z.files) == ["host_overhead", "samples", "wcet"]
        assert z["wcet"].shape == (3,) and z["samples"].shape == (3, 5)
        np.testing.assert_array_equal(z["wcet"], out["wcet"])


def test_launcher_stays_on_the_front_door(tmp_path, monkeypatch):
    """A legacy shim reached from the launcher raises, as in the JAX
    example."""
    def legacy(*a, **k):
        from repro_torch.serving.deprecation import deprecate_once
        deprecate_once("legacy-in-launcher", "use a ServeSpec instead")
    deprecation._reset()
    monkeypatch.setattr(serve_anytime, "profile_stages", legacy)
    with pytest.raises(DeprecationWarning, match="ServeSpec"):
        serve_anytime.main(["--smoke", "--device", "cpu",
                            "--ckpt", str(tmp_path / "none.ckpt")])
