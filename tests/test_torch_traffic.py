"""The port's traffic subsystem against the JAX package's, on the CPU.

* every arrival kind draws the JAX package's offsets bit for bit (same
  seed, ``n`` and ``horizon`` bounds), and the request mix its draws;
* ``scenario_spec`` builds the JAX package's spec for every catalog name
  (``model-mix`` raises: the zoo is ROADMAP Queue A item 9b);
* ``Service`` on ``source="traffic"`` (oracle executor, virtual clock)
  gives the JAX package's per-request records bit for bit under steady,
  2x-overload and flash-crowd load, with and without admission control,
  and its ``metrics_interval`` snapshots field for field; so do the
  bounded live intake's reject and shed-optional modes; cancel after
  admission (wall clock) sheds the same optional stages;
* traces written by either package load in the other, replaying
  ``examples/data/mini_trace.jsonl`` gives the JAX package's outcomes,
  and ``verify_replay`` holds across packages;
* the launcher ``repro_torch.launch.traffic_replay`` in-process.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.serving.traffic import SCENARIOS as JAX_SCENARIOS
from repro.serving.traffic import load_trace as jax_load_trace
from repro.serving.traffic import make_arrival_process as jax_arrivals
from repro.serving.traffic import RequestMix as JaxRequestMix
from repro.serving.traffic import record_trace as jax_record_trace
from repro.serving.traffic import scenario_spec as jax_scenario_spec
from repro_torch.launch.traffic_replay import synthetic_tables
from repro_torch.serving.traffic import (ARRIVAL_KINDS, SCENARIOS,
                                         RequestMix, load_trace,
                                         make_arrival_process, record_trace,
                                         replay_stream, scenario_spec,
                                         verify_replay)

REPO = pathlib.Path(__file__).resolve().parents[1]
MINI_TRACE = REPO / "examples" / "data" / "mini_trace.jsonl"
STAGE_TIMES = (0.004, 0.007, 0.010)
PACKAGES = {"jax": (jserving, jax_scenario_spec),
            "torch": (tserving, scenario_spec)}

ARRIVAL_CONFIGS = {
    "poisson": dict(rate=120.0),
    "mmpp": dict(rate_on=300.0, rate_off=40.0, mean_on=0.4, mean_off=1.2),
    "diurnal": dict(base_rate=40.0, peak_rate=200.0, period=4.0),
    "flash-crowd": dict(base_rate=60.0, spike_rate=400.0, spike_at=1.0,
                        spike_len=1.0),
}


def oracle_tables(n=200, L=3, seed=0):
    rng = np.random.default_rng(seed)
    conf = np.sort(rng.uniform(0.3, 1.0, (n, L)), axis=1)
    correct = rng.uniform(size=(n, L)) < conf
    return conf, correct.astype(bool)


def _rows(per_request):
    """Per-request rows without ``tid`` (each package numbers its tasks
    from its own process-wide counter), in admission order."""
    return [{k: v for k, v in r.items() if k != "tid"}
            for r in sorted(per_request, key=lambda r: r["tid"])]


# ---------------------------------------------------------------------------
# generators and mixes: the JAX package's draws, bit for bit
# ---------------------------------------------------------------------------

def test_every_kind_is_ported_and_under_test():
    assert set(ARRIVAL_KINDS) == set(ARRIVAL_CONFIGS) \
        == set(jax_arrivals.__globals__["ARRIVAL_KINDS"])


@pytest.mark.parametrize("bound", ["n", "horizon", "both"])
@pytest.mark.parametrize("kind", sorted(ARRIVAL_CONFIGS))
def test_arrival_offsets_bitwise(kind, bound):
    kw = {"n": dict(n=300), "horizon": dict(horizon=2.5),
          "both": dict(n=150, horizon=1.5)}[bound]
    for seed in (0, 7):
        ours = make_arrival_process(kind, **ARRIVAL_CONFIGS[kind])
        ref = jax_arrivals(kind, **ARRIVAL_CONFIGS[kind])
        got = ours.sample(np.random.default_rng(seed), **kw)
        want = ref.sample(np.random.default_rng(seed), **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert len(got) > 0 and (np.diff(got) >= 0).all()
        assert ours.to_dict() == ref.to_dict()
        assert ours.mean_rate == ref.mean_rate
    with pytest.raises(ValueError, match="n and/or horizon"):
        ours.sample(np.random.default_rng(0))


def test_mix_draws_bitwise():
    classes = [{"slo": "gold", "share": 3.0},
               {"slo": "bronze", "share": 1.0, "rel_range": [0.05, 0.1]},
               {"slo": "silver", "share": 2.0, "rel_deadline": 0.2,
                "seq_range": [8, 64], "model": "m"}]
    offsets = np.linspace(0.0, 1.0, 200)
    ours = RequestMix(classes, n_samples=50, inputs_fn=lambda s: {"s": s})
    ref = JaxRequestMix(classes, n_samples=50, inputs_fn=lambda s: {"s": s})
    got = ours.stream(np.random.default_rng(3), offsets)
    want = ref.stream(np.random.default_rng(3), offsets)
    fields = ("inputs", "rel_deadline", "sample", "client", "arrival",
              "slo", "seq_len", "model")
    assert [(o, [getattr(r, f) for f in fields]) for o, r in got] == \
        [(o, [getattr(r, f) for f in fields]) for o, r in want]
    assert ours.to_dicts() == ref.to_dicts()
    with pytest.raises(ValueError, match="share"):
        RequestMix([{"share": 0.0}], n_samples=5)


@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_scenario_spec_matches_jax(name):
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS)
    want = jax_scenario_spec(name, stage_times=STAGE_TIMES, n_requests=40,
                             seed=4, metrics_interval=0.5)
    if name == "model-mix":
        with pytest.raises(NotImplementedError, match="Queue A item 9b"):
            scenario_spec(name, stage_times=STAGE_TIMES, n_requests=40)
        return
    got = scenario_spec(name, stage_times=STAGE_TIMES, n_requests=40, seed=4,
                        metrics_interval=0.5)
    assert got.validate().to_dict() == want.to_dict()
    # a measured capacity scales the rates instead of the nominal rate
    scen = SCENARIOS[name]
    cap = scen.scaled_arrival(capacity=250.0)
    nom = scen.scaled_arrival(stage_times=[1.0 / 250.0])
    assert cap.keys() == nom.keys() and cap["kind"] == nom["kind"]
    assert all(np.isclose(cap[k], nom[k]) for k in cap if k != "kind")


# ---------------------------------------------------------------------------
# Service on source="traffic": per-request records and snapshots
# ---------------------------------------------------------------------------

def _traffic_run(pkg, name, admission, n_requests=150):
    serving, spec_fn = PACKAGES[pkg]
    conf, correct = oracle_tables()
    streamed = []
    spec = spec_fn(name, policy="rtdeepiot", stage_times=STAGE_TIMES,
                   n_requests=n_requests, admission=admission, seed=1,
                   metrics_interval=0.25)
    svc = serving.Service.from_spec(spec, conf_table=conf,
                                    correct_table=correct,
                                    on_metrics=streamed.append)
    res = svc.run()
    assert [s.to_dict() for s in streamed] == \
        [s.to_dict() for s in svc.snapshots]
    return res, [s.to_dict() for s in svc.snapshots]


@pytest.mark.parametrize("admission", ["none", "reject", "depth_cap"])
@pytest.mark.parametrize("name", ["steady", "2x-overload", "flash-crowd"])
def test_traffic_service_matches_jax_bitwise(name, admission):
    adm = {} if admission == "none" else {"mode": admission}
    (want, wsnaps), (got, gsnaps) = (_traffic_run(pkg, name, adm)
                                     for pkg in ("jax", "torch"))
    assert _rows(got.per_request) == _rows(want.per_request)
    assert (got.accuracy, got.miss_rate, got.mean_depth, got.makespan,
            got.n_dispatches, got.rejected, got.capped, got.per_class) == \
        (want.accuracy, want.miss_rate, want.mean_depth, want.makespan,
         want.n_dispatches, want.rejected, want.capped, want.per_class)
    assert gsnaps == wsnaps and len(gsnaps) > 2
    assert sum(s["n"] for s in gsnaps) == got.n_requests == 150
    if name == "flash-crowd" and admission != "none":
        assert got.rejected + got.capped > 0    # the spike was shed


def _live_spec(serving, **source_args):
    return serving.ServeSpec(
        policy="edf", executor="oracle", clock="virtual", source="live",
        source_args=source_args, metrics_interval=0.01,
        batching={"mode": "none", "stage_times": list(STAGE_TIMES)},
        slo_classes={"gold": {"rel_deadline": 0.5, "utility_weight": 2.0}},
        default_slo="gold")


@pytest.mark.parametrize("overflow", ["reject", "shed-optional"])
def test_backpressure_modes_match_jax(overflow):
    conf, correct = oracle_tables()
    out = []
    for serving in (jserving, tserving):
        svc = serving.Service.from_spec(
            _live_spec(serving, bound=2, overflow=overflow),
            conf_table=conf, correct_table=correct)
        handles = [svc.submit(serving.Request(None, sample=i), at=0.002 * i)
                   for i in range(6)]
        met = svc.drain()
        results = [h.result() for h in handles]
        out.append(([(r.sample, r.depth, r.missed, r.rejected, r.slo,
                      r.latency) for r in results], _rows(met.per_request),
                    met.rejected, met.capped, met.per_class,
                    [s.to_dict() for s in svc.snapshots]))
    assert out[1] == out[0]
    if overflow == "reject":
        assert out[1][2] == 4 and out[1][3] == 0
    else:
        assert out[1][2] == 0 and out[1][3] == 4


def test_cancel_after_admission_matches_jax():
    """Wall clock (post-admission cancel needs the live engine thread):
    the cancelled request keeps a partial result short of full depth in
    both packages."""
    conf, correct = oracle_tables()
    out = []
    for serving in (jserving, tserving):
        spec = serving.ServeSpec(
            policy="edf", executor="oracle", clock="wall", source="live",
            batching={"mode": "none", "stage_times": [0.04, 0.04, 0.04]},
            slo_classes={"gold": {"rel_deadline": 5.0}}, default_slo="gold")
        with serving.Service.from_spec(spec, conf_table=conf,
                                       correct_table=correct) as svc:
            h = svc.submit(serving.Request(None, sample=3))
            first = next(h.stages(timeout=10.0))
            assert first.depth == 1 and h.cancel()
            res = h.result(timeout=10.0)
            met = svc.drain()
        assert not h.cancelled() and 1 <= res.depth < 3
        row = met.per_request[0]
        out.append((res.sample, res.missed, res.rejected, res.slo,
                    met.cancelled, met.n_requests, row["rel_deadline"],
                    row["weight"]))
    assert out[1] == out[0] == (3, False, False, "gold", 1, 1, 5.0, 1.0)


# ---------------------------------------------------------------------------
# trace record/replay across packages
# ---------------------------------------------------------------------------

def test_trace_written_by_either_package_loads_in_the_other(tmp_path):
    conf, correct = oracle_tables()
    paths = {}
    for pkg, record in (("jax", jax_record_trace), ("torch", record_trace)):
        serving, spec_fn = PACKAGES[pkg]
        spec = spec_fn("flash-crowd", admission={"mode": "reject"},
                       stage_times=STAGE_TIMES, n_requests=100, seed=3)
        res = serving.Service.from_spec(spec, conf_table=conf,
                                        correct_table=correct).run()
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        record(res, str(paths[pkg]), source="traffic", spec=spec)
    # the same run serialises to the same bytes
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    for a, b in (("jax", "torch"), ("torch", "jax")):
        h_ours, ev_ours = load_trace(str(paths[a]))
        h_ref, ev_ref = jax_load_trace(str(paths[b]))
        assert h_ours == h_ref and len(ev_ours) == 100
        assert [e.to_json() for e in ev_ours] == \
            [e.to_json() for e in ev_ref]
        assert tserving.ServeSpec.from_dict(h_ours["spec"]).validate()


def _replay(serving, spec, events, conf, correct):
    spec = dataclasses.replace(spec, source="replay", source_args={},
                               metrics_interval=0.0)
    return serving.Service.from_spec(spec, conf_table=conf,
                                     correct_table=correct,
                                     trace=events).run()


def test_mini_trace_replays_to_the_jax_outcomes():
    """The checked-in version-1 trace (written by the JAX package) against
    its recorded spec: the port gives the JAX package's replay bit for bit
    and ``verify_replay`` holds between them.  Both packages' replays
    differ from the outcomes recorded in the file at the same requests
    (ROADMAP C-ref 10: the reference's scheduling drifted after the trace
    was written), so the recorded outcomes are not the expected values."""
    from repro.serving import ServeSpec as JaxServeSpec
    header, events = load_trace(str(MINI_TRACE))
    assert header["version"] == 1 and len(events) == header["n_events"]
    conf, correct = synthetic_tables()       # the tables it was recorded on
    got = _replay(tserving, tserving.ServeSpec.from_dict(header["spec"]),
                  events, conf, correct)
    _, jevents = jax_load_trace(str(MINI_TRACE))
    want = _replay(jserving, JaxServeSpec.from_dict(header["spec"]),
                   jevents, conf, correct)
    assert _rows(got.per_request) == _rows(want.per_request)
    assert verify_replay(want.per_request, got.per_request)["bitwise"]
    assert got.rejected > 0

    def drift(res):
        rows = sorted(res.per_request, key=lambda r: r["tid"])
        return [i for i, (e, r) in enumerate(zip(events, rows))
                if (e.outcome["rejected"], e.outcome["depth"],
                    e.outcome["missed"]) != (r["rejected"], r["depth"],
                                             r["missed"])]
    assert drift(got) == drift(want)


def test_port_trace_replays_bitwise_in_both_packages(tmp_path):
    conf, correct = oracle_tables()
    spec = scenario_spec("flash-crowd", admission={"mode": "depth_cap"},
                         stage_times=STAGE_TIMES, n_requests=150, seed=3)
    orig = tserving.Service.from_spec(spec, conf_table=conf,
                                      correct_table=correct).run()
    path = str(tmp_path / "t.jsonl")
    record_trace(orig, path, source="traffic", spec=spec)
    _, events = load_trace(path)
    ours = _replay(tserving, spec, events, conf, correct)
    _, jevents = jax_load_trace(path)
    jspec = jserving.ServeSpec.from_dict(spec.to_dict())
    ref = _replay(jserving, jspec, jevents, conf, correct)
    assert orig.capped > 0
    assert verify_replay(orig.per_request, ours.per_request)["bitwise"]
    assert verify_replay(orig.per_request, ref.per_request)["bitwise"]


def test_replay_source_attaches_inputs_and_needs_a_trace(tmp_path):
    _, events = load_trace(str(MINI_TRACE))
    stream = replay_stream(events[:5], inputs_fn=lambda s: {"s": s})
    assert [r.inputs for _, r in stream] == [{"s": e.sample}
                                             for e in events[:5]]
    assert all(r.inputs is None for _, r in replay_stream(events[:5]))
    conf, correct = oracle_tables()
    spec = dataclasses.replace(
        scenario_spec("steady", stage_times=STAGE_TIMES, n_requests=5),
        source="replay", source_args={})
    with pytest.raises(KeyError, match="trace"):
        tserving.Service.from_spec(spec, conf_table=conf,
                                   correct_table=correct).run()


def test_plane_beyond_records_raises():
    import repro_torch.serving.plane as plane
    assert plane.Record is tserving.Record
    for name in ("Journal", "DurableQueue", "FrontDoor", "journal_stats",
                 "recover"):
        with pytest.raises(NotImplementedError, match="Queue A item 9b"):
            getattr(plane, name)
    with pytest.raises(AttributeError):
        plane.nothing_here


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_traffic_replay_launcher_oracle_smoke(tmp_path, capsys):
    from repro_torch.launch import traffic_replay
    out = traffic_replay.main(["--smoke", "--device", "cpu",
                               "--trace-export", str(tmp_path)])
    assert out["replay"]["bitwise"] and out["snapshots"]
    assert (tmp_path / "obs.jsonl").exists()
    assert "OK" in capsys.readouterr().out


def test_traffic_replay_launcher_regression_mode_flags_drift():
    """``--trace`` on the checked-in trace raises, as the JAX example
    does: both packages' replays differ from the recorded outcomes
    (ROADMAP C-ref 10), and the launcher names the requests that do."""
    from repro_torch.launch import traffic_replay
    with pytest.raises(AssertionError, match=r"7 of 50 recorded outcomes "
                       r"diverged \(requests \[21, 36, 39, 42, 44, 47, 48\]"):
        traffic_replay.main(["--trace", str(MINI_TRACE)])


def test_traffic_replay_launcher_card_mode_on_cpu(tmp_path):
    """The card path's legs on the CPU at a tiny size (the exit runs its
    plain version, so no launch is counted): capacity, the load legs
    scaled from it, the traced leg's checks and the wall-clock replay."""
    from repro_torch.launch import traffic_replay
    out = traffic_replay.main(["--executor", "device-kernel", "--smoke",
                               "--requests", "16", "--device", "cpu",
                               "--ckpt", str(tmp_path / "none.ckpt"),
                               "--trace-export", str(tmp_path)])
    assert out["capacity"] > 0
    assert out["offered"]["2x-overload"] >= 2.0 * out["capacity"]
    assert len([k for k in out["legs"] if "/" in k]) == 10
    assert all(out["checks"].values()) and out["replay"]["arrival_order"]
    assert out["exit_launches"] == 0
    assert (tmp_path / "chrome.json").exists()
