"""Traffic generation, overload control, trace replay and request tracing
in one sitting — the counterpart of ``examples/traffic_replay.py``.

**Oracle mode** (``--executor oracle``, the default; virtual clock, seed-0
synthetic oracle tables, so it needs no device):

1. an open-loop **flash-crowd** (:mod:`repro_torch.serving.traffic`):
   Poisson base load with a 5x spike, RTDeepIoT behind depth-cap
   admission, streamed windowed metrics (queue depth, windowed miss rate,
   utilization);
2. the same crowd on uncontrolled EDF;
3. the controlled run **recorded** into a JSONL trace and **replayed**
   through ``register_source("replay")``: arrival order and admission
   decisions must reproduce bit for bit.

``--trace PATH`` replays a checked-in trace (e.g.
``examples/data/mini_trace.jsonl``, written by the JAX package) against
its recorded ``ServeSpec`` and checks the recorded outcomes reproduce
(regression mode).  ``--trace-export DIR`` traces the controlled run
(:mod:`repro_torch.serving.obs`) and writes ``DIR/obs.jsonl`` and the
Chrome trace ``DIR/chrome.json``.

**Card mode** (``--executor device-kernel``): the trained anytime
classifier (``--ckpt``) on ``device-kernel`` — every stage dispatch ends
in the exit-confidence CUDA kernel — with buckets {1, 2, 4, 8},
``pipeline_depth`` 3, on the wall clock, under the catalog's gold /
silver / bronze SLO mix:

* capacity: EDF on a saturating closed-loop stream (as many clients as
  requests, so every request is issued at once; deadlines far away, so
  every request runs all three stages); completed requests per second
  of the run is the sustained full-depth rate;
* load: ``steady`` (0.6x) and ``2x-overload`` (2.0x) scaled from that
  rate, each on uncontrolled EDF, RTDeepIoT, and RTDeepIoT behind
  ``reject`` and ``depth_cap`` admission;
* the 2x RTDeepIoT-reject leg again with tracing on (spans, time
  splits, device windows, the JSONL and Chrome exports read back);
* that leg recorded and replayed through ``source="replay"``: the arrival
  order must hold; admission agreement is printed (wall time decides it).

  PYTHONPATH=src python -m repro_torch.launch.traffic_replay [--smoke]
      [--trace PATH] [--trace-export DIR]
  PYTHONPATH=src python -m repro_torch.launch.traffic_replay \\
      --executor device-kernel --ckpt build/train/anytime_classifier.ckpt

Card mode runs on the card (``--device cuda``, the default) unless asked
for the CPU (``--device cpu``, where the exit runs its plain version).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
import warnings

import numpy as np

from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.serving import (ServeSpec, Service, load_trace,
                                 record_trace, scenario_spec, verify_replay)
from repro_torch.serving.obs import load_obs, validate_chrome_trace
from repro_torch.serving.traffic import SCENARIOS, SLO_CLASSES
from repro_torch.serving.traffic.trace import admission_signature

STAGE_TIMES = (0.004, 0.007, 0.010)
BUCKETS = (1, 2, 4, 8)
RTDEEPIOT_ARGS = {"predictor": "exp", "prior_curve": [0.5, 0.7, 0.85]}
#: the card's load legs: (name, policy, policy_args, admission)
LEG_CONFIGS = (("edf", "edf", {}, {}),
               ("rtdeepiot", "rtdeepiot", RTDEEPIOT_ARGS, {}),
               ("rtdeepiot-reject", "rtdeepiot", RTDEEPIOT_ARGS,
                {"mode": "reject"}),
               ("rtdeepiot-depth_cap", "rtdeepiot", RTDEEPIOT_ARGS,
                {"mode": "depth_cap"}))
LOAD_SCENARIOS = ("steady", "2x-overload")
TRACED_LEG = ("2x-overload", "rtdeepiot-reject")


def synthetic_tables(n=120, L=3, seed=0):
    """Oracle-shaped tables: monotone per-sample confidence curves with
    confidence-consistent correctness (the JAX example's recipe, so its
    checked-in traces replay here)."""
    rng = np.random.default_rng(seed)
    conf = np.sort(rng.uniform(0.3, 1.0, (n, L)), axis=1)
    correct = rng.uniform(size=(n, L)) < conf
    return conf, correct.astype(bool)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--executor", choices=("oracle", "device-kernel"),
                    default="oracle")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests a run (oracle: 600; card legs: 300)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny runs, no artifact writes")
    ap.add_argument("--trace", default=None,
                    help="replay this JSONL trace (regression mode)")
    ap.add_argument("--trace-export", default=None,
                    help="write the traced run's obs JSONL and Chrome trace "
                         "to this directory")
    ap.add_argument("--ckpt", default="build/train/anytime_classifier.ckpt",
                    help="card mode: the trained classifier's checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="card mode: where the model runs (default: the "
                         "card)")
    args = ap.parse_args(argv)
    # the launcher stays on the ServeSpec front door
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=r".*ServeSpec",
                                category=DeprecationWarning)
        if args.executor == "oracle":
            return _oracle(args)
        return _card(args)


# ---------------------------------------------------------------------------
# oracle mode (virtual clock): bit-for-bit claims
# ---------------------------------------------------------------------------

def replay_checked_in(path: str) -> dict:
    """Regression mode: replay a recorded trace against its stored spec
    and check the recorded outcomes reproduce."""
    header, events = load_trace(path)
    spec = ServeSpec.from_dict(header["spec"])
    spec = dataclasses.replace(spec, source="replay", source_args={})
    conf, correct = synthetic_tables()
    res = Service.from_spec(spec, conf_table=conf, correct_table=correct,
                            trace=events).run()
    recorded = [(ev.outcome["rejected"], ev.outcome["depth"],
                 ev.outcome["missed"]) for ev in events]
    replayed = [(r["rejected"], r["depth"], r["missed"])
                for r in sorted(res.per_request, key=lambda r: r["tid"])]
    diverged = [i for i, (a, b) in enumerate(zip(recorded, replayed))
                if a != b]
    if diverged:
        raise AssertionError(
            f"replay diverged from the recorded outcomes: {len(diverged)} "
            f"of {len(recorded)} recorded outcomes diverged (requests "
            f"{diverged}) — scheduling behavior changed since this trace "
            "was recorded")
    print(f"replayed {len(events)} recorded requests from {path}: "
          f"outcomes reproduce bit-for-bit "
          f"(miss={res.miss_rate:.3f}, rejected={res.rejected})")
    return dict(n=len(events), miss_rate=res.miss_rate,
                rejected=res.rejected)


def _oracle(args) -> dict:
    out: dict = {}
    if args.trace:
        out["regression"] = replay_checked_in(args.trace)
        if not args.smoke:
            return out
    n_requests = 80 if args.smoke else (args.requests or 600)
    conf, correct = synthetic_tables()

    # -- 1. flash crowd with streamed windowed metrics ------------------
    print("flash-crowd scenario, RTDeepIoT + admission control "
          "(windowed metrics):")
    print(f"{'t':>6} {'n':>4} {'miss%':>6} {'queue':>6} {'util%':>6} "
          f"{'shed':>5} {'rej':>4}")

    def show(s):
        print(f"{s.t:6.2f} {s.n:4d} {100 * s.miss_rate:6.1f} "
              f"{s.queue_depth:6d} {100 * s.utilization:6.1f} "
              f"{s.capped:5d} {s.rejected:4d}")

    trace = {}
    if args.trace_export:
        os.makedirs(args.trace_export, exist_ok=True)
        trace = {"enabled": True,
                 "export": os.path.join(args.trace_export, "obs.jsonl"),
                 "chrome": os.path.join(args.trace_export, "chrome.json")}
    spec = scenario_spec("flash-crowd", policy="rtdeepiot",
                         admission={"mode": "depth_cap"},
                         stage_times=STAGE_TIMES, n_requests=n_requests,
                         metrics_interval=0.5, trace=trace)
    svc = Service.from_spec(spec, conf_table=conf, correct_table=correct,
                            on_metrics=show)
    controlled = svc.run()

    # -- 2. the same crowd, uncontrolled EDF ----------------------------
    edf = Service.from_spec(
        scenario_spec("flash-crowd", policy="edf", stage_times=STAGE_TIMES,
                      n_requests=n_requests),
        conf_table=conf, correct_table=correct).run()
    print(f"\nuncontrolled edf:        miss={edf.miss_rate:.3f} "
          f"acc={edf.accuracy:.3f}")
    print(f"rtdeepiot + shedding:    miss={controlled.miss_rate:.3f} "
          f"acc={controlled.accuracy:.3f} capped={controlled.capped}")

    # -- 3. record -> replay, bit-for-bit -------------------------------
    tmp = None
    if args.smoke or not args.trace_export:
        tmp = tempfile.TemporaryDirectory()
        trace_path = os.path.join(tmp.name, "flash_crowd.jsonl")
    else:
        trace_path = os.path.join(args.trace_export, "flash_crowd.jsonl")
    record_trace(controlled, trace_path, source="traffic", spec=spec)
    _, events = load_trace(trace_path)
    replayed = Service.from_spec(
        dataclasses.replace(spec, source="replay", source_args={},
                            metrics_interval=0.0, trace={}),
        conf_table=conf, correct_table=correct, trace=events).run()
    v = verify_replay(controlled.per_request, replayed.per_request)
    print(f"\nrecorded {len(events)} requests -> {trace_path}")
    print(f"replay: arrival_order={v['arrival_order']} "
          f"admission_decisions={v['admission_decisions']} "
          f"bitwise={v['bitwise']}")
    if tmp is not None:
        tmp.cleanup()
    if not v["bitwise"]:
        raise AssertionError("replay must reproduce the run bit-for-bit")
    if args.trace_export:
        print(f"obs export: {trace['export']}, {trace['chrome']} "
              f"({len(svc.obs.traces)} traces, {len(svc.obs.audit_log)} "
              "audit rows)")
    print("OK")
    out.update(controlled=controlled, edf=edf, replay=v,
               snapshots=list(svc.snapshots))
    return out


# ---------------------------------------------------------------------------
# card mode (device-kernel, wall clock)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CardContext:
    """What every card leg shares: the model, its stage fns and profiled
    time model, and the test set the requests draw from."""
    cfg: object
    params: dict
    stage_fns: object
    time_model: object
    host_overhead: float
    features: np.ndarray
    labels: np.ndarray

    def inputs(self, sample: int) -> dict:
        return {"features": self.features[sample:sample + 1]}

    def resources(self) -> dict:
        return dict(cfg=self.cfg, params=self.params,
                    stage_fns=self.stage_fns, time_model=self.time_model,
                    labels=self.labels, n_samples=len(self.labels),
                    traffic_inputs=self.inputs)

    def spec(self, policy, policy_args, **kw) -> ServeSpec:
        return ServeSpec(policy=policy, policy_args=policy_args,
                         executor="device-kernel", clock="wall",
                         host_overhead=self.host_overhead, pipeline_depth=3,
                         slo_classes=dict(SLO_CLASSES), **kw)


def card_context(params, *, n_runs: int = 30, n_test: int = 600,
                 buckets=BUCKETS) -> CardContext:
    """Warm the kernel-backed stage fns at every bucket and profile their
    (stage, bucket) WCETs and the host overhead on the params' device."""
    from repro_torch.configs import get_config
    from repro_torch.launch.kernel import KernelStageFns
    from repro_torch.models import params_device
    from repro_torch.serving import (profile_batched_stages,
                                     profile_host_overhead)
    from repro_torch.training import DifficultyDataset

    cfg = get_config("anytime-classifier")
    test = DifficultyDataset(num_classes=cfg.vocab_size, seed=0).sample(
        n_test, seed=999)
    features = np.asarray(test["inputs"]["features"])
    kfns = KernelStageFns(cfg, tuple(sorted(buckets)))
    sample = {"features": features[:1]}
    kfns.warmup(params, sample)
    tm, _ = profile_batched_stages(cfg, params, kfns, sample, n_runs=n_runs)
    host = profile_host_overhead(device=params_device(params))
    return CardContext(cfg=cfg, params=params, stage_fns=kfns,
                       time_model=tm, host_overhead=host, features=features,
                       labels=np.asarray(test["labels"]))


def _leg_summary(svc, res, *, wall_s: float, launches: int) -> dict:
    rows = res.per_request
    admitted = [r for r in rows if not r["rejected"]]
    snaps = svc.snapshots
    lat = [r["latency"] for r in rows]
    dts = svc.executor.device_time_stats()
    return dict(
        n=res.n_requests, miss_rate=res.miss_rate,
        admitted_miss_rate=(sum(r["missed"] for r in admitted)
                            / len(admitted)) if admitted else 0.0,
        rejected=res.rejected, capped=res.capped, accuracy=res.accuracy,
        mean_depth=res.mean_depth,
        mean_latency_ms=1e3 * float(np.mean(lat)) if lat else 0.0,
        per_class={k: dict(v) for k, v in sorted(res.per_class.items())},
        peak_queue_depth=max((s.active for s in snaps), default=0),
        peak_windowed_miss_rate=max((s.miss_rate for s in snaps),
                                    default=0.0),
        n_snapshots=len(snaps), n_dispatches=res.n_dispatches,
        exit_launches=launches, wall_s=wall_s,
        sched_s=float(svc.policy.sched_time),
        host_s=dts["host_time"], device_wait_s=dts["device_time"])


def run_leg(ctx: CardContext, policy, policy_args, admission, *,
            source="traffic", source_args=None, metrics_interval=0.02,
            trace=None, stream=None):
    """One wall-clock run on ``device-kernel``; returns (service, metrics,
    summary).  The summary's ``exit_launches`` counts the exit kernel's
    launches during the run (0 on the CPU, where the exit runs its plain
    version)."""
    spec = ctx.spec(policy, policy_args, source=source,
                    source_args=source_args or {}, admission=admission,
                    metrics_interval=metrics_interval, trace=trace or {})
    svc = Service.from_spec(spec, ctx.resources())
    n0 = exit_confidence.launches
    t0 = time.perf_counter()
    res = svc.run(stream)
    wall = time.perf_counter() - t0
    summary = _leg_summary(svc, res, wall_s=wall,
                           launches=exit_confidence.launches - n0)
    return svc, res, summary


def measure_capacity(ctx: CardContext, n_requests: int) -> dict:
    """EDF on a saturating closed-loop stream: as many clients as
    requests, so every request is issued at t = 0, with a deadline far
    beyond the run, so every one runs all stages in batches of the
    largest bucket.  Completed requests per
    second of the run is the sustained full-depth rate."""
    from repro_torch.serving import Request
    far = 60.0
    stream = [(0.0, Request(ctx.inputs(i % len(ctx.labels)), far,
                            i % len(ctx.labels), i))
              for i in range(n_requests)]
    svc, res, leg = run_leg(ctx, "edf", {}, {}, source="stream",
                            stream=stream, metrics_interval=0.0)
    depths = [r["depth"] for r in res.per_request]
    full = ctx.cfg.num_stages
    if res.n_requests != n_requests or any(d != full for d in depths):
        raise AssertionError(
            f"capacity run: {res.n_requests} of {n_requests} requests, "
            f"depths {np.bincount(depths, minlength=full + 1).tolist()}: "
            "not every request ran all stages")
    leg.update(rate=n_requests / max(res.makespan, 1e-9),
               makespan_s=res.makespan)
    return leg


def _print_leg(name: str, leg: dict) -> None:
    per_class = " ".join(
        f"{c}(n={v['n']} miss={v['miss_rate']:.4f} rej={v['rejected']} "
        f"depth={v['mean_depth']:.3f} lat={1e3 * v['mean_latency']:.2f}ms)"
        for c, v in leg["per_class"].items())
    acc = leg["accuracy"]
    print(f"{name:32s} miss={leg['miss_rate']:.4f} "
          f"admitted_miss={leg['admitted_miss_rate']:.4f} "
          f"rejected={leg['rejected']} capped={leg['capped']} "
          f"acc={'n/a' if acc is None else f'{acc:.4f}'} "
          f"depth={leg['mean_depth']:.4f} "
          f"latency={leg['mean_latency_ms']:.3f}ms "
          f"peak_queue={leg['peak_queue_depth']} "
          f"peak_window_miss={leg['peak_windowed_miss_rate']:.4f} "
          f"dispatches={leg['n_dispatches']} "
          f"exit_launches={leg['exit_launches']} wall={leg['wall_s']:.4f}s "
          f"sched={leg['sched_s']:.4f}s stage_host={leg['host_s']:.4f}s "
          f"device_wait={leg['device_wait_s']:.4f}s")
    print(f"{'':32s} per class: {per_class}")


def check_traced(svc, res, export: str, chrome: str) -> dict:
    """The traced leg's checks: a trace per response, ordered spans, the
    time split (queue wait + host + device = latency within 1e-9 s unless
    the tracer clamped host time at 0), one device window a dispatch, the
    JSONL export read back, the Chrome document valid."""
    obs = svc.obs
    traces = obs.traces
    tids = sorted(r["tid"] for r in res.per_request)
    ordered, split_bad, clamped = True, [], 0
    for tr in traces.values():
        names = tr.span_names()
        ts = [s.t0 for s in tr.spans]
        ordered &= (ts == sorted(ts) and names[0] == "queued"
                    and names[-1] in ("retire", "expire"))
        total = tr.queue_wait + tr.host_time + tr.device_time
        if tr.host_time == 0.0 and tr.queue_wait + tr.device_time \
                > tr.latency:
            clamped += 1
        elif abs(total - tr.latency) > 1e-9:
            split_bad.append(tr.tid)
    loaded = load_obs(export)
    with open(chrome) as fh:
        problems = validate_chrome_trace(json.load(fh))
    charged = [tr.device_time for tr in traces.values()]
    checks = {
        "a trace for every response": sorted(traces) == tids,
        "spans ordered": ordered,
        "queue wait + host + device = latency": not split_bad,
        "device windows = dispatches": len(obs.windows) == res.n_dispatches,
        "JSONL export reads back":
            len(loaded["traces"]) == len(tids)
            and len(loaded["windows"]) == len(obs.windows)
            and loaded["metrics"] == obs.registry.to_dict(),
        "Chrome trace valid": problems == [],
    }
    return dict(checks=checks, clamped=clamped, split_bad=split_bad[:10],
                chrome_problems=problems[:10],
                device_time_per_request_ms=1e3 * float(np.mean(charged)),
                n_windows=len(obs.windows), n_audit=len(obs.audit_log))


def _card(args) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint

    smoke = args.smoke
    n_leg = args.requests or (40 if smoke else 300)
    n_cap = 48 if smoke else 240
    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    if os.path.exists(args.ckpt):
        params, meta = checkpoint.load(args.ckpt, params, cfg=cfg)
        print(f"loaded checkpoint {args.ckpt} ({meta.get('steps')} steps)")
    else:
        print(f"no checkpoint at {args.ckpt} — using random seed-0 params")
    ctx = card_context(params, n_runs=5 if smoke else 30)
    on_card = params["exit_shared"]["w_out"].is_cuda
    wcet = np.asarray(ctx.time_model.times) * 1e3
    print(f"stage WCETs (ms) [stage x bucket {list(BUCKETS)}]: "
          f"{np.array2string(wcet, precision=4)}; host overhead "
          f"{ctx.host_overhead * 1e6:.1f} us")

    cap = measure_capacity(ctx, n_cap)
    capacity = cap["rate"]
    print(f"capacity: EDF, {n_cap} requests issued at once, all at depth "
          f"{cfg.num_stages}: {capacity:.2f} req/s sustained "
          f"(makespan {cap['makespan_s']:.4f}s, {cap['n_dispatches']} "
          f"dispatches, exit launches {cap['exit_launches']})")

    offered = {}
    for name in LOAD_SCENARIOS:
        arr = SCENARIOS[name].scaled_arrival(capacity=capacity)
        offered[name] = arr["rate"]
    if offered["2x-overload"] < 2.0 * capacity:
        raise AssertionError(f"overload leg offers {offered['2x-overload']} "
                             f"req/s, below 2x the measured {capacity}")
    print("offered: " + ", ".join(
        f"{name} {rate:.2f} req/s ({rate / capacity:.2f}x)"
        for name, rate in offered.items()))

    legs: dict = {}
    services: dict = {}
    for scen in LOAD_SCENARIOS:
        for name, policy, pargs, adm in LEG_CONFIGS:
            src = SCENARIOS[scen].source_args(capacity=capacity,
                                              n_requests=n_leg, seed=0)
            svc, res, leg = run_leg(ctx, policy, pargs, adm,
                                    source_args=src)
            offs = [r["offset"] for r in res.per_request]
            leg["offered_rate"] = offered[scen]
            leg["realized_rate"] = len(offs) / max(max(offs), 1e-9)
            key = f"{scen}/{name}"
            legs[key] = leg
            services[key] = (svc, res)
            _print_leg(key, leg)
    edf_lo = legs["steady/edf"]["miss_rate"]
    edf_hi = legs["2x-overload/edf"]["miss_rate"]
    if edf_hi <= edf_lo:
        print(f"finding: EDF at 2x missed {edf_hi:.4f}, no more than at "
              f"0.6x ({edf_lo:.4f})")

    # -- tracing on the 2x RTDeepIoT-reject leg -------------------------
    scen, name = TRACED_LEG
    cfg_row = next(c for c in LEG_CONFIGS if c[0] == name)
    tmp = None
    out_dir = args.trace_export
    if out_dir is None:
        tmp = tempfile.TemporaryDirectory()
        out_dir = tmp.name
    os.makedirs(out_dir, exist_ok=True)
    export = os.path.join(out_dir, "obs.jsonl")
    chrome = os.path.join(out_dir, "chrome.json")
    src = SCENARIOS[scen].source_args(capacity=capacity, n_requests=n_leg,
                                      seed=0)
    tsvc, tres, tleg = run_leg(ctx, cfg_row[1], cfg_row[2], cfg_row[3],
                               source_args=src,
                               trace={"enabled": True, "export": export,
                                      "chrome": chrome})
    traced = check_traced(tsvc, tres, export, chrome)
    traced.update(wall_s=tleg["wall_s"],
                  untraced_wall_s=legs[f"{scen}/{name}"]["wall_s"],
                  n_dispatches=tleg["n_dispatches"],
                  exit_launches=tleg["exit_launches"])
    legs[f"{scen}/{name} traced"] = tleg
    _print_leg(f"{scen}/{name} traced", tleg)
    print(f"traced leg: wall {traced['wall_s']:.4f}s traced, "
          f"{traced['untraced_wall_s']:.4f}s untraced; "
          f"{traced['n_windows']} device windows, "
          f"{traced['n_audit']} audit rows, device time charged a request "
          f"{traced['device_time_per_request_ms']:.4f}ms, host time clamped "
          f"at 0 in {traced['clamped']} requests; checks "
          f"{json.dumps(traced['checks'])}")

    # -- record the untraced 2x RTDeepIoT-reject leg, replay it ---------
    osvc, ores = services[f"{scen}/{name}"]
    trace_path = os.path.join(out_dir, "traffic_trace.jsonl")
    record_trace(ores, trace_path, source="traffic", spec=osvc.spec)
    _, events = load_trace(trace_path)
    rsvc, rres, rleg = run_leg(ctx, cfg_row[1], cfg_row[2], cfg_row[3],
                               source="replay",
                               source_args={"path": trace_path},
                               metrics_interval=0.0)
    v = verify_replay(ores.per_request, rres.per_request)
    a, b = (admission_signature(r.per_request) for r in (ores, rres))
    agree = sum(x == y for x, y in zip(a, b)) / max(1, len(a))
    replay = dict(n=len(events), arrival_order=v["arrival_order"],
                  admission_agreement=agree,
                  admission_decisions=v["admission_decisions"],
                  n_dispatches=rleg["n_dispatches"],
                  exit_launches=rleg["exit_launches"])
    legs[f"{scen}/{name} replay"] = rleg
    _print_leg(f"{scen}/{name} replay", rleg)
    print(f"replay of {len(events)} recorded requests on the wall clock: "
          f"arrival order {v['arrival_order']}, admission agreement "
          f"{agree:.4f} (bit for bit: {v['admission_decisions']})")
    if tmp is not None:
        tmp.cleanup()

    runs = {"capacity": cap, **legs}
    checks = {
        "traced leg": all(traced["checks"].values()),
        "replay keeps arrival order": v["arrival_order"],
        "every run on the wall clock": all(
            s.spec.clock == "wall" for s, _ in services.values()),
        "hidden-state cache empty after every leg": all(
            s.executor.cache_stats()["live"] == 0
            for s, _ in services.values()),
    }
    if on_card:
        checks["exit launches = dispatches in every run"] = all(
            run["exit_launches"] == run["n_dispatches"]
            for run in runs.values())
    failed = [k for k, ok in checks.items() if not ok]
    print(f"card traffic checks: {json.dumps(checks)}")
    if failed:
        raise AssertionError(f"traffic legs failed: {failed}")
    return dict(capacity=capacity, capacity_run=cap, offered=offered,
                legs=legs, traced=traced, replay=replay, checks=checks,
                n_dispatches=sum(r["n_dispatches"] for r in runs.values()),
                exit_launches=sum(r["exit_launches"] for r in runs.values()))


if __name__ == "__main__":
    main()
