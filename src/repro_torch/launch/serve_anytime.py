"""End-to-end anytime serving launcher (paper Fig. 2) — the real model on
the wall clock (``examples/serve_anytime.py``).

Loads the trained anytime classifier, profiles per-stage WCETs (99th
percentile, paper §IV protocol) plus the host dispatch overhead, then
serves requests from K concurrent clients under uniform-random relative
deadlines with the RTDeepIoT scheduler and EDF, reporting accuracy / miss
rate / depth / latency from real stage executions on the device.

Every engine is built through the public serving API: a declarative
``ServeSpec`` names the policy / executor / clock / source by registry key
(``device-single`` = unbatched per-stage dispatch, ``device-batched`` =
continuous micro-batching, ``pipeline_depth=2`` = pipelined async
dispatch, ``device-kernel`` with ``--kernels`` = stage bodies ending in the
exit-confidence CUDA kernel at ``pipeline_depth=3``), and
``repro_torch.serving.Service`` owns the engine lifecycle; the params,
stage fns and profiled time model ride along as resources.  The legacy
shims' ``DeprecationWarning`` is raised to an error while it runs, so a
regression onto them fails loudly.  The JAX example's ``device-sharded``
leg has no counterpart here: that executor is ROADMAP Queue A item 10.

Also writes ``stage_times.npz`` (keys ``wcet``, ``samples``,
``host_overhead``, as the JAX example writes them) under ``--out``
(default ``artifacts/torch``; with ``--smoke`` only when ``--out`` is
given).

  PYTHONPATH=src python -m repro_torch.launch.serve_anytime [--requests 120]
      [--kernels] [--ckpt PATH] [--device cuda] [--out DIR] [--smoke]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).  ``--ckpt`` defaults to the checkpoint
``repro_torch.training.multiexit`` writes
(``artifacts/torch/anytime_classifier.ckpt``); without one it says so and
serves random seed-0 params.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import warnings

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.launch.kernel import KernelStageFns
from repro_torch.models import init_params
from repro_torch.serving import (BatchedStageFns, ServeSpec, Service,
                                 closed_loop_stream, make_stage_fns,
                                 profile_batched_stages, profile_stages)
from repro_torch.training import DifficultyDataset, checkpoint

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch"

POLICIES = [("rtdeepiot", {"predictor": "exp",
                           "prior_curve": [.5, .7, .85]}),
            ("edf", {})]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--d-lo", type=float, default=None,
                    help="min relative deadline (default: 4x the largest "
                         "stage WCET)")
    ap.add_argument("--d-hi", type=float, default=None,
                    help="max relative deadline (default: 14x the largest "
                         "stage WCET)")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="batch-size buckets of the batched engines")
    ap.add_argument("--kernels", action="store_true",
                    help="also serve on 'device-kernel' (stage bodies ending "
                         "in the exit-confidence kernel, pipeline_depth=3)")
    ap.add_argument("--ckpt", default=str(ART / "anytime_classifier.ckpt"),
                    help="params checkpoint (default: the trainer's)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--out", default=None,
                    help="directory of stage_times.npz (default: "
                         "artifacts/torch; with --smoke nothing is written "
                         "unless it is given)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload, few profiling runs")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.clients, args.buckets = 8, 2, [1, 2]
    out = args.out or (None if args.smoke else str(ART))
    # the launcher stays on the ServeSpec front door
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=r".*ServeSpec",
                                category=DeprecationWarning)
        return _serve(args, out)


def _serve(args, out) -> dict:
    n_runs = 5 if args.smoke else 60
    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    if os.path.exists(args.ckpt):
        params, meta = checkpoint.load(args.ckpt, params, cfg=cfg)
        print(f"loaded checkpoint {args.ckpt} ({meta.get('steps')} steps)")
    else:
        print(f"no checkpoint at {args.ckpt} — using random seed-0 params "
              "(run python -m repro_torch.training.multiexit first for "
              "meaningful accuracy)")

    ds = DifficultyDataset(num_classes=cfg.vocab_size, seed=0)
    test = ds.sample(80 if args.smoke else 600, seed=999)
    labels = np.asarray(test["labels"])

    # --- profile stages (paper §IV: WCET = upper CI over profiling runs) ---
    stage_fns = make_stage_fns(cfg)
    sample = {k: v[:1] for k, v in test["inputs"].items()}
    wcet, times, host_overhead = profile_stages(cfg, params, stage_fns,
                                                sample, n_runs=n_runs)
    print("stage WCETs (s):", np.round(wcet, 6),
          " means:", np.round(times.mean(1), 6),
          f" host_overhead={host_overhead * 1e6:.1f}us")
    npz = None
    if out is not None:
        os.makedirs(out, exist_ok=True)
        npz = os.path.join(out, "stage_times.npz")
        np.savez(npz, wcet=wcet, samples=times, host_overhead=host_overhead)

    # --- profile *batched* stage WCETs for the micro-batching engines -----
    buckets = tuple(sorted(args.buckets))
    bfns = BatchedStageFns(cfg, buckets)
    time_model, bmat = profile_batched_stages(cfg, params, bfns, sample,
                                              n_runs=max(5, n_runs // 2))
    print("batched stage WCETs (s) [stage x bucket]:\n", np.round(bmat, 6))

    d_lo = args.d_lo or float(4.0 * wcet.max())
    d_hi = args.d_hi or float(14.0 * wcet.max())
    print(f"deadlines ~ U[{d_lo:.4f}, {d_hi:.4f}] s, {args.clients} clients")

    def stream():
        return closed_loop_stream(test["inputs"], labels,
                                  n_clients=args.clients, d_lo=d_lo,
                                  d_hi=d_hi, n_requests=args.requests,
                                  seed=1)

    def spec_for(policy, policy_args, executor, depth):
        if executor == "device-single":
            batching = {"mode": "none",
                        "stage_times": [float(x) for x in wcet]}
        else:
            batching = {}            # priced by the profiled time_model
        return ServeSpec(policy=policy, policy_args=policy_args,
                         executor=executor, clock="wall", source="stream",
                         batching=batching, host_overhead=host_overhead,
                         pipeline_depth=depth)

    legs = {}

    def serve(name, spec, **resources):
        svc = Service.from_spec(spec, cfg=cfg, params=params, **resources)
        res = svc.run(stream())
        rs = svc.responses
        acc = float(sum(r.prediction == labels[r.sample]
                        for r in rs if not r.missed)) / max(1, len(rs))
        leg = dict(n=len(rs), acc=acc,
                   miss=float(np.mean([r.missed for r in rs])),
                   depth=float(np.mean([r.depth for r in rs if not r.missed]
                                       or [0])),
                   latency_ms=float(np.mean([r.latency for r in rs])) * 1e3,
                   n_dispatches=res.n_dispatches,
                   cache=svc.executor.cache_stats(),
                   device_time_stats=svc.executor.device_time_stats())
        print(f"{name:20s} n={leg['n']} acc={acc:.3f} miss={leg['miss']:.3f} "
              f"mean_depth={leg['depth']:.2f} "
              f"mean_latency={leg['latency_ms']:.1f}ms "
              f"dispatches={res.n_dispatches} "
              f"sched_overhead={svc.policy.sched_time:.3f}s")
        legs[name] = leg
        return svc, leg

    for name, pargs in POLICIES:
        serve(name, spec_for(name, pargs, "device-single", 1),
              stage_fns=stage_fns)
    for name, pargs in POLICIES:
        serve(f"batched-{name}", spec_for(name, pargs, "device-batched", 1),
              stage_fns=bfns, time_model=time_model)
    # pipelined async dispatch (pipeline_depth=2): the host pre-selects the
    # next batch while the device executes the current one
    for name, pargs in POLICIES:
        serve(f"pipelined-{name}",
              spec_for(name, pargs, "device-batched", 2),
              stage_fns=bfns, time_model=time_model)
    # stage bodies ending in the exit-confidence kernel, dispatching
    # pipeline_depth-1 = 2 stacked device windows; every shape runs before
    # the count starts, so the served run launches the kernel once a
    # dispatch
    if args.kernels:
        name, pargs = POLICIES[0]
        kfns = KernelStageFns(cfg, buckets)
        kfns.warmup(params, sample)
        n0 = exit_confidence.launches
        svc, leg = serve(f"kernel-{name}",
                         spec_for(name, pargs, "device-kernel", 3),
                         stage_fns=kfns, time_model=time_model)
        leg["exit_launches"] = exit_confidence.launches - n0
        kx = svc.executor
        kt = leg["device_time_stats"]
        print(f"kernel telemetry: host={kt['host_time']:.3f}s "
              f"device={kt['device_time']:.3f}s windows={kx.max_inflight} "
              f"cache={leg['cache']} exit_launches={leg['exit_launches']}")
        if kx.max_inflight != 2 or leg["cache"]["live"] != 0:
            raise RuntimeError(f"kernel leg: {kx.max_inflight} windows, "
                               f"cache {leg['cache']} after the run")
    if args.smoke:
        print(f"SMOKE OK: {len(legs)} engine configs served "
              f"{args.requests} requests each")
    return dict(wcet=wcet, times=times, host_overhead=host_overhead,
                batched_wcet=bmat, buckets=buckets, deadlines=(d_lo, d_hi),
                stage_times=npz, legs=legs)


if __name__ == "__main__":
    main()
