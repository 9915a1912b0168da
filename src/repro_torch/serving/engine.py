"""RTDeepIoT serving engine (paper Fig. 2) — user-space, wall-clock
(``repro.serving.engine``).

The engine owns:
  * per-stage functions (:func:`repro_torch.models.stage_forward`, eager)
    — the non-preemptive dispatch units (:func:`make_stage_fns`);
  * profiled per-stage WCETs (99th percentile, paper §IV protocol;
    :func:`profile_stages`);
  * a scheduling Policy (RTDeepIoT or a baseline).

Requests (input dict + relative deadline) enter a ``Service``; the engine
dispatches one stage at a time on the device, returns each stage's
(prediction, confidence) to the policy between stages — the user-space
decision point the paper argues for — and responds with the deepest
in-time exit.

Deadline adjustment (§II-B): the caller-visible deadline is reduced by the
profiled host/dispatch overhead (:func:`profile_host_overhead`) and the
non-preemptible region before it reaches the scheduler.

``ServingEngine.run`` is a deprecated wrapper over the public serving
facade (:mod:`repro_torch.serving.service`): a ``ServeSpec`` on the
``device-single`` executor / wall clock / stream source, dispatching
singleton batches (``batching={"mode": "none"}``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.model import (params_device, resolve_device,
                                     stage_forward, synchronize)


@dataclasses.dataclass
class Request:
    inputs: Any                    # single-sample input dict (leading dim 1)
    rel_deadline: Optional[float] = None   # None: the SLO class supplies it
    sample: int = 0
    client: int = 0
    arrival: float = 0.0           # wall time, filled by the engine
    slo: Optional[str] = None      # SLO class name (repro_torch.serving.service)
    tenant: Optional[str] = None   # tenant label
    request_id: Optional[str] = None  # idempotence key
    seq_len: Optional[int] = None  # ragged input length (length-bucket WCETs)
    model: Optional[str] = None    # model id


@dataclasses.dataclass
class Response:
    sample: int
    prediction: Optional[int]
    confidence: float
    depth: int
    missed: bool
    latency: float
    deadline: float


def make_stage_fns(cfg):
    """Per-stage functions: stage 0 embeds raw inputs, later stages consume
    hidden states.  Returns a list of ``fn(params, x) -> (h, logits,
    conf)``, each running eagerly on the params' device; a stage-0 input
    dict of host arrays is copied there first."""
    def make(s):
        def fn(params, h):
            if isinstance(h, dict):
                device = params_device(params)
                h = {k: torch.as_tensor(v, device=device)
                     for k, v in h.items()}
            return stage_forward(cfg, params, s, h)
        return fn
    return [make(s) for s in range(cfg.num_stages)]


def profile_stages(cfg, params, stage_fns, sample_inputs, *,
                   n_runs: int = 100, percentile: float = 99.0, sync=True):
    """Per-stage WCET = ``percentile`` of ``n_runs`` timed executions
    (paper: 99% CI upper bound over profiling runs on training data).

    Each sample is a host clock around one stage that ends in a device
    synchronize.  Also measures the host dispatch overhead on the params'
    device (:func:`profile_host_overhead`) used for the §II-B deadline
    adjustment.  Returns ``(wcet, times, host_overhead)``; pass the
    overhead straight into ``ServingEngine(host_overhead=...)``.  ``sync``
    is accepted and ignored, as in the JAX package."""
    device = params_device(params)
    times = np.zeros((cfg.num_stages, n_runs))
    h = sample_inputs
    for s, fn in enumerate(stage_fns):
        out = fn(params, h)                        # first run of the stage
        synchronize(device)
        for i in range(n_runs):
            t0 = time.perf_counter()
            out = fn(params, h)
            synchronize(device)
            times[s, i] = time.perf_counter() - t0
        h = out[0]
    wcet = np.percentile(times, percentile, axis=1)
    host_overhead = profile_host_overhead(device=device, n_runs=n_runs,
                                          percentile=percentile)
    return wcet, times, host_overhead


def profile_host_overhead(*, device="cuda", n_runs: int = 100,
                          percentile: float = 99.0) -> float:
    """Host dispatch overhead: round trip of a trivial op on ``device``
    (the card by default), launched and waited for (§II-B).

    This is the per-dispatch CPU cost the engine pays before the device
    starts a stage, so the caller-visible deadline is shrunk by it."""
    device = resolve_device(device)
    z = torch.zeros((), device=device)

    def round_trip():
        y = z + 1.0
        synchronize(device)
        return y

    round_trip()                                   # first launch
    samples = np.zeros(n_runs)
    for i in range(n_runs):
        t0 = time.perf_counter()
        round_trip()
        samples[i] = time.perf_counter() - t0
    return float(np.percentile(samples, percentile))


class ServingEngine:
    def __init__(self, cfg, params, policy, *, stage_wcet,
                 host_overhead: float = 0.0, stage_fns=None):
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.stage_fns = stage_fns or make_stage_fns(cfg)
        self.stage_wcet = tuple(float(x) for x in stage_wcet)
        self.host_overhead = host_overhead
        self.responses: list = []

    def run(self, request_stream):
        """request_stream: iterable of (offset_seconds, Request), offsets
        non-decreasing relative to engine start."""
        from repro_torch.serving.deprecation import deprecate_once
        from repro_torch.serving.service import ServeSpec, Service

        deprecate_once(
            "repro_torch.serving.ServingEngine.run",
            "ServingEngine is deprecated: build a ServeSpec(executor="
            "'device-single', clock='wall', source='stream') and run it "
            "through repro_torch.serving.Service instead")
        spec = ServeSpec(
            executor="device-single", clock="wall", source="stream",
            batching={"mode": "none",
                      "stage_times": [float(x) for x in self.stage_wcet]},
            host_overhead=self.host_overhead)
        svc = Service.from_spec(spec, policy=self.policy, cfg=self.cfg,
                                params=self.params,
                                stage_fns=self.stage_fns)
        svc.run(request_stream)
        self.responses.extend(svc.responses)
        return self.responses


def closed_loop_stream(dataset_inputs, labels, *, n_clients, d_lo, d_hi,
                       n_requests, seed=0, spacing=None):
    """Open-loop approximation of the paper's K-client workload for the
    wall-clock engine: K interleaved request lanes with deadline-spaced
    issue times.  ``dataset_inputs``: a dict of arrays (sample axis
    first); each request carries a one-sample slice of every entry."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    order = rng.permutation(n)
    reqs = []
    t_client = np.zeros(n_clients)
    for j in range(n_requests):
        c = int(np.argmin(t_client))
        rel = float(rng.uniform(d_lo, d_hi))
        sample = int(order[j % n])
        inputs = {k: v[sample:sample + 1] for k, v in dataset_inputs.items()}
        reqs.append((float(t_client[c]), Request(inputs, rel, sample, c)))
        t_client[c] += rel if spacing is None else spacing
    reqs.sort(key=lambda p: p[0])
    return reqs
