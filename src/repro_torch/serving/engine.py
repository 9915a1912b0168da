"""Request/response records and stream helpers (``repro.serving.engine``).

Requests (input dict + relative deadline) enter a ``Service``; the engine
dispatches one stage at a time on the device, returns each stage's
(prediction, confidence) to the policy between stages — the user-space
decision point the paper argues for — and responds with the deepest
in-time exit.

Deadline adjustment (§II-B): the caller-visible deadline is reduced by the
profiled host/dispatch overhead (:func:`profile_host_overhead`) and the
non-preemptible region before it reaches the scheduler.

The legacy ``ServingEngine``, ``make_stage_fns`` and ``profile_stages`` of
the JAX package wait for the ``device-single`` executor (ROADMAP Queue A
item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.model import resolve_device, synchronize


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
