"""BatchedServingEngine — wall-clock continuous stage-level micro-batching
(``repro.serving.batch.engine``).

The unbatched ``ServingEngine`` dispatches one request's stage at a time;
on a real accelerator that strands almost all throughput.  This engine
keeps the paper's user-space decision loop (admit → schedule → run one
non-preemptive unit → observe confidences → respond) but the dispatch
unit is a *padded, shape-bucketed batch* of same-stage tasks:

* a ``BatchPolicy`` picks ``(stage, [tasks])`` each cycle — plain policies
  are wrapped so RTDeepIoT/EDF/LCF/RR decide batch composition with their
  own preference order, under the invariant that no admission pushes a
  member past its deadline (batch WCET = profiled per-bucket stage time);
* §II-B deadline adjustment: the non-preemptible region is one
  **batched** stage, so the caller-visible deadline shrinks by the host
  overhead plus the largest batched stage WCET;
* an optional ``AdmissionController`` rejects/depth-caps at arrival.

Every bucketed shape runs once in warm-up, before the clock starts.

``run`` is a deprecated wrapper over the public serving facade
(:mod:`repro_torch.serving.service`): a ``ServeSpec`` on the
``device-batched`` executor / wall clock / stream source.  Because the
device executor launches asynchronously, ``pipelined()`` returns an engine
whose core pre-selects the next batch while the current one runs
(``ServeSpec(pipeline_depth=2)``), without changing this class's legacy
constructor or ``run`` signature.
"""
from __future__ import annotations

from repro_torch.serving.batch.admission import AdmissionController
from repro_torch.serving.batch.batcher import BatchTimeModel
from repro_torch.serving.batch.policy import BatchPolicy, as_batch_policy
from repro_torch.serving.batch.stage_fns import BatchedStageFns


class BatchedServingEngine:
    def __init__(self, cfg, params, policy, *, time_model: BatchTimeModel,
                 host_overhead: float = 0.0, stage_fns: BatchedStageFns = None,
                 admission: AdmissionController = None,
                 max_batch: int = None):
        self.cfg = cfg
        self.params = params
        self.time_model = time_model
        self.stage_fns = stage_fns or BatchedStageFns(cfg, time_model.buckets)
        self.policy: BatchPolicy = as_batch_policy(policy, time_model,
                                                   max_batch=max_batch)
        # largest batch this engine can actually dispatch — a custom
        # BatchPolicy without a batcher is bounded only by the bucket set
        batcher = getattr(self.policy, "batcher", None)
        self._effective_max_batch = batcher.max_batch if batcher is not None \
            else time_model.max_batch
        self.admission = admission
        self.host_overhead = host_overhead
        self.responses: list = []
        self._pipeline_depth = 1

    def pipelined(self, depth: int = 2) -> "BatchedServingEngine":
        """Enable pipelined async dispatch (host pre-selects batch N+1 while
        batch N runs on the device).  Returns self for chaining."""
        self._pipeline_depth = depth
        return self

    def run(self, request_stream):
        """request_stream: iterable of (offset_seconds, Request), offsets
        non-decreasing relative to engine start."""
        from repro_torch.serving.deprecation import deprecate_once
        from repro_torch.serving.service import ServeSpec, Service

        deprecate_once(
            "repro_torch.serving.batch.BatchedServingEngine.run",
            "BatchedServingEngine is deprecated: build a ServeSpec("
            "executor='device-batched', clock='wall', source='stream') "
            "and run it through repro_torch.serving.Service instead")
        spec = ServeSpec(
            executor="device-batched", clock="wall", source="stream",
            batching={"max_batch": self._effective_max_batch},
            host_overhead=self.host_overhead,
            pipeline_depth=self._pipeline_depth)
        svc = Service.from_spec(spec, policy=self.policy, cfg=self.cfg,
                                params=self.params, stage_fns=self.stage_fns,
                                time_model=self.time_model,
                                admission=self.admission)
        svc.run(request_stream)
        self.responses.extend(svc.responses)
        return self.responses
