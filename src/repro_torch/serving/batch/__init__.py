"""Continuous stage-level micro-batching (``repro.serving.batch``).

  batcher     BatchTimeModel (per-bucket stage WCETs) + StageBatcher
              (greedy deadline-feasible batch formation)         [numpy]
  time_model  LengthBucketTimeModel (stage x batch x length)     [numpy]
  policy      BatchPolicy contract + BatchedPolicy adapter        [numpy]
  admission   AdmissionController (reject / depth-cap)            [numpy]
  stage_fns   padded, shape-bucketed stage functions              [torch]
  engine      BatchedServingEngine (wall clock, deprecated face)
  simulator   simulate_batched (discrete event, deprecated face) — same
              policies, same batch semantics as the wall-clock path
"""
from repro_torch.serving.batch.admission import (AdmissionController,
                                                 AdmissionDecision)
from repro_torch.serving.batch.batcher import (DEFAULT_BUCKETS,
                                               BatchTimeModel, StageBatcher,
                                               bucket_for)
from repro_torch.serving.batch.engine import BatchedServingEngine
from repro_torch.serving.batch.policy import (BatchedPolicy, BatchPolicy,
                                              as_batch_policy)
from repro_torch.serving.batch.simulator import simulate_batched
from repro_torch.serving.batch.stage_fns import (BatchedStageFns,
                                                 StagingBuffers, pad_batch,
                                                 profile_batched_stages,
                                                 split_rows)
from repro_torch.serving.batch.time_model import (DEFAULT_LEN_BUCKETS,
                                                  LengthBucketTimeModel,
                                                  batch_wcet, len_bucket_for,
                                                  task_len_bucket)

__all__ = [
    "AdmissionController", "AdmissionDecision", "BatchTimeModel",
    "BatchedPolicy", "BatchPolicy", "BatchedServingEngine",
    "BatchedStageFns", "DEFAULT_BUCKETS", "DEFAULT_LEN_BUCKETS",
    "LengthBucketTimeModel", "StageBatcher", "StagingBuffers",
    "as_batch_policy", "batch_wcet", "bucket_for", "len_bucket_for",
    "pad_batch", "profile_batched_stages", "simulate_batched",
    "split_rows", "task_len_bucket",
]
