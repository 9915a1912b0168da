"""Batch formation: shape-bucketed, deadline-feasible stage micro-batches.

Two pieces, both accelerator-agnostic (no torch import — the discrete-event
simulator uses them too):

* ``BatchTimeModel`` — profiled WCET of one *batched* stage execution per
  (stage, batch-size bucket).  Buckets are the small set of batch sizes the
  engine pre-compiles (default {1, 2, 4, 8, 16}); any batch is padded up to
  the next bucket, so the batch WCET is the bucket's WCET.
* ``StageBatcher`` — greedy deadline-feasible batch formation around a
  leader task.  Invariant (the paper's §II-B deadline semantics lifted to
  batches): admitting a task into a batch must not push any member past its
  deadline, where the batch's cost is the bucket-rounded WCET of the grown
  batch.

The non-preemptible region of §II-B therefore becomes one *batched* stage:
once a batch is dispatched, every member is committed for the full batch
WCET.  That is exactly why admission checks the grown batch's WCET against
*all* members — a bigger batch is cheaper per item but longer wall-clock.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket holding a batch of `n` (batches are padded up).

    The single source of the bucket-rounding rule: BatchTimeModel pricing
    and BatchedStageFns padding both resolve through it."""
    i = bisect.bisect_left(buckets, n)
    if n < 1 or i == len(buckets):
        raise ValueError(f"batch of {n} exceeds buckets {tuple(buckets)}")
    return buckets[i]


@dataclasses.dataclass(frozen=True)
class BatchTimeModel:
    """WCET table for batched stage executions.

    ``times[bi][s]`` = worst-case seconds of stage ``s`` run at batch-size
    bucket ``buckets[bi]``.
    """
    buckets: tuple                 # ascending batch-size buckets, e.g. (1,2,4)
    times: tuple                   # times[bucket_index][stage] -> seconds

    def __post_init__(self):
        if tuple(sorted(self.buckets)) != tuple(self.buckets):
            raise ValueError(f"buckets must ascend: {self.buckets}")
        if len(self.times) != len(self.buckets):
            raise ValueError("one WCET row per bucket required")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def num_stages(self) -> int:
        return len(self.times[0])

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def wcet(self, stage: int, n: int = 1) -> float:
        """WCET of stage `stage` executed as a batch of `n` (bucket-padded)."""
        bi = bisect.bisect_left(self.buckets, self.bucket_for(n))
        return float(self.times[bi][stage])

    def per_item(self, stage: int, n: int = 1) -> float:
        """Amortized per-request cost of a batch of `n` — the throughput
        lever: with sub-linear batch scaling this falls as `n` grows."""
        return self.wcet(stage, n) / max(1, n)

    def single_times(self) -> tuple:
        """Per-stage WCETs at batch size 1 (what Task.stage_times carries)."""
        return tuple(float(self.times[0][s]) for s in range(self.num_stages))

    @classmethod
    def linear(cls, stage_times, buckets=DEFAULT_BUCKETS,
               marginal: float = 0.15) -> "BatchTimeModel":
        """Analytic model for the simulator: each extra item in a batch adds
        `marginal` of the single-item stage time (GPU batching amortizes
        weight loads, so marginal << 1)."""
        buckets = tuple(sorted(int(b) for b in buckets))
        rows = tuple(
            tuple(float(t) * (1.0 + marginal * (b - 1)) for t in stage_times)
            for b in buckets)
        return cls(buckets=buckets, times=rows)

    @classmethod
    def from_profile(cls, matrix, buckets) -> "BatchTimeModel":
        """From a profiled (num_stages, num_buckets) WCET matrix (see
        repro_torch.serving.batch.stage_fns.profile_batched_stages)."""
        m = np.asarray(matrix, dtype=float)
        buckets = tuple(sorted(int(b) for b in buckets))
        if m.shape != (m.shape[0], len(buckets)):
            raise ValueError(f"expected (L, {len(buckets)}) matrix, "
                             f"got {m.shape}")
        rows = tuple(tuple(float(x) for x in m[:, bi])
                     for bi in range(len(buckets)))
        return cls(buckets=buckets, times=rows)


class StageBatcher:
    """Greedy deadline-feasible micro-batch formation at one stage.

    Given the leader the base policy picked, fill the rest of the bucket
    with co-runners currently at the *same* stage, in `rank` order,
    admitting a candidate only if the grown batch's (bucket-rounded) WCET
    still meets every member's deadline — including the candidate's own.

    If even the leader alone is infeasible the singleton batch is returned
    unchanged; dispatch semantics then match the unbatched engine (the
    stage runs, the deadline check afterwards decides whether it counted).

    When the time model carries a length axis
    (:class:`repro_torch.serving.batch.time_model.LengthBucketTimeModel`) and
    tasks declare ``seq_len``, candidates are additionally filtered to the
    leader's *length bucket* — a batched dispatch is one pre-compiled
    (batch-bucket, len-bucket) shape, so only same-bucket co-runners can
    share it — and WCETs are priced at that bucket instead of the
    worst-case length.

    Multi-model serving (``repro_torch.serving.zoo``): tasks carrying a
    ``model`` id only co-batch with *same-model* co-runners (a batched
    dispatch runs exactly one model's stage fn), and when the time model
    dispatches per model (a ``for_model`` method, e.g.
    :class:`~repro_torch.serving.zoo.ZooTimeModel`) the batch is priced by the
    *leader's* model's WCET table.  Tasks without a model (the whole
    single-model stack) are unaffected.

    ``dp`` > 1 (row-sharded executors) prefers dp-multiple batch sizes:
    when the greedy fill lands strictly below its bucket boundary at a
    non-dp-multiple size, the lowest-ranked co-runners are deferred down
    to the nearest dp multiple *iff* that lowers the priced bucket — a
    padded row should never cross a replica when deferring it buys a
    smaller (faster) bucket.  ``dp=1`` is the identity.
    """

    def __init__(self, time_model: BatchTimeModel, max_batch: int = None,
                 dp: int = 1):
        self.time_model = time_model
        self.max_batch = min(max_batch or time_model.max_batch,
                             time_model.max_batch)
        self.dp = max(1, int(dp))

    def _model_tm(self, model):
        """The WCET table pricing ``model``'s dispatches (the shared table
        unless the time model dispatches per model)."""
        if model is None:
            return self.time_model
        fm = getattr(self.time_model, "for_model", None)
        return self.time_model if fm is None else fm(model)

    def _wcet(self, stage: int, n: int, seq_len, tm=None) -> float:
        tm = self.time_model if tm is None else tm
        if seq_len is not None:
            return tm.wcet(stage, n, seq_len=seq_len)
        return tm.wcet(stage, n)

    def _len_bucket(self, task):
        tm = self._model_tm(getattr(task, "model", None))
        lb_for = getattr(tm, "len_bucket_for", None)
        sl = getattr(task, "seq_len", None)
        if lb_for is None or sl is None:
            return None
        return lb_for(sl)

    def _prefer_dp_multiple(self, batch, tm) -> None:
        """Defer the tail of the fill order down to a dp multiple when that
        lowers the priced bucket (see class docstring).  Never touches the
        leader; deferred tasks stay queued for the next window."""
        n = len(batch)
        if self.dp <= 1 or n <= 1 or n % self.dp == 0:
            return
        bucket = tm.bucket_for(n)
        if n == bucket:
            return                     # exact bucket hit: no padding at all
        m = (n // self.dp) * self.dp
        if m >= 1 and tm.bucket_for(m) < bucket:
            del batch[m:]

    def form(self, leader, candidates, now: float, rank=None) -> list:
        stage = leader.executed
        batch = [leader]
        # singleton fast path (the unbatched engines run max_batch=1 through
        # the same code): no candidate ranking work on the dispatch hot path
        if self.max_batch <= 1:
            return batch
        lmodel = getattr(leader, "model", None)
        tm = self._model_tm(lmodel)
        lb = self._len_bucket(leader)
        seq = None if lb is None else lb
        if not leader.fits_batch(now, self._wcet(stage, 1, seq, tm)):
            return batch
        cands = [c for c in candidates
                 if c is not leader and c.executed == stage
                 and getattr(c, "model", None) == lmodel
                 and (lb is None or self._len_bucket(c) == lb)]
        cands.sort(key=rank if rank is not None
                   else (lambda t: (t.deadline, t.tid)))
        for c in cands:
            if len(batch) >= self.max_batch:
                break
            w = self._wcet(stage, len(batch) + 1, seq, tm)
            if c.fits_batch(now, w) and all(m.fits_batch(now, w)
                                            for m in batch):
                batch.append(c)
        self._prefer_dp_multiple(batch, tm)
        return batch
