"""Length-bucketed WCET pricing: ``(stage, batch-bucket, len-bucket)``.

The batch subsystem prices every dispatch through a
:class:`~repro_torch.serving.batch.batcher.BatchTimeModel` keyed by (stage,
batch-size bucket).  Real kernel dispatches have a third shape axis: the
padded *sequence length* (classifier feature frames, decode KV-cache
slots).  A serving engine cannot recompile per length either, so lengths
are padded up to a small set of pre-compiled **length buckets**, and the
WCET table gains a length dimension:

    times3[len_bucket][batch_bucket][stage] -> seconds

``LengthBucketTimeModel`` subclasses ``BatchTimeModel`` so every existing
call site keeps working: the inherited 2-D ``times`` is the *worst case
over length buckets*, which is exactly what length-blind consumers (the
§II-B deadline adjustment's worst-stage term, ``single_times`` on tasks,
admission headroom) should price.  Length-aware consumers — the
:class:`~repro_torch.serving.batch.batcher.StageBatcher`, the oracle executor,
the ``device-kernel`` executor — pass ``seq_len=`` to :meth:`wcet` and get
the bucket-exact cost.  Tasks carry their length in ``Task.seq_len``;
co-runners batch together only when their lengths share a bucket (the
batched shape is one pre-compiled ``(batch_bucket, len_bucket)`` pair).

No torch import — the discrete-event simulator prices ragged workloads
through this model too.
"""
from __future__ import annotations

import bisect
import dataclasses

from repro_torch.serving.batch.batcher import BatchTimeModel, bucket_for

DEFAULT_LEN_BUCKETS = (16, 64, 256)


def len_bucket_for(seq_len: int, len_buckets) -> int:
    """Smallest length bucket holding ``seq_len`` (lengths are padded up).

    The length analog of :func:`repro_torch.serving.batch.batcher.bucket_for` —
    the single source of the length-rounding rule."""
    i = bisect.bisect_left(len_buckets, seq_len)
    if seq_len < 1 or i == len(len_buckets):
        raise ValueError(f"seq_len {seq_len} exceeds length buckets "
                         f"{tuple(len_buckets)}")
    return len_buckets[i]


@dataclasses.dataclass(frozen=True)
class LengthBucketTimeModel(BatchTimeModel):
    """``BatchTimeModel`` with a length-bucket axis.

    ``times3[li][bi][s]`` = worst-case seconds of stage ``s`` run at batch
    bucket ``buckets[bi]`` with rows padded to ``len_buckets[li]``.  The
    inherited 2-D ``times`` must equal the per-(bucket, stage) max over
    length buckets — length-blind pricing stays conservative.
    """
    len_buckets: tuple = ()        # ascending length buckets, e.g. (16, 64)
    times3: tuple = ()             # times3[len_idx][bucket_idx][stage]

    def __post_init__(self):
        super().__post_init__()
        if tuple(sorted(self.len_buckets)) != tuple(self.len_buckets) \
                or not self.len_buckets:
            raise ValueError(f"len_buckets must be non-empty ascending: "
                             f"{self.len_buckets}")
        if len(self.times3) != len(self.len_buckets):
            raise ValueError("one WCET matrix per length bucket required")
        for li, mat in enumerate(self.times3):
            if len(mat) != len(self.buckets):
                raise ValueError(f"times3[{li}]: one row per batch bucket "
                                 f"required")
        for bi in range(len(self.buckets)):
            for s in range(self.num_stages):
                worst = max(m[bi][s] for m in self.times3)
                if abs(worst - self.times[bi][s]) > 1e-12:
                    raise ValueError(
                        "base times must be the max over length buckets "
                        f"(bucket {self.buckets[bi]}, stage {s}: "
                        f"{self.times[bi][s]} != {worst})")

    # -- length axis ----------------------------------------------------
    def len_bucket_for(self, seq_len: int) -> int:
        return len_bucket_for(seq_len, self.len_buckets)

    def wcet(self, stage: int, n: int = 1, seq_len: int = None) -> float:
        """WCET of stage ``stage`` as a batch of ``n``; with ``seq_len``,
        priced at that length's bucket, else worst-case over lengths."""
        if seq_len is None:
            return super().wcet(stage, n)
        bi = bisect.bisect_left(self.buckets, self.bucket_for(n))
        li = bisect.bisect_left(self.len_buckets,
                                self.len_bucket_for(seq_len))
        return float(self.times3[li][bi][stage])

    @classmethod
    def linear(cls, stage_times, buckets=None, marginal: float = 0.15,
               len_buckets=DEFAULT_LEN_BUCKETS,
               len_marginal: float = None) -> "LengthBucketTimeModel":
        """Analytic model: batch scaling as in ``BatchTimeModel.linear``,
        and stage time proportional to the length bucket relative to the
        largest (``len_marginal`` < 1 flattens the length dependence:
        cost = base * (len_marginal + (1 - len_marginal) * lb/max_lb))."""
        from repro_torch.serving.batch.batcher import DEFAULT_BUCKETS
        buckets = tuple(sorted(int(b) for b in buckets or DEFAULT_BUCKETS))
        len_buckets = tuple(sorted(int(b) for b in len_buckets))
        lm = 0.25 if len_marginal is None else float(len_marginal)
        base = BatchTimeModel.linear(stage_times, buckets, marginal)
        mats = []
        for lb in len_buckets:
            frac = lm + (1.0 - lm) * lb / len_buckets[-1]
            mats.append(tuple(tuple(t * frac for t in row)
                              for row in base.times))
        worst = tuple(
            tuple(max(m[bi][s] for m in mats)
                  for s in range(len(stage_times)))
            for bi in range(len(buckets)))
        return cls(buckets=buckets, times=worst, len_buckets=len_buckets,
                   times3=tuple(mats))

    @classmethod
    def from_profile3(cls, tensor, buckets, len_buckets) \
            -> "LengthBucketTimeModel":
        """From a profiled (num_len_buckets, num_stages, num_buckets)
        WCET tensor (the 3-D analog of ``BatchTimeModel.from_profile``)."""
        buckets = tuple(sorted(int(b) for b in buckets))
        len_buckets = tuple(sorted(int(b) for b in len_buckets))
        mats = []
        for mat in tensor:
            L = len(mat)
            rows = tuple(tuple(float(mat[s][bi]) for s in range(L))
                         for bi in range(len(buckets)))
            mats.append(rows)
        worst = tuple(
            tuple(max(m[bi][s] for m in mats)
                  for s in range(len(mats[0][0])))
            for bi in range(len(buckets)))
        return cls(buckets=buckets, times=worst, len_buckets=len_buckets,
                   times3=tuple(mats))


def batch_wcet(time_model, stage: int, tasks) -> float:
    """Price one batched dispatch of ``tasks`` at ``stage``: length-aware
    when the model carries a length axis and every member declares a
    ``seq_len``, conservative (worst length bucket) otherwise.

    Model-aware when the time model dispatches per model (a ``for_model``
    method, e.g. :class:`~repro_torch.serving.zoo.ZooTimeModel`) and the batch
    carries a ``model`` id: the batch is priced by that model's own WCET
    table (the :class:`~repro_torch.serving.batch.batcher.StageBatcher` only
    seats same-model co-runners, so the first member's model is the
    batch's)."""
    model = getattr(tasks[0], "model", None) if tasks else None
    if model is not None:
        fm = getattr(time_model, "for_model", None)
        if fm is not None:
            time_model = fm(model)
    if isinstance(time_model, LengthBucketTimeModel):
        sls = [t.seq_len for t in tasks
               if getattr(t, "seq_len", None) is not None]
        if len(sls) == len(tasks) and sls:
            return time_model.wcet(stage, len(tasks), seq_len=max(sls))
    return time_model.wcet(stage, len(tasks))


def task_len_bucket(time_model, task):
    """The task's length bucket under ``time_model`` (None when either
    side carries no length information).  Resolves per-model tables the
    same way :func:`batch_wcet` does."""
    model = getattr(task, "model", None)
    if model is not None:
        fm = getattr(time_model, "for_model", None)
        if fm is not None:
            time_model = fm(model)
    if isinstance(time_model, LengthBucketTimeModel):
        sl = getattr(task, "seq_len", None)
        if sl is not None:
            return time_model.len_bucket_for(sl)
    return None


__all__ = ["DEFAULT_LEN_BUCKETS", "LengthBucketTimeModel", "batch_wcet",
           "bucket_for", "len_bucket_for", "task_len_bucket"]
