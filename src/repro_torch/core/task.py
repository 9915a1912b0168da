"""Task model: deep-learning requests as imprecise computations (paper §II-B).

A task J_i is a DNN inference request with L_i stages, per-stage worst-case
execution times p_il (from profiling), an absolute deadline d_i (already
adjusted for CPU overhead + one stage of non-preemption, §II-B), a mandatory
part of ω_i stages, and a data-dependent utility R_i^l — the confidence of
stage l's exit head.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_ids = itertools.count()


@dataclasses.dataclass
class Task:
    arrival: float
    deadline: float                  # absolute, post-adjustment (§II-B)
    stage_times: tuple               # p_il, l = 1..L
    mandatory: int = 1               # ω_i
    weight: float = 1.0              # importance (paper §II-A: weighted accuracy)
    sample: int = 0                  # dataset index (payload reference)
    client: int = 0
    tid: int = dataclasses.field(default_factory=lambda: next(_ids))
    seq_len: Optional[int] = None    # ragged input length (length-bucket WCETs)
    model: Optional[str] = None      # model-zoo id (None: single-model serving)

    # runtime state ---------------------------------------------------------
    executed: int = 0                # stages completed so far
    confidences: list = dataclasses.field(default_factory=list)
    assigned_depth: int = 0          # current depth target l_i
    depth_cap: Optional[int] = None  # admission-control ceiling on l_i
    finished_at: Optional[float] = None
    dropped: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.stage_times)

    def cum_time(self, depth: int) -> float:
        """P_i^depth = sum of the first `depth` stage times."""
        return float(sum(self.stage_times[:depth]))

    def remaining_time(self, depth: int) -> float:
        """Execution time still needed to reach `depth`."""
        return float(sum(self.stage_times[self.executed:depth]))

    @property
    def last_confidence(self) -> Optional[float]:
        return self.confidences[-1] if self.confidences else None

    @property
    def completed_any(self) -> bool:
        return self.executed > 0

    def slack(self, now: float) -> float:
        return self.deadline - now

    # batch-aware timing helpers (repro_torch.serving.batch) ----------------------
    def fits_batch(self, now: float, batch_wcet: float,
                   eps: float = 1e-12) -> bool:
        """Can this task ride a (non-preemptive) batched stage of WCET
        `batch_wcet` dispatched at `now` without missing its deadline?"""
        return now + batch_wcet <= self.deadline + eps

    def batch_slack(self, now: float, batch_wcet: float) -> float:
        """Slack left after one batched stage of WCET `batch_wcet`."""
        return self.deadline - now - batch_wcet

    def clamp_depth(self, depth: int) -> int:
        """Apply the admission-control depth cap (no-op when uncapped)."""
        cap = self.num_stages if self.depth_cap is None else self.depth_cap
        return min(depth, cap)

    def feasible_depth(self, now: float, stage_time=None) -> int:
        """Deepest depth reachable by the deadline when the remaining stages
        run back-to-back from `now`.  `stage_time` maps stage index ->
        duration (defaults to this task's own profiled stage_times)."""
        f = (lambda s: self.stage_times[s]) if stage_time is None \
            else stage_time
        t, depth = now, self.executed
        for s in range(self.executed, self.num_stages):
            t += f(s)
            if t > self.deadline + 1e-12:
                break
            depth = s + 1
        return depth
