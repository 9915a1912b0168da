"""Admission control: reject or depth-cap requests an overloaded queue
cannot serve.

The paper's scheduler maximizes accuracy *given* the active set; under
sustained overload that still means every request limps through at
mandatory depth and many expire with zero stages done.  The controller
makes the overload decision explicit at arrival time:

* **mandatory-infeasible** — even the mandatory part, run solo at
  single-batch speed, cannot meet the deadline: never admitted.
* **overload** — the optimistic backlog (everyone's remaining mandatory
  work, amortized at the largest bucket's per-item rate — the best the
  batched engine could possibly do) already spends this request's slack:
  ``mode="reject"`` drops it (the client can fail fast / retry elsewhere),
  ``mode="depth_cap"`` admits it pinned to its mandatory depth.
* otherwise the request is admitted; in ``depth_cap`` mode its depth is
  capped at what is solo-feasible (``Task.feasible_depth`` under
  single-batch WCETs), which keeps the FPTAS from planning depths that
  only exist on paper.

Caps are applied through ``Task.depth_cap``, which every Policy's depth
assignment clamps against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.batch.batcher import BatchTimeModel

MODES = ("off", "reject", "depth_cap")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    depth_cap: Optional[int]       # None = uncapped
    reason: str
    # the numbers behind the rule that fired (slack, backlog, WCETs...);
    # surfaced by the obs audit log so "why was this rejected?" has a
    # quantitative answer.  None for plain admits.
    detail: Optional[dict] = None


class AdmissionController:
    def __init__(self, time_model: BatchTimeModel, mode: str = "depth_cap",
                 headroom: float = 1.0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.time_model = time_model
        self.mode = mode
        self.headroom = headroom   # >1.0 = admit less (safety margin)
        self.rejected = 0
        self.capped = 0

    # ------------------------------------------------------------------
    def _tm_for(self, task):
        """WCET table pricing ``task`` — the hook per-model controllers
        (:class:`repro_torch.serving.zoo.ZooAdmissionController`) override."""
        return self.time_model

    def _amortized(self, stage: int, tm=None) -> float:
        tm = self.time_model if tm is None else tm
        return tm.per_item(stage, tm.max_batch)

    def decide(self, active, task, now: float) -> AdmissionDecision:
        if self.mode == "off":
            return AdmissionDecision(True, None, "off")
        tm = self._tm_for(task)
        slack = task.deadline - now
        mand_solo = sum(tm.wcet(s, 1) for s in range(task.mandatory))
        if not task.fits_batch(now, mand_solo):
            return AdmissionDecision(
                False, None, "mandatory-infeasible",
                detail={"slack": slack, "mand_solo_wcet": mand_solo,
                        "mandatory": task.mandatory})
        # optimistic backlog: mandatory work still owed by the active set,
        # at the best per-item rate batching can buy
        backlog = sum(
            sum(self._amortized(s, self._tm_for(t))
                for s in range(t.executed, max(t.mandatory, t.executed)))
            for t in active)
        own = sum(self._amortized(s, tm) for s in range(task.mandatory))
        if now + (backlog + own) * self.headroom > task.deadline:
            detail = {"slack": slack, "backlog": backlog,
                      "own_amortized": own, "headroom": self.headroom,
                      "n_active": len(active)}
            if self.mode == "reject":
                return AdmissionDecision(False, None, "overload",
                                         detail=detail)
            return AdmissionDecision(True, task.mandatory, "overload-capped",
                                     detail=detail)
        if self.mode == "depth_cap":
            d = task.feasible_depth(now,
                                    stage_time=lambda s: tm.wcet(s, 1))
            if d < task.num_stages:
                return AdmissionDecision(
                    True, max(task.mandatory, d), "deadline-capped",
                    detail={"slack": slack, "feasible_depth": d,
                            "num_stages": task.num_stages,
                            "mand_solo_wcet": mand_solo})
        return AdmissionDecision(True, None, "ok")

    def apply(self, active, task, now: float) -> AdmissionDecision:
        """Decide and mutate ``task.depth_cap``; caller drops on reject.

        A pre-existing cap (SLO class, backpressure shedding) is only
        ever tightened — admission control must not re-open depth some
        earlier layer already took away."""
        dec = self.decide(active, task, now)
        if not dec.admitted:
            self.rejected += 1
            task.dropped = True
        elif dec.depth_cap is not None:
            self.capped += 1
            cap = max(task.mandatory, dec.depth_cap)
            task.depth_cap = cap if task.depth_cap is None \
                else min(task.depth_cap, cap)
        return dec
