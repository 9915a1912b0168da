"""Scheduling policies — RTDeepIoT (the paper) and the evaluated baselines.

All policies share one interface so the simulator / serving engine treats
them uniformly:

  on_arrival(active, task, now)     a request arrived
  on_stage_done(active, task, now)  a stage of `task` finished (its measured
                                    confidence is already appended)
  next_task(active, now) -> Task    whose next stage to dispatch (None: idle)

`active` excludes finished/expired tasks.  Stages are non-preemptive: once
dispatched, the simulator/executor runs the stage to completion (§II-B).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.dp import DepthPlanner
from repro_torch.core.greedy import greedy_update


class Policy:
    name = "base"

    def __init__(self):
        self.sched_time = 0.0       # accumulated wall-clock scheduling cost
        self.invocations = 0

    def on_arrival(self, active, task, now):
        task.assigned_depth = task.clamp_depth(task.num_stages)

    def on_stage_done(self, active, task, now):
        pass

    def next_task(self, active, now) -> Optional[object]:
        raise NotImplementedError

    def batch_rank(self, task, now):
        """Preference key for batch composition (repro_torch.serving.batch):
        co-runners at the leader's stage are admitted in this order.
        Default = EDF order; utility-aware policies override."""
        return (task.deadline, task.tid)

    def _runnable(self, active, now):
        return [t for t in active
                if t.executed < t.assigned_depth and t.deadline > now]


class RTDeepIoT(Policy):
    """The paper's scheduler: FPTAS depth assignment (Algorithm 1) on
    arrival, greedy reassignment (Eq. 7) on stage completion, EDF dispatch."""

    def __init__(self, predictor, delta: float = 0.1):
        super().__init__()
        self.predictor = predictor
        self.planner = DepthPlanner(delta=delta)
        self.name = f"rtdeepiot-{predictor.name}"

    def _replan(self, active, now):
        t0 = time.perf_counter()
        assignment = self.planner.plan(active, now, self.predictor)
        for t in active:
            t.assigned_depth = max(t.clamp_depth(assignment.get(t.tid,
                                                                t.executed)),
                                   t.executed)
        self.sched_time += time.perf_counter() - t0
        self.invocations += 1

    def on_arrival(self, active, task, now):
        task.assigned_depth = 0
        self._replan(active, now)

    def on_stage_done(self, active, task, now):
        t0 = time.perf_counter()
        # paper §II-E: if measured confidence >= prediction, the plan is
        # still optimal; otherwise try the greedy swap (Eq. 7)
        others = [t for t in active
                  if t.tid != task.tid and t.deadline > now]
        greedy_update(task, others, self.predictor)
        for t in (task, *others):       # admission caps survive the swap
            t.assigned_depth = max(t.clamp_depth(t.assigned_depth),
                                   t.executed)
        self.sched_time += time.perf_counter() - t0
        self.invocations += 1

    def _dispatch_key(self, task):
        """Dispatch preference among feasible runnable tasks (EDF);
        weight-aware variants override."""
        return (task.deadline, task.tid)

    def next_task(self, active, now):
        r = self._runnable(active, now)
        # EDF among tasks with remaining assigned work, feasibility-checked:
        # the next stage must itself finish before the deadline
        r = [t for t in r
             if now + t.stage_times[t.executed] <= t.deadline + 1e-12]
        return min(r, key=self._dispatch_key) if r else None


class WeightedRTDeepIoT(RTDeepIoT):
    """SLO-weighted RTDeepIoT (``register_policy("rtdeepiot-weighted")``).

    The FPTAS objective and the §II-E greedy swap are already
    importance-weighted through ``Task.weight`` (paper §II-A: weighted
    accuracy) — depth *planning* favors heavy classes out of the box.
    This variant extends that preference to the two remaining
    weight-blind decisions, which matter exactly under overload when
    seats are contended:

    * dispatch tie-breaks: among equal deadlines, the heavier task runs
      first;
    * batch composition: ``batch_rank`` seats co-runners by descending
      weight before urgency, so a full bucket sheds light-class work
      first.
    """

    def __init__(self, predictor, delta: float = 0.1):
        super().__init__(predictor, delta=delta)
        self.name = f"rtdeepiot-weighted-{predictor.name}"

    @staticmethod
    def _weight(task) -> float:
        return float(getattr(task, "weight", 1.0))

    def _dispatch_key(self, task):
        return (task.deadline, -self._weight(task), task.tid)

    def batch_rank(self, task, now):
        return (-self._weight(task), task.deadline, task.tid)


class EDF(Policy):
    """Classic earliest-deadline-first over entire tasks (depth = L always;
    no utility awareness, no early stopping)."""
    name = "edf"

    def next_task(self, active, now):
        r = self._runnable(active, now)
        return min(r, key=lambda t: (t.deadline, t.tid)) if r else None


class LCF(Policy):
    """Least-Confidence-First: picks the task with the lowest current
    confidence (unstarted tasks count as confidence 0); deadline breaks
    ties."""
    name = "lcf"

    def next_task(self, active, now):
        r = self._runnable(active, now)
        if not r:
            return None
        return min(r, key=lambda t: (t.last_confidence or 0.0,
                                     t.deadline, t.tid))

    def batch_rank(self, task, now):
        return (task.last_confidence or 0.0, task.deadline, task.tid)


class RR(Policy):
    """Stage-level round-robin across active tasks."""
    name = "rr"

    def __init__(self):
        super().__init__()
        self._last_tid = -1

    def next_task(self, active, now):
        r = sorted(self._runnable(active, now), key=lambda t: t.tid)
        if not r:
            return None
        for t in r:
            if t.tid > self._last_tid:
                self._last_tid = t.tid
                return t
        self._last_tid = r[0].tid
        return r[0]
