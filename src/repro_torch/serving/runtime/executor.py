"""Executor abstraction: *what actually runs* a dispatched stage batch.

The runtime core dispatches non-preemptive ``(stage, [tasks])`` units and
observes one confidence per in-time member.  Where those numbers come from
is the executor's business:

* ``OracleExecutor`` (here, numpy-only) — the discrete-event simulators'
  device model: a batch of ``n`` at stage ``s`` occupies the device for
  ``time_model.wcet(s, n)`` virtual seconds and each member's confidence
  is read from the per-sample oracle table.
* ``DeviceExecutor`` (``repro_torch.serving.runtime.device``, torch) — real
  stage functions on the GPU; completion time is whenever the window's
  recorded CUDA event completes on the wall clock.

Contract (the device is one non-preemptive resource; pipelining overlaps
*host* work with it, not device work with device work):

    wcet(stage, n)            feasibility price of a batch of n
    submit(stage, tasks, now) start the batch (must not block)
    busy                      a batch is in flight
    finish_time()             known completion time of the *oldest*
                              in-flight batch, +inf when idle, or ``None``
                              when only blocking can tell (wall)
    complete(clock)           finish the oldest in-flight batch; advances/
                              reads the clock; returns (stage, tasks)
    commit(task, k)           record member k's stage output (called only
                              for members whose stage finished in time);
                              returns the measured confidence

Executors hold a *single* in-flight batch unless they expose an
``accepting`` property; when present and true, the core (at
``pipeline_depth >= 3``) may ``submit`` further batches while ``busy`` —
they queue behind the running one (FIFO) and ``complete`` retires them
oldest-first.  ``running_tasks()`` must cover every queued window so the
core never double-dispatches an in-flight task.
"""
from __future__ import annotations

import math


class Executor:
    @property
    def busy(self) -> bool:
        raise NotImplementedError

    def wcet(self, stage: int, n: int) -> float:
        raise NotImplementedError

    def submit(self, stage: int, tasks: list, now: float) -> None:
        raise NotImplementedError

    def finish_time(self):
        raise NotImplementedError

    def complete(self, clock) -> tuple:
        raise NotImplementedError

    def commit(self, task, k: int) -> float:
        raise NotImplementedError

    def running_tasks(self) -> list:
        raise NotImplementedError


class OracleExecutor(Executor):
    """Virtual device over oracle tables and a ``BatchTimeModel``.

    ``total_busy`` accumulates device-occupied virtual seconds (the
    denominator of the paper's overhead fraction).  ``max_inflight > 1``
    models a deep dispatch pipeline (``pipeline_depth >= 3``): further
    windows queue FIFO behind the running one and start the moment it
    finishes — the virtual-clock analog of multiple enqueued device
    windows.
    """

    def __init__(self, time_model, conf_table, *, max_inflight: int = 1):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.time_model = time_model
        self.conf_table = conf_table
        self.max_inflight = int(max_inflight)
        self.total_busy = 0.0
        self._inflight: list = []    # (stage, tasks, finish_time), oldest 1st

    @property
    def busy(self) -> bool:
        return bool(self._inflight)

    @property
    def accepting(self) -> bool:
        """Room for another enqueued window (core dispatches extra windows
        at ``pipeline_depth >= 3`` only while this holds)."""
        return len(self._inflight) < self.max_inflight

    def wcet(self, stage: int, n: int) -> float:
        return self.time_model.wcet(stage, n)

    def submit(self, stage: int, tasks: list, now: float) -> None:
        # length-aware when the model has a length axis and the batch
        # declares seq_lens (repro_torch.serving.batch.time_model.batch_wcet)
        from repro_torch.serving.batch.time_model import batch_wcet
        dur = batch_wcet(self.time_model, stage, tasks)
        self.total_busy += dur
        # a queued window starts when the one ahead of it finishes
        start = max(now, self._inflight[-1][2]) if self._inflight else now
        self._inflight.append((stage, tasks, start + dur))

    def finish_time(self):
        return self._inflight[0][2] if self._inflight else math.inf

    def complete(self, clock) -> tuple:
        stage, tasks, t_fin = self._inflight.pop(0)
        clock.advance_to(t_fin)
        return stage, tasks

    def commit(self, task, k: int) -> float:
        # called after task.executed was advanced for this stage
        return float(self.conf_table[task.sample, task.executed - 1])

    def running_tasks(self) -> list:
        return [t for _, tasks, _ in self._inflight for t in tasks]
