"""DeviceExecutor — real stage functions on the GPU behind the runtime core
(``repro.serving.runtime.device``).

``submit`` launches the batched stage on the device's current CUDA stream
and records a ``torch.cuda.Event`` after it, *without* synchronising
(PyTorch launches asynchronously), so with ``pipeline_depth >= 2`` the core
pre-selects the next batch on the host while the device computes;
``complete`` waits on that event — where the JAX package calls
``block_until_ready`` — and reads the wall clock for the completion time.
On the CPU the stage runs inside ``submit`` and there is no event.

Multiple in-flight windows: the executor accepts up to ``max_inflight``
submitted-but-uncompleted batches (a FIFO — one CUDA stream executes
launches in submission order).  ``complete`` retires the oldest window;
``running_tasks`` covers every queued window so the core never
double-dispatches an in-flight task.

Per-request state (input dict or hidden rows, deepest in-time exit) lives
here: it is the serving stack's hidden-state cache.  A request's state is
registered at admission, **persisted across stage dispatches** (each
``commit`` keeps the request's row of the batched stage output — a view
of a hidden row, a copy of a decode cache row — which stays on the
device, never copied to the host between stages) and **evicted on
retire** (the recorder pops it via ``pop_state``).  ``cache_stats()``
reports live/peak/evicted counts.

Subclasses supply the window's payload: ``_dispatch_stage(stage, tasks)``
launches the batched stage, ``_finalize(payload)`` brings what the host
needs back once the window completes, and ``commit(task, k)`` reads row
``k`` of it.  The one subclass ported so far is ``KernelDeviceExecutor``
(:mod:`repro_torch.launch.kernel`: fused exit kernel, classifier and decode
modes); the logits-returning
``device-single`` / ``device-batched`` executors are not ported yet
(ROADMAP Queue A item 5).

Telemetry: per-stage host seconds (launch + commit work, on
``perf_counter``) vs device seconds (time the host spent *waiting* on the
window's event), surfaced via :meth:`device_time_stats`; windows
submitted per stage in ``stage_dispatches``.
"""
from __future__ import annotations

import collections
import math
import time

import torch

from repro_torch.models import params_device


class DeviceExecutor:
    def __init__(self, stage_fns, params, time_model, *,
                 max_inflight: int = 1):
        self.stage_fns = stage_fns      # object with .run(stage, params, [h])
        self.params = params
        self.device = params_device(params)
        self.time_model = time_model
        self.max_inflight = max(1, int(max_inflight))
        self.total_busy = 0.0           # host-observed device-busy seconds
        self.states: dict = {}          # tid -> [request, hidden/inputs, exit]
        self.evictions = 0              # states popped on retire
        self.peak_cached = 0            # high-water mark of live states
        self._inflight = collections.deque()   # submitted, oldest first
        self._done = None
        self.stage_dispatches = collections.Counter()   # stage -> windows
        # per-stage host/device seconds (see module docstring)
        self.stage_host_time: dict = collections.defaultdict(float)
        self.stage_device_time: dict = collections.defaultdict(float)

    # -- request state (the hidden-state cache) ------------------------
    def register(self, task, request) -> None:
        """Admit ``task``'s state into the cache (raw inputs until the
        first stage commits a hidden row)."""
        self.states[task.tid] = [request, request.inputs, None]
        self.peak_cached = max(self.peak_cached, len(self.states))

    def pop_state(self, task):
        """Evict on retire — the other end of the cache lifecycle."""
        self.evictions += 1
        return self.states.pop(task.tid)

    def cache_stats(self) -> dict:
        return dict(live=len(self.states), peak=self.peak_cached,
                    evictions=self.evictions)

    def device_time_stats(self) -> dict:
        """Measured per-stage host vs device seconds (and their totals)."""
        return dict(
            host_time=float(sum(self.stage_host_time.values())),
            device_time=float(sum(self.stage_device_time.values())),
            stage_host_time={int(s): float(v)
                             for s, v in sorted(self.stage_host_time.items())},
            stage_device_time={int(s): float(v) for s, v in
                               sorted(self.stage_device_time.items())})

    def _record(self):
        """An event after the work launched so far (None on the CPU, where
        the work is already done)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    # -- Executor contract ---------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(self._inflight)

    @property
    def accepting(self) -> bool:
        """May the core submit another window while ``busy``?"""
        return len(self._inflight) < self.max_inflight

    def wcet(self, stage: int, n: int) -> float:
        return self.time_model.wcet(stage, n)

    def submit(self, stage: int, tasks: list, now: float) -> None:
        w0 = time.perf_counter()
        payload = self._dispatch_stage(stage, tasks)
        event = self._record()
        self.stage_dispatches[stage] += 1
        self.stage_host_time[stage] += time.perf_counter() - w0
        self._inflight.append((stage, tasks, payload, event, now))

    def finish_time(self):
        # real devices do not announce completion times — the core must
        # block (None), unlike the oracle executor's known virtual finish
        return None if self.busy else math.inf

    def complete(self, clock):
        stage, tasks, payload, event, t0 = self._inflight.popleft()
        w0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self.stage_device_time[stage] += time.perf_counter() - w0
        self.total_busy += clock.now() - t0
        self._done = (stage, self._finalize(payload))
        return stage, tasks

    def running_tasks(self) -> list:
        return [t for (_s, tasks, _p, _e, _t0) in self._inflight
                for t in tasks]
