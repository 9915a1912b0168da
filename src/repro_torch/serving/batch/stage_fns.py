"""Batched stage functions: shape buckets, padding, masks (``repro.serving.batch.stage_fns``).

Batches are padded up to a small set of **buckets** (default
{1, 2, 4, 8, 16}), so a stage only ever runs at ``len(buckets)`` batch
shapes.  Padding replicates the last valid sample; batch rows are
independent (attention mixes over the sequence axis, norms over features),
so valid rows of the padded run match per-sample runs and the returned
boolean mask marks which rows are real.

Stage 0's inputs are numpy arrays on the host: they are written into a
pinned host buffer and reach the device in one asynchronous copy
(:class:`StagingBuffers`).  Later stages' inputs are hidden-state rows
already on the device, concatenated there.  PyTorch runs eagerly, so there
is no per-shape compile step; ``warmup`` runs each (stage, bucket) shape
once before the serving clock starts, which builds and loads the CUDA
kernels and initialises the math libraries.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import params_device, synchronize
from repro_torch.serving.batch.batcher import (DEFAULT_BUCKETS, BatchTimeModel,
                                               bucket_for)


class _Slot:
    """One pinned host buffer set and the event of the copy that read it."""

    def __init__(self, host: dict):
        self.host = host
        self.event = None


class StagingBuffers:
    """Reused per-bucket host staging for stage-0 batch formation.

    Each (bucket, input signature) owns a small ring of pinned host buffers.
    Rows are copied in place, padding rows replicate the last valid row,
    and the batch goes to the device in one non-blocking copy on the
    current stream, after which an event is recorded.  A slot is written
    again only once the event of its previous copy has completed, so a
    queued copy never reads a buffer the host is refilling.

    The returned masks are cached per (bucket, n) and are read-only."""

    RING = 4                  # slots per key: windows that may be in flight

    def __init__(self):
        self._slots = {}     # (bucket, signature, device) -> [_Slot, ...]
        self._next = {}      # same key -> index of the next slot to use
        self._masks = {}     # (bucket, n) -> np.ndarray(bool)

    def mask(self, bucket: int, n: int) -> np.ndarray:
        key = (bucket, n)
        m = self._masks.get(key)
        if m is None:
            m = np.arange(bucket) < n
            m.setflags(write=False)
            self._masks[key] = m
        return m

    def stage(self, inputs: list, bucket: int, device: torch.device):
        """Pad the single-sample input dicts ``inputs`` into ``bucket`` rows
        on ``device``.  Returns ``(batched dict, mask)``."""
        n = len(inputs)
        if not 0 < n <= bucket:
            raise ValueError(f"cannot pad {n} samples into bucket {bucket}")
        first = {k: np.asarray(v) for k, v in inputs[0].items()}
        sig = tuple((k, v.shape[1:], v.dtype.str)
                    for k, v in sorted(first.items()))
        key = (bucket, sig, device)
        slots = self._slots.get(key)
        if slots is None:
            def host(shape, dt):
                t = torch.from_numpy(np.empty((bucket,) + shape,
                                              dtype=np.dtype(dt)))
                return t.pin_memory() if device.type == "cuda" else t
            slots = [_Slot({k: host(shape, dt) for k, shape, dt in sig})
                     for _ in range(self.RING)]
            self._slots[key] = slots
            self._next[key] = 0
        slot = slots[self._next[key]]
        self._next[key] = (self._next[key] + 1) % self.RING
        if slot.event is not None:
            slot.event.synchronize()
        for k, buf in slot.host.items():
            arr = buf.numpy()
            for i, tree in enumerate(inputs):
                arr[i] = np.asarray(tree[k])[0]
            arr[n:] = arr[n - 1]                  # replicate last valid row
        if device.type == "cuda":
            out = {k: v.to(device, non_blocking=True)
                   for k, v in slot.host.items()}
            slot.event = torch.cuda.Event()
            slot.event.record(torch.cuda.current_stream(device))
        else:
            out = {k: v.clone() for k, v in slot.host.items()}
        return out, self.mask(bucket, n)


def pad_batch(rows: list, bucket: int, *, staging: StagingBuffers = None,
              device=None):
    """Stack single-sample stage inputs (leading dim 1) into a padded batch.

    ``rows``: hidden-state tensors on the device (concatenated there), or
    host input dicts of numpy arrays (staged through ``staging`` onto
    ``device``).  Returns ``(batched, mask)`` — mask[i] is True for the
    ``len(rows)`` valid rows, False for the replicated padding rows."""
    n = len(rows)
    if not 0 < n <= bucket:
        raise ValueError(f"cannot pad {n} samples into bucket {bucket}")
    if isinstance(rows[0], torch.Tensor):
        reps = list(rows) + [rows[-1]] * (bucket - n)
        return torch.cat(reps, dim=0), np.arange(bucket) < n
    if staging is None or device is None:
        raise ValueError("host inputs need a StagingBuffers and a device")
    return staging.stage(rows, bucket, torch.device(device))


class BatchedStageFns:
    """Per-stage batched stage bodies with bucket discipline.

    ``call(stage, params, h)`` runs one stage on an already padded batch
    and records the (stage, batch) shape as warm.  Subclasses supply
    ``stage_body``: the one ported so far is ``KernelStageFns``
    (:mod:`repro_torch.launch.kernel`); the plain ``stage_forward`` bodies
    of ``device-batched`` are not ported yet (ROADMAP Queue A item 5)."""

    def __init__(self, cfg, buckets=DEFAULT_BUCKETS):
        self.cfg = cfg
        self.buckets = tuple(sorted(buckets))
        self.staging = StagingBuffers()
        self.warm: set = set()           # (stage, batch) shapes already run

    def stage_body(self, stage: int, params, h):
        raise NotImplementedError(
            "plain stage_forward stage bodies (device-batched) are not "
            "ported to repro_torch yet (ROADMAP Queue A item 5)")

    def call(self, stage: int, params, h):
        b = (h["features"] if isinstance(h, dict) else h).shape[0]
        out = self.stage_body(stage, params, h)
        self.warm.add((stage, b))
        return out

    def pad(self, params, rows: list, bucket: int):
        return pad_batch(rows, bucket, staging=self.staging,
                         device=params_device(params))

    def run(self, stage: int, params, rows: list):
        """Pad, dispatch one batched stage, return (*outputs, mask).

        ``rows``: single-sample stage inputs (raw input dicts for stage 0,
        hidden states after)."""
        h, mask = self.pad(params, rows, bucket_for(len(rows), self.buckets))
        return (*self.call(stage, params, h), mask)

    def warmup(self, params, sample_input):
        """Run every (stage, bucket) shape not yet run before the clock
        starts (shapes already run, e.g. while profiling, are skipped)."""
        device = params_device(params)
        for b in self.buckets:
            if all((s, b) in self.warm for s in range(self.cfg.num_stages)):
                continue
            h = self.pad(params, [sample_input], b)[0]
            for s in range(self.cfg.num_stages):
                h = self.call(s, params, h)[0]
            synchronize(device)


def profile_batched_stages(cfg, params, fns: BatchedStageFns, sample_input, *,
                           n_runs: int = 30, percentile: float = 99.0):
    """Profile the (num_stages, num_buckets) batched-stage WCET matrix.

    Each sample is a host clock around one stage that ends in a device
    synchronize; the WCET is the ``percentile`` of ``n_runs`` samples
    (paper §IV).  Returns ``(BatchTimeModel, matrix)``."""
    device = params_device(params)
    L = cfg.num_stages
    mat = np.zeros((L, len(fns.buckets)))
    for bi, b in enumerate(fns.buckets):
        h = fns.pad(params, [sample_input], b)[0]
        for s in range(L):
            out = fns.call(s, params, h)              # first run of the shape
            synchronize(device)
            ts = np.zeros(n_runs)
            for i in range(n_runs):
                t0 = time.perf_counter()
                out = fns.call(s, params, h)
                synchronize(device)
                ts[i] = time.perf_counter() - t0
            mat[s, bi] = np.percentile(ts, percentile)
            h = out[0]
    return BatchTimeModel.from_profile(mat, fns.buckets), mat
