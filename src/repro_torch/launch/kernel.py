"""``device-kernel``: kernel-backed stage fns behind the runtime core
(``repro.launch.kernel``).

* **Fused exit epilogue** (``mode="classifier"``) — each stage runs
  :func:`repro_torch.models.stage_trunk` and then the fused exit epilogue
  :func:`repro_torch.models.exits.exit_stats_fused`, the hand-written CUDA
  kernel ``repro_torch.kernels.exit_confidence``: RMSNorm → matmul →
  (max, normalizer, argmax) in one kernel.  The stage returns
  ``(h, pred, conf)``; the logits row never leaves the kernel, and ``pred``
  and ``conf`` come back to the host in one copy per window.
* **Ragged decode batching** (``mode="decode"``) — each stage runs
  :func:`repro_torch.models.stage_decode_step`, whose attention reads each
  request's KV rows through the decode-attention CUDA kernel
  (``repro_torch.kernels.decode_attention``): its *per-row* ``slot_pos``
  mask keeps co-batched requests at different positions exact.  Then the
  same fused exit.  Per-request decode state ``{"h", "cache", "cur_pos"}``
  lives in the executor's hidden-state cache: dispatch concatenates the
  stage's caches across the batch (a fresh tensor, which the stage then
  writes in place), commit copies each request's row and cache back out,
  on the device throughout.
* **Length buckets** — :func:`length_bucketed_time_model` refines the
  ``(stage, batch-bucket)`` time model with a length-bucket axis, so the
  batcher, admission and §II-B price ``(stage, batch, length)`` costs.  In
  decode mode a request's KV slot count is its length bucket
  (``Request.seq_len``): the batcher co-batches only one slot count, which
  the cache concatenation needs.
* **Deep pipeline** — ``pipeline_depth - 1`` device windows may be
  enqueued at once (``max_inflight`` on the executor), so the device does
  not drain between windows waiting for host-side batch formation.

The port runs on one GPU: decode mode has no mesh.  Importing this module
registers ``register_executor("device-kernel")``, as ``repro.launch.serve``
does for the JAX package.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.models import (concat_decode_caches, exit_rows,
                                exit_stats_fused, params_device,
                                slice_decode_cache, stage_decode_step,
                                stage_trunk, synchronize)
from repro_torch.serving.batch.batcher import BatchTimeModel, bucket_for
from repro_torch.serving.batch.stage_fns import BatchedStageFns
from repro_torch.serving.batch.time_model import LengthBucketTimeModel
from repro_torch.serving.registry import register_executor
from repro_torch.serving.runtime.device import DeviceExecutor

#: executor_args keys understood by the ``device-kernel`` factory — the
#: single source of truth ``ServeSpec._validate_kernel_args`` reads to
#: reject anything else (typo guard).  The JAX package's TPU-only
#: ``interpret``, ``block_rows`` and ``block_v`` have no counterpart here.
KERNEL_ARGS = ("mode", "len_buckets", "len_marginal")


def length_bucketed_time_model(tm: BatchTimeModel, len_buckets, *,
                               len_marginal: float = 0.25) \
        -> LengthBucketTimeModel:
    """Refine a 2-D ``BatchTimeModel`` with a length-bucket axis.

    The existing ``(stage, bucket)`` table is taken as the *largest*
    length bucket's cost; shorter buckets scale down linearly with a
    ``len_marginal`` floor (cost = base * (lm + (1 - lm) * lb/max_lb)).
    Base ``times`` stay exactly ``tm.times``, so every length-blind
    consumer prices identically before and after refinement.
    """
    if isinstance(tm, LengthBucketTimeModel):
        return tm
    lbs = tuple(sorted(int(b) for b in len_buckets))
    lm = float(len_marginal)
    mats = []
    for lb in lbs:
        frac = lm + (1.0 - lm) * lb / lbs[-1]
        mats.append(tuple(tuple(float(t) * frac for t in row)
                          for row in tm.times))
    return LengthBucketTimeModel(buckets=tm.buckets, times=tm.times,
                                 len_buckets=lbs, times3=tuple(mats))


class KernelStageFns(BatchedStageFns):
    """``BatchedStageFns`` whose stage bodies end in the fused exit
    kernel: ``stage_trunk`` → :func:`exit_stats_fused`, returning
    ``(h, pred, conf)`` with no logits tensor."""

    def stage_body(self, stage: int, params, h):
        h_out = stage_trunk(self.cfg, params, stage, h)
        conf, pred, _m, _lse = exit_stats_fused(
            exit_rows(self.cfg, h_out), params["exits"][stage]["ln"],
            params["exit_shared"]["w_out"], eps=self.cfg.norm_eps)
        return h_out, pred, conf


class KernelDecodeStageFns:
    """Per-stage :func:`stage_decode_step` + fused exit epilogue, attention
    through the decode-attention kernel.

    ``fn(stage)(params, h, st_cache, cur_pos, *, inplace=False)`` runs one
    batched stage of a decode step over the stage's (batched) cache and
    returns ``(h, new_st_cache, pred, conf)``.  With ``inplace=False`` the
    caller's cache is left as it was; ``inplace=True`` writes the new token
    into it, for a caller that owns it (see
    :func:`repro_torch.models.attention.apply_gqa_step`).  :meth:`warmup`
    runs every (stage, batch bucket) at the sample's slot count that has
    not run yet."""

    def __init__(self, cfg, buckets):
        self.cfg = cfg
        self.buckets = tuple(sorted(buckets))
        self.warm: set = set()          # (stage, batch, slots) already run

    def call(self, stage: int, params, h, st_cache, cur_pos, *,
             inplace: bool = False):
        h, new_cache = stage_decode_step(self.cfg, params, stage, st_cache, h,
                                         cur_pos, inplace=inplace)
        conf, pred, _m, _lse = exit_stats_fused(
            h, params["exits"][stage]["ln"], params["exit_shared"]["w_out"],
            eps=self.cfg.norm_eps)
        self.warm.add((stage, h.shape[0], st_cache[0]["k"].shape[2]))
        return h, new_cache, pred, conf

    def fn(self, stage: int):
        return functools.partial(self.call, stage)

    def warmup(self, params, sample_state):
        """Run every (stage, bucket) shape at the sample's slot count that
        has not run yet (e.g. while profiling) before the clock starts;
        other slot counts run first on their first dispatch (warm one
        sample per length bucket to avoid that)."""
        slots = sample_state["cache"][0][0]["k"].shape[2]
        stages = range(self.cfg.num_stages)
        for b in self.buckets:
            if all((s, b, slots) in self.warm for s in stages):
                continue
            h = torch.cat([sample_state["h"]] * b)
            cur = torch.cat([sample_state["cur_pos"]] * b)
            for s in stages:
                cache = concat_decode_caches([sample_state["cache"][s]] * b)
                h = self.call(s, params, h, cache, cur, inplace=True)[0]
            synchronize(params_device(params))


class KernelDeviceExecutor(DeviceExecutor):
    """:class:`DeviceExecutor` over kernel-backed stage fns.

    ``mode="classifier"`` dispatches :class:`KernelStageFns` over
    per-request hidden rows.  ``mode="decode"`` dispatches
    :class:`KernelDecodeStageFns` over per-request decode state
    ``{"h": token or hidden row, "cache": per-stage caches, "cur_pos"}``:
    dispatch concatenates the batch's rows and stage caches (padding
    repeats the last member, whose slot count every co-runner shares),
    commit copies each request's row and stage cache back out into a new
    state dict (the request's own inputs are never written, and no
    committed row keeps the batch alive).

    The window's payload is the stage output plus one (2, B) float32
    tensor holding ``conf`` and the int32 bits of ``pred``, copied to the
    host in one transfer when the window completes."""

    def __init__(self, stage_fns, params, time_model, *,
                 mode: str = "classifier", max_inflight: int = 1):
        super().__init__(stage_fns, params, time_model,
                         max_inflight=max_inflight)
        self.mode = mode

    def wcet(self, stage: int, n: int = 1) -> float:
        return self.time_model.wcet(stage, n)

    def _dispatch_stage(self, stage: int, tasks: list):
        states = [self.states[t.tid][1] for t in tasks]
        if self.mode != "decode":
            h_out, pred, conf, _mask = self.stage_fns.run(stage, self.params,
                                                          states)
            out = h_out
        else:
            b = bucket_for(len(states), self.stage_fns.buckets)
            padded = states + [states[-1]] * (b - len(states))
            h = torch.cat([st["h"] for st in padded])
            cache = concat_decode_caches([st["cache"][stage]
                                          for st in padded])
            cur = torch.cat([st["cur_pos"] for st in padded])
            # the concatenation made ``cache``: the stage may write into it
            h_out, new_cache, pred, conf = self.stage_fns.call(
                stage, self.params, h, cache, cur, inplace=True)
            out = (h_out, new_cache)
        return out, torch.stack((conf, pred.view(torch.float32)))

    def _finalize(self, payload):
        out, stats = payload
        host = stats.cpu().numpy()                 # one copy per window
        return out, host[1].view("int32"), host[0]

    def commit(self, task, k: int) -> float:
        stage, (out, pred, conf) = self._done
        w0 = time.perf_counter()
        st = self.states[task.tid]
        if self.mode != "decode":
            st[1] = out[k:k + 1]
        else:
            h_out, new_cache = out
            caches = list(st[1]["cache"])
            # the request keeps its row past this dispatch: a copy of the
            # row, not a view, which would keep the whole padded batch
            # alive.  The clone costs one row's copy; the reference's
            # commit makes that copy too.
            caches[stage] = [{key: x.clone() for key, x in layer.items()}
                             for layer in slice_decode_cache(new_cache, k)]
            st[1] = {**st[1], "h": h_out[k:k + 1].clone(), "cache": caches}
        c = float(conf[k])
        st[2] = (int(pred[k]), c)
        self.stage_host_time[stage] += time.perf_counter() - w0
        return c


@register_executor("device-kernel")
def build_kernel_executor(args: dict, ctx):
    """Factory behind ``register_executor("device-kernel")``.

    ``args`` (validated by ``ServeSpec.validate()``):

    * ``mode`` — ``"classifier"`` (default: fused-exit ``stage_trunk`` over
      hidden rows) or ``"decode"`` (ragged decode batching over per-request
      KV caches through the decode-attention kernel).
    * ``len_buckets`` — optional ascending lengths; refines
      ``ctx.time_model`` via :func:`length_bucketed_time_model`.
    * ``len_marginal`` — length-scaling floor of that refinement.

    ``max_inflight`` is ``spec.pipeline_depth - 1``.  Resources: ``cfg``,
    ``params`` (their device is where the stages run), optional
    ``stage_fns`` (a :class:`KernelStageFns`, or in decode mode a
    :class:`KernelDecodeStageFns`).
    """
    cfg, params = ctx.resources["cfg"], ctx.resources["params"]
    mode = args.get("mode", "classifier")
    lbs = args.get("len_buckets")
    if lbs:
        ctx.time_model = length_bucketed_time_model(
            ctx.time_model, lbs,
            len_marginal=float(args.get("len_marginal", 0.25)))
    tm = ctx.time_model
    sfns = ctx.resources.get("stage_fns")
    if sfns is None:
        sfns = (KernelDecodeStageFns if mode == "decode"
                else KernelStageFns)(cfg, tm.buckets)
    ex = KernelDeviceExecutor(sfns, params, tm, mode=mode,
                              max_inflight=max(1, int(ctx.spec.pipeline_depth)
                                               - 1))
    ex.warmup = lambda sample: sfns.warmup(params, sample)
    return ex
