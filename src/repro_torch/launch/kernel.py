"""``device-kernel``: kernel-backed stage fns behind the runtime core
(``repro.launch.kernel``), classifier mode.

Each stage runs :func:`repro_torch.models.stage_trunk` and then the fused
exit epilogue :func:`repro_torch.models.exits.exit_stats_fused` — the
hand-written CUDA kernel ``repro_torch.kernels.exit_confidence``: RMSNorm →
matmul → (max, normalizer, argmax) in one kernel.  The stage returns
``(h, pred, conf)``; the logits row never leaves the kernel, and ``pred``
and ``conf`` come back to the host in one copy per window.

* **Length buckets** — :func:`length_bucketed_time_model` refines the
  ``(stage, batch-bucket)`` time model with a length-bucket axis, so the
  batcher, admission and §II-B price ``(stage, batch, length)`` costs.
* **Deep pipeline** — ``pipeline_depth - 1`` device windows may be
  enqueued at once (``max_inflight`` on the executor), so the device does
  not drain between windows waiting for host-side batch formation.

Decode mode (ragged decode batching over per-request KV caches) is not
ported yet (ROADMAP Queue A item 8).  Importing this module registers
``register_executor("device-kernel")``, as ``repro.launch.serve`` does for
the JAX package.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models import exit_rows, exit_stats_fused, stage_trunk
from repro_torch.serving.batch.batcher import BatchTimeModel
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


class KernelDeviceExecutor(DeviceExecutor):
    """:class:`DeviceExecutor` over :class:`KernelStageFns` (classifier
    mode): the window's payload is the stage-out hidden state plus one
    (2, B) float32 tensor holding ``conf`` and the int32 bits of ``pred``,
    copied to the host in one transfer when the window completes."""

    def wcet(self, stage: int, n: int = 1) -> float:
        return self.time_model.wcet(stage, n)

    def _dispatch_stage(self, stage: int, tasks: list):
        hs = [self.states[t.tid][1] for t in tasks]
        h_out, pred, conf, _mask = self.stage_fns.run(stage, self.params, hs)
        return h_out, torch.stack((conf, pred.view(torch.float32)))

    def _finalize(self, payload):
        h_out, stats = payload
        host = stats.cpu().numpy()                 # one copy per window
        return h_out, host[1].view("int32"), host[0]

    def commit(self, task, k: int) -> float:
        stage, (h_out, pred, conf) = self._done
        w0 = time.perf_counter()
        st = self.states[task.tid]
        st[1] = h_out[k:k + 1]
        c = float(conf[k])
        st[2] = (int(pred[k]), c)
        self.stage_host_time[stage] += time.perf_counter() - w0
        return c


@register_executor("device-kernel")
def build_kernel_executor(args: dict, ctx):
    """Factory behind ``register_executor("device-kernel")``.

    ``args`` (validated by ``ServeSpec.validate()``):

    * ``mode`` — ``"classifier"`` (the only mode ported; ``"decode"``
      raises ``NotImplementedError``).
    * ``len_buckets`` — optional ascending lengths; refines
      ``ctx.time_model`` via :func:`length_bucketed_time_model`.
    * ``len_marginal`` — length-scaling floor of that refinement.

    ``max_inflight`` is ``spec.pipeline_depth - 1``.  Resources: ``cfg``,
    ``params`` (their device is where the stages run), optional
    ``stage_fns`` (a :class:`KernelStageFns`).
    """
    cfg, params = ctx.resources["cfg"], ctx.resources["params"]
    if args.get("mode", "classifier") != "classifier":
        raise NotImplementedError(
            "device-kernel mode 'decode' is not ported to repro_torch yet "
            "(ROADMAP Queue A item 8)")
    lbs = args.get("len_buckets")
    if lbs:
        ctx.time_model = length_bucketed_time_model(
            ctx.time_model, lbs,
            len_marginal=float(args.get("len_marginal", 0.25)))
    tm = ctx.time_model
    sfns = ctx.resources.get("stage_fns") or KernelStageFns(cfg, tm.buckets)
    ex = KernelDeviceExecutor(sfns, params, tm,
                              max_inflight=max(1, int(ctx.spec.pipeline_depth)
                                               - 1))
    ex.warmup = lambda sample_input: sfns.warmup(params, sample_input)
    return ex
