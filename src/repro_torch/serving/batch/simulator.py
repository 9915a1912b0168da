"""Discrete-event simulator for the *batched* serving path
(``repro.serving.batch.simulator``).

Identical workload/closed-loop/miss semantics to
:mod:`repro_torch.core.simulator` (K clients, reissue at completion, a
request fails iff no stage finished in time) — but the server dispatches
(stage, [tasks]) micro-batches chosen by a ``BatchPolicy``, and a batch of
``n`` at stage ``s`` occupies the accelerator for ``time_model.wcet(s, n)``
(bucket-rounded, exactly what the wall-clock ``BatchedServingEngine``
pays).

An optional ``AdmissionController`` runs at issue time; a rejected request
counts as a miss (depth 0) and frees its client immediately.

``simulate_batched`` is a deprecated wrapper over the public serving
facade (:mod:`repro_torch.serving.service`): a ``ServeSpec`` on the oracle
executor / virtual clock / closed-loop source with the caller's batch
time model; pipelined async dispatch is ``ServeSpec(pipeline_depth=2)``.
"""
from __future__ import annotations

from repro_torch.core.simulator import SimResult, Workload
from repro_torch.serving.batch.batcher import BatchTimeModel


def simulate_batched(policy, workload: Workload, time_model: BatchTimeModel,
                     conf_table, correct_table, *,
                     charge_overhead: bool = False,
                     dispatch_overhead: float = 0.0,
                     admission=None, max_batch: int = None) -> SimResult:
    """Like ``repro_torch.core.simulate`` but stage dispatches are
    micro-batches.

    ``policy`` may be any single-task Policy (wrapped via
    ``as_batch_policy``) or a ready-made BatchPolicy."""
    from repro_torch.serving.deprecation import deprecate_once
    from repro_torch.serving.service import ServeSpec, Service

    deprecate_once(
        "repro_torch.serving.batch.simulate_batched",
        "simulate_batched() is deprecated: build a ServeSpec(batching="
        "{'buckets': ..., ...}) and run it through "
        "repro_torch.serving.Service instead")
    L = conf_table.shape[1]
    if time_model.num_stages != L:
        raise ValueError(f"time model has {time_model.num_stages} stages, "
                         f"oracle tables have {L}")
    spec = ServeSpec(
        executor="oracle", clock="virtual", source="closed-loop",
        batching={"max_batch": max_batch},
        charge_overhead=charge_overhead,
        dispatch_overhead=dispatch_overhead)
    return Service.from_spec(spec, policy=policy, workload=workload,
                             time_model=time_model, admission=admission,
                             conf_table=conf_table,
                             correct_table=correct_table).run()
