"""repro_torch.serving.plane — the record codec of the durable request plane.

Only :mod:`~repro_torch.serving.plane.records` is ported: trace
record/replay (:mod:`repro_torch.serving.traffic.trace`) needs it.  The
rest of the JAX package's plane — the write-ahead ``Journal``, the
idempotent ``DurableQueue`` and ``recover``, the multi-tenant
``FrontDoor`` and ``journal_stats`` — is ROADMAP Queue A item 9b: asking
this package for any of them raises ``NotImplementedError`` naming it,
and the ``"durable"`` / ``"frontdoor"`` source keys do the same
(:data:`repro_torch.serving.registry.NOT_PORTED`).
"""
from repro_torch.serving.plane.records import (
    RECORD_KINDS,
    RECORD_VERSION,
    TERMINAL_KINDS,
    Record,
)

#: names of the JAX package's ``repro.serving.plane`` not ported yet
NOT_PORTED = ("DurableQueue", "FrontDoor", "FrontDoorSource", "Journal",
              "JournalObserver", "RecoveryResult", "TokenBucket",
              "journal_stats", "recover", "scan_journal", "verify_recovery")


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.serving.plane.{name} is not ported yet (ROADMAP "
            "Queue A item 9b: journal, queue, front door and health)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["RECORD_KINDS", "RECORD_VERSION", "TERMINAL_KINDS", "Record"]
