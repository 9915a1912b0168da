"""Serving package — one public front door, one runtime core.

New code talks to :class:`~repro_torch.serving.service.Service` built from a
declarative :class:`~repro_torch.serving.service.ServeSpec` (components
named by registry key — see :mod:`repro_torch.serving.registry`).
"""
from repro_torch.serving.engine import (Request, Response, closed_loop_stream,
                                        profile_host_overhead)
from repro_torch.serving.batch import (AdmissionController, BatchedPolicy,
                                       BatchedStageFns, BatchPolicy,
                                       BatchTimeModel, LengthBucketTimeModel,
                                       StageBatcher, as_batch_policy,
                                       pad_batch, profile_batched_stages)
from repro_torch.serving.registry import (available, register_clock,
                                          register_executor, register_policy,
                                          register_source)
from repro_torch.serving.runtime import (ClosedLoopSource, EngineCore,
                                         OracleExecutor, StreamSource,
                                         TableRecorder, VirtualClock,
                                         WallClock, simulate_runtime)
from repro_torch.serving.service import (ResponseHandle, ServeSpec, Service,
                                         ServiceMetrics, ServiceResponse,
                                         SLOClass, StageExit)

__all__ = ["Request", "Response", "closed_loop_stream",
           "profile_host_overhead",
           "AdmissionController", "BatchedPolicy", "BatchedStageFns",
           "BatchPolicy", "BatchTimeModel", "LengthBucketTimeModel",
           "StageBatcher", "as_batch_policy", "pad_batch",
           "profile_batched_stages",
           "available", "register_clock", "register_executor",
           "register_policy", "register_source",
           "ClosedLoopSource", "EngineCore", "OracleExecutor", "StreamSource",
           "TableRecorder", "VirtualClock", "WallClock", "simulate_runtime",
           "ResponseHandle", "ServeSpec", "Service", "ServiceMetrics",
           "ServiceResponse", "SLOClass", "StageExit"]
