"""Serving package — one public front door, one runtime core.

New code talks to :class:`~repro_torch.serving.service.Service` built from a
declarative :class:`~repro_torch.serving.service.ServeSpec` (components
named by registry key — see :mod:`repro_torch.serving.registry`); the four
legacy faces (``simulate``, ``simulate_batched``, ``ServingEngine``,
``BatchedServingEngine``) are deprecated thin wrappers over it.
"""
from repro_torch.serving.engine import (Request, Response, ServingEngine,
                                        closed_loop_stream, make_stage_fns,
                                        profile_host_overhead, profile_stages)
from repro_torch.serving.batch import (AdmissionController, BatchedPolicy,
                                       BatchedServingEngine, BatchedStageFns,
                                       BatchPolicy, BatchTimeModel,
                                       LengthBucketTimeModel, StageBatcher,
                                       as_batch_policy, pad_batch,
                                       profile_batched_stages,
                                       simulate_batched)
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
# importing the traffic subsystem registers its source keys
# ("traffic", "replay") — see repro_torch.serving.traffic for the surface
from repro_torch.serving.traffic import (MetricsStreamer, RequestMix,
                                         Scenario, ServiceSnapshot,
                                         TraceRecorder, TrafficSource,
                                         load_trace, make_arrival_process,
                                         record_trace, scenario_spec,
                                         verify_replay)
# the record codec of the durable plane (the plane itself: ROADMAP Queue A
# item 9b)
from repro_torch.serving.plane import Record
# observability: per-request tracing, decision audit log, metrics registry
# (enable with ServeSpec(trace={"enabled": True}))
from repro_torch.serving.obs import (MetricsRegistry, RequestTrace, Span,
                                     Tracer, chrome_trace, load_obs,
                                     validate_chrome_trace, write_jsonl)

__all__ = ["Request", "Response", "ServingEngine", "closed_loop_stream",
           "make_stage_fns", "profile_host_overhead", "profile_stages",
           "AdmissionController", "BatchedPolicy", "BatchedServingEngine",
           "BatchedStageFns", "BatchPolicy", "BatchTimeModel",
           "LengthBucketTimeModel", "StageBatcher", "as_batch_policy",
           "pad_batch", "profile_batched_stages", "simulate_batched",
           "available", "register_clock", "register_executor",
           "register_policy", "register_source",
           "ClosedLoopSource", "EngineCore", "OracleExecutor", "StreamSource",
           "TableRecorder", "VirtualClock", "WallClock", "simulate_runtime",
           "ResponseHandle", "ServeSpec", "Service", "ServiceMetrics",
           "ServiceResponse", "SLOClass", "StageExit",
           "MetricsStreamer", "RequestMix", "Scenario", "ServiceSnapshot",
           "TraceRecorder", "TrafficSource", "load_trace",
           "make_arrival_process", "record_trace", "scenario_spec",
           "verify_replay", "Record", "MetricsRegistry", "RequestTrace",
           "Span", "Tracer", "chrome_trace", "load_obs",
           "validate_chrome_trace", "write_jsonl"]
