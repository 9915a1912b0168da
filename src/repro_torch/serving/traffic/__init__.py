"""Traffic subsystem: open-loop arrival generators, trace record/replay,
and overload control — ``repro_torch.serving.traffic``, the port of
``repro.serving.traffic``.

Everything plugs into the serving runtime through the registry front door
(``register_source("traffic")`` / ``register_source("replay")``) and the
``Service`` facade (backpressure + metrics streaming) — no core-loop
changes.  Importing this package (``repro_torch.serving`` does it)
registers the source keys.  The same seed draws the same arrivals and
mix as the JAX package, bit for bit (numpy ``Generator`` throughout).
"""
from repro_torch.serving.traffic.control import (OVERFLOW_MODES,
                                                 MetricsStreamer,
                                                 ServiceSnapshot)
from repro_torch.serving.traffic.generators import (ARRIVAL_KINDS,
                                                    ArrivalProcess,
                                                    DiurnalArrivals,
                                                    FlashCrowdArrivals,
                                                    MMPPArrivals,
                                                    PoissonArrivals,
                                                    make_arrival_process)
from repro_torch.serving.traffic.mix import RequestMix, TrafficClass
from repro_torch.serving.traffic.scenarios import (SCENARIOS, SLO_CLASSES,
                                                   Scenario, get_scenario,
                                                   nominal_rate,
                                                   scenario_spec)
from repro_torch.serving.traffic.source import TrafficSource
from repro_torch.serving.traffic.trace import (TraceEvent, TraceRecorder,
                                               admission_signature,
                                               arrival_signature, load_trace,
                                               record_trace, replay_stream,
                                               verify_replay)

__all__ = ["ARRIVAL_KINDS", "ArrivalProcess", "PoissonArrivals",
           "MMPPArrivals", "DiurnalArrivals", "FlashCrowdArrivals",
           "make_arrival_process", "RequestMix", "TrafficClass",
           "TrafficSource", "TraceEvent", "TraceRecorder", "record_trace",
           "load_trace", "replay_stream", "arrival_signature",
           "admission_signature", "verify_replay", "MetricsStreamer",
           "ServiceSnapshot", "OVERFLOW_MODES", "SCENARIOS", "SLO_CLASSES",
           "Scenario", "get_scenario", "nominal_rate", "scenario_spec"]
