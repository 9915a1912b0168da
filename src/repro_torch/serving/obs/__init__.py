"""repro_torch.serving.obs — request tracing, audit log, metrics, exports
(the port of ``repro.serving.obs``).

The observability layer for the serving stack: a passive
:class:`Tracer` threaded through the Fig. 2 loop records one
:class:`RequestTrace` per request (typed spans with queue-wait / host /
device time splits), a scheduler decision audit log (which rule fired
and the numbers behind it), and a :class:`MetricsRegistry`, exporting to
JSONL and Chrome ``trace_event`` JSON in the JAX package's formats.
Enable via ``ServeSpec(trace={"enabled": True})``.

```python
import numpy as np
from repro_torch.serving import ServeSpec, Service

rng = np.random.default_rng(0)
conf = np.sort(rng.uniform(0.3, 1.0, (64, 3)), axis=1)
correct = rng.uniform(size=(64, 3)) < conf

spec = ServeSpec(policy="rtdeepiot", policy_args={"delta": 0.3},
                 batching={"stage_times": [0.004, 0.007, 0.010],
                           "buckets": [1, 2, 4], "marginal": 0.15},
                 source_args={"n_clients": 4, "d_lo": 0.02, "d_hi": 0.25,
                              "n_requests": 12},
                 trace={"enabled": True})
svc = Service.from_spec(spec, conf_table=conf, correct_table=correct)
svc.run()
tr = next(iter(svc.obs.traces.values()))
assert tr.span_names()[0] == "queued" and tr.span_names()[-1] in (
    "retire", "expire")
assert svc.obs.registry.histogram("latency").n == 12
```
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      LATENCY_BUCKETS, QUEUE_DEPTH_BUCKETS,
                      BATCH_OCCUPANCY_BUCKETS, DEPTH_BUCKETS)
from .tracer import Span, RequestTrace, Tracer, TRACE_KEYS
from .export import (write_jsonl, load_obs, chrome_trace,
                     validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "QUEUE_DEPTH_BUCKETS", "BATCH_OCCUPANCY_BUCKETS",
    "DEPTH_BUCKETS",
    "Span", "RequestTrace", "Tracer", "TRACE_KEYS",
    "write_jsonl", "load_obs", "chrome_trace", "validate_chrome_trace",
]
