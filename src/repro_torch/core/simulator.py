"""Discrete-event simulator for the serving system (paper §IV protocol;
``repro.core.simulator``): the workload and result records and the
deprecated ``simulate`` shim.

Workload model (paper §IV): K concurrent closed-loop clients.  Each client
has one outstanding request at a time; when it completes (or its deadline
expires) the client immediately issues the next, with a relative deadline
drawn from U[D_l, D_u] and a sample drawn from the shuffled test set.

The simulator drives any Policy over per-sample oracle tables
(confidence[sample, stage], correct[sample, stage]) and profiled stage WCETs.
Deadline-miss semantics follow the paper: a request fails iff *no* stage
completed before its deadline; otherwise the last in-time exit's prediction
is the result.

``simulate`` is a deprecated wrapper over the public serving facade
(``repro_torch.serving.service``): a ``ServeSpec`` on the oracle executor /
virtual clock / closed-loop source whose time model has a single batch
bucket — every dispatch is a singleton batch, i.e. exactly the paper's
Fig. 2 loop.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Workload:
    n_clients: int = 20
    d_lo: float = 0.01
    d_hi: float = 0.3
    n_requests: int = 500          # total across clients
    seed: int = 0
    mandatory_stages: int = 1


@dataclasses.dataclass
class SimResult:
    accuracy: float
    miss_rate: float
    mean_depth: float
    mean_conf: float
    overhead_frac: float
    n_requests: int
    per_request: list
    makespan: float = 0.0          # simulated seconds until the last event
    throughput: float = 0.0        # completed (non-missed) requests / second
    # unified host-cost accounting (repro_torch.serving.runtime) ------------------
    sched_charged: float = 0.0     # all host scheduling cost incurred
    host_serial: float = 0.0       # the part that serialized with the device
    host_overhead_frac: float = 0.0   # host_serial / (busy + host_serial)
    n_dispatches: int = 0
    presel_hits: int = 0           # pipelined dispatch: pre-selections kept
    presel_misses: int = 0         # ... re-planned at dispatch time

    def row(self):
        return dict(accuracy=self.accuracy, miss_rate=self.miss_rate,
                    mean_depth=self.mean_depth, overhead=self.overhead_frac,
                    throughput=self.throughput)

    def to_dict(self, *, per_request: bool = False) -> dict:
        """All fields as a JSON-able dict (``per_request`` rows are bulky
        and excluded unless asked for)."""
        d = dataclasses.asdict(self)
        if not per_request:
            d.pop("per_request")
        return d



def simulate(policy, workload: Workload, stage_times, conf_table,
             correct_table, *, charge_overhead: bool = False,
             dispatch_overhead: float = 0.0) -> SimResult:
    """Deprecated wrapper over ``repro_torch.serving.Service``: the paper's
    Fig. 2 loop as an unbatched (singleton-dispatch) discrete-event
    service.  stage_times: (L,) profiled WCETs; conf_table/correct_table:
    (n_samples, L) oracle outputs per test sample per stage."""
    # imported here: repro_torch.core stays importable without pulling the
    # serving package at module-import time (the runtime imports SimResult
    # from us)
    from repro_torch.serving.deprecation import deprecate_once
    from repro_torch.serving.service import ServeSpec, Service

    deprecate_once(
        "repro_torch.core.simulate",
        "simulate() is deprecated: build a ServeSpec(batching={'mode': "
        "'none', ...}) and run it through repro_torch.serving.Service "
        "instead")
    spec = ServeSpec(
        executor="oracle", clock="virtual", source="closed-loop",
        batching={"mode": "none",
                  "stage_times": [float(x) for x in stage_times]},
        charge_overhead=charge_overhead,
        dispatch_overhead=dispatch_overhead)
    return Service.from_spec(spec, policy=policy, workload=workload,
                             conf_table=conf_table,
                             correct_table=correct_table).run()
