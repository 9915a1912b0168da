"""Component registry: string keys -> serving-component factories.

``ServeSpec`` (repro_torch.serving.service) names its policy, executor, clock
and source by *string key*; this module is where those keys resolve.  The
four registries are entry-point style — anything (an example, a benchmark,
a launcher, a test, a downstream package) can plug a new scheduler or
executor in without touching the core modules:

    from repro_torch.serving.registry import register_policy

    @register_policy("my-scheduler")
    def _make(args, ctx):
        return MyScheduler(**args)

    spec = ServeSpec(policy="my-scheduler", policy_args={...})

Factory contract
----------------
``factory(args: dict, ctx: BuildContext) -> component``

* ``args`` — the spec's JSON-able ``*_args`` dict for this component.
* ``ctx``  — the build context: the full ``spec``, the caller-supplied
  ``resources`` (non-serializable runtime objects: oracle tables, params,
  stage fns, workloads, request streams), and the pieces built so far
  (``time_model``/``max_batch`` always; ``policy``/``clock``/``executor``
  for later stages; ``task_factory``/``stream`` for sources).

Built-in keys (registered below):

========  =================================================================
policy    ``rtdeepiot`` (predictor/prior_curve/delta/oracle via args),
          ``rtdeepiot-weighted`` (same + ``Task.weight``-aware dispatch
          and batch seating), ``edf``, ``lcf``, ``rr``
executor  ``oracle`` (conf tables + BatchTimeModel)
clock     ``virtual`` (discrete event), ``wall`` (real time)
source    ``closed-loop`` (§IV K-client workload), ``stream``
          ((offset, Request) list), ``live`` (``Service.submit`` queue)
========  =================================================================

``repro_torch.launch.kernel`` registers the executor ``device-kernel``
(each stage ends in the fused exit-confidence CUDA kernel; decode mode
runs attention through the decode-attention CUDA kernel) and
``repro_torch.launch.serve`` registers the token-loop launcher's policy
``conf-target``, executor ``decode`` and source ``token-loop``, from
outside this module, as ``repro.launch.serve`` does in the JAX package.  Keys of the JAX package that the port has not taken up
yet resolve to ``NotImplementedError`` naming their ROADMAP queue item
(:data:`NOT_PORTED`).

Example — a custom policy, end to end:

```python
from repro_torch.core.schedulers import EDF
from repro_torch.serving import ServeSpec, Service
from repro_torch.serving.registry import register_policy

@register_policy("my-edf")
def _make(args, ctx):
    return EDF()

import numpy as np
conf = np.full((50, 3), 0.8); correct = conf > np.random.default_rng(0).random((50, 3))
spec = ServeSpec(policy="my-edf",
                 batching={"mode": "none", "stage_times": [0.01] * 3},
                 source_args={"n_clients": 4, "d_lo": 0.02, "d_hi": 0.2,
                              "n_requests": 40})
res = Service.from_spec(spec, conf_table=conf, correct_table=correct).run()
assert res.n_requests == 40
```
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

KINDS = ("policy", "executor", "clock", "source")

_REGISTRY: dict = {kind: {} for kind in KINDS}

#: registry keys of the JAX package not ported yet -> their ROADMAP item
NOT_PORTED = {
    ("executor", "device-single"): "Queue A item 5",
    ("executor", "device-batched"): "Queue A item 5",
    ("executor", "device-sharded"): "Queue A item 10",
    ("executor", "zoo-oracle"): "Queue A item 9",
    ("executor", "zoo-device"): "Queue A item 9",
    ("policy", "rtdeepiot-zoo"): "Queue A item 9",
    ("policy", "rtdeepiot-adaptive"): "Queue A item 9",
    ("source", "traffic"): "Queue A item 9",
    ("source", "replay"): "Queue A item 9",
    ("source", "frontdoor"): "Queue A item 9",
    ("source", "durable"): "Queue A item 9",
}


@dataclasses.dataclass
class BuildContext:
    """Everything a component factory may need besides its own args."""
    spec: Any                           # the ServeSpec being built
    resources: dict                     # caller-supplied runtime objects
    time_model: Any = None              # BatchTimeModel (set before factories)
    max_batch: Optional[int] = None
    policy: Any = None                  # set before executor/source factories
    clock: Any = None                   # set before executor/source factories
    executor: Any = None                # set before source factories
    task_factory: Optional[Callable] = None   # (Request, now) -> Task
    stream: Any = None                  # materialized (offset, Request) list


def register(kind: str, name: str, factory: Callable = None):
    """Register ``factory`` under ``name``; usable as a decorator."""
    if kind not in KINDS:
        raise KeyError(f"unknown registry kind {kind!r}; kinds: {KINDS}")

    def deco(fn):
        _REGISTRY[kind][str(name)] = fn
        return fn
    return deco(factory) if factory is not None else deco


def register_policy(name, factory=None):
    return register("policy", name, factory)


def register_executor(name, factory=None):
    return register("executor", name, factory)


def register_clock(name, factory=None):
    return register("clock", name, factory)


def register_source(name, factory=None):
    return register("source", name, factory)


def resolve(kind: str, name: str) -> Callable:
    """The factory registered for ``name`` (KeyError lists what exists)."""
    if name not in _REGISTRY.get(kind, {}) and (kind, name) in NOT_PORTED:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to repro_torch yet "
            f"(ROADMAP {NOT_PORTED[(kind, name)]})")
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(f"no {kind} registered under {name!r}; "
                       f"available: {available(kind)}") from None


def available(kind: str) -> list:
    return sorted(_REGISTRY[kind])


# ---------------------------------------------------------------------------
# built-in policies
# ---------------------------------------------------------------------------

def _predictor_from(args: dict, ctx: BuildContext):
    from repro_torch.core.utility import make_predictor
    name = args.get("predictor", "exp")
    if name == "oracle":
        return make_predictor("oracle",
                              oracle_table=ctx.resources["conf_table"])
    prior = args.get("prior_curve")
    if prior is None:
        prior = ctx.resources["conf_table"].mean(0)
    return make_predictor(name, prior_curve=prior)


@register_policy("rtdeepiot")
def _make_rtdeepiot(args: dict, ctx: BuildContext):
    """The paper's scheduler.  args: ``predictor`` (exp/max/lin/oracle),
    ``prior_curve`` (list; default: conf_table.mean(0)), ``delta``."""
    from repro_torch.core.schedulers import RTDeepIoT
    return RTDeepIoT(_predictor_from(args, ctx),
                     delta=float(args.get("delta", 0.1)))


@register_policy("rtdeepiot-weighted")
def _make_rtdeepiot_weighted(args: dict, ctx: BuildContext):
    """SLO-weighted RTDeepIoT: the FPTAS objective weighted by
    ``Task.weight`` (as the base planner already is) *plus* weight-aware
    dispatch tie-breaks and batch seating — gold-class requests win
    contended utility under overload.  Same args as ``rtdeepiot``."""
    from repro_torch.core.schedulers import WeightedRTDeepIoT
    return WeightedRTDeepIoT(_predictor_from(args, ctx),
                             delta=float(args.get("delta", 0.1)))


@register_policy("edf")
def _make_edf(args, ctx):
    from repro_torch.core.schedulers import EDF
    return EDF()


@register_policy("lcf")
def _make_lcf(args, ctx):
    from repro_torch.core.schedulers import LCF
    return LCF()


@register_policy("rr")
def _make_rr(args, ctx):
    from repro_torch.core.schedulers import RR
    return RR()


# ---------------------------------------------------------------------------
# built-in clocks
# ---------------------------------------------------------------------------

@register_clock("virtual")
def _make_virtual(args, ctx):
    from repro_torch.serving.runtime.clock import VirtualClock
    return VirtualClock(charge_overhead=ctx.spec.charge_overhead)


@register_clock("wall")
def _make_wall(args, ctx):
    from repro_torch.serving.runtime.clock import WallClock
    return WallClock(max_sleep=float(args.get("max_sleep", 0.005)))


# ---------------------------------------------------------------------------
# built-in executors
# ---------------------------------------------------------------------------

@register_executor("oracle")
def _make_oracle(args, ctx):
    from repro_torch.serving.runtime.executor import OracleExecutor
    # pipeline_depth >= 3 enqueues depth-1 virtual device windows, same
    # scaling as the device executors (one running + the rest queued)
    return OracleExecutor(
        ctx.time_model, ctx.resources["conf_table"],
        max_inflight=max(1, int(ctx.spec.pipeline_depth) - 1))


# ---------------------------------------------------------------------------
# built-in sources
# ---------------------------------------------------------------------------

@register_source("closed-loop")
def _make_closed_loop(args, ctx):
    """The §IV K-client workload.  resources: workload (or build one from
    args: n_clients/d_lo/d_hi/n_requests/seed/mandatory_stages) +
    conf_table (sample count)."""
    from repro_torch.core.simulator import Workload
    from repro_torch.serving.runtime.sources import ClosedLoopSource
    wl = ctx.resources.get("workload")
    if wl is None:
        wl = Workload(**args)
    n_samples = ctx.resources["conf_table"].shape[0]
    return ClosedLoopSource(wl, n_samples, ctx.time_model.single_times())


@register_source("stream")
def _make_stream(args, ctx):
    """Pre-materialized (offset, Request) list — passed to ``Service.run``
    or as the ``requests`` resource."""
    from repro_torch.serving.runtime.sources import StreamSource
    stream = ctx.stream if ctx.stream is not None \
        else ctx.resources.get("requests", [])
    return StreamSource(stream, ctx.task_factory)


@register_source("live")
def _make_live(args, ctx):
    """``Service.submit`` queue (wall clock: background engine thread;
    virtual clock: buffered until ``drain``)."""
    from repro_torch.serving.service import LiveSource
    return LiveSource(ctx.task_factory, ctx.clock,
                      poll=float(args.get("poll", 0.002)))
