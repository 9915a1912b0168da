"""Anytime-decoding serving launcher: imprecise computation per TOKEN
(``repro.launch.serve``).

The paper's stage shedding applied to autoregressive decode: each token
runs stage 1 (mandatory); deeper stages run only while the exit confidence
is below a target, a deadline-free confidence-driven variant of
RTDeepIoT's depth assignment.

The decode loop runs through the public serving API: each *token* is one
imprecise-computation request served by ``repro_torch.serving.Service``
from a declarative ``ServeSpec``, with three launch-registered components:

* policy ``conf-target`` — assign full depth, stop deepening the moment
  the measured exit confidence reaches the target;
* executor ``decode`` — per-depth :func:`repro_torch.models.decode_step`
  calls, whose attention goes through the decode-attention kernel; with
  ``speculate=True`` (``--pipeline``) the next-deeper step is launched
  before the current depth's confidence is read back, so the host's
  read-and-decide overlaps device compute, and a speculative depth is
  discarded when the target was already met (``decode_step`` never writes
  the cache it is given, so a discarded depth leaves no trace);
* source ``token-loop`` — a closed loop of one token at a time: retiring
  token *t* commits the chosen depth's cache, samples token *t+1* and
  issues it as the next request.

Importing this module also registers ``device-kernel``
(:mod:`repro_torch.launch.kernel`).  ``--dry-run`` validates the spec
against the registry and prints it as JSON without touching the model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --tokens 24

It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
import functools
import math
import time

import numpy as np
import torch

import repro_torch.launch.kernel  # noqa: F401 — registers device-kernel
from repro_torch.core.task import Task
from repro_torch.models import decode_step, init_decode_cache, init_params
from repro_torch.serving.batch.policy import BatchPolicy
from repro_torch.serving.registry import (register_executor, register_policy,
                                          register_source)
from repro_torch.serving.service import ServeSpec, Service


# ---------------------------------------------------------------------------
# launch-registered serving components
# ---------------------------------------------------------------------------

@register_policy("conf-target")
def _make_conf_target(args, ctx):
    """Deadline-free depth governor: run deeper only while the measured
    exit confidence is below ``target``."""
    class _ConfTarget(BatchPolicy):
        name = "conf-target"

        def __init__(self, target):
            super().__init__()
            self.target = target

        def on_arrival(self, active, task, now):
            task.assigned_depth = task.clamp_depth(task.num_stages)

        def on_stage_done(self, active, task, now):
            c = task.last_confidence
            if c is not None and c >= self.target:
                task.assigned_depth = task.executed      # stop deepening

        def next_batch(self, active, now):
            r = self._runnable(active, now)
            if not r:
                return None
            t = min(r, key=lambda x: x.tid)
            return t.executed, [t]

    return _ConfTarget(float(args.get("target", 0.7)))


class DecodeExecutor:
    """Per-depth decode steps behind the runtime Executor contract.

    Depth *d*'s "stage" recomputes the token at depth d+1 from the current
    cache.  ``submit`` launches the step and records a CUDA event after it
    (PyTorch launches asynchronously); ``complete`` waits on that event
    where the JAX package calls ``block_until_ready``.  With ``speculate``
    the next-deeper step is launched after the event, before the current
    depth's confidence is read back.  On the CPU the step runs inside
    ``submit`` and there is no event.
    """

    def __init__(self, steps, params, cache, tok, *, speculate=False):
        self.steps = steps
        self.params = params
        self.cache = cache
        self.tok = tok
        self.speculate = speculate
        self.total_busy = 0.0
        self.speculated = 0          # deeper steps launched speculatively
        self.spec_hits = 0           # ... that the schedule then consumed
        self._running = None
        self._spec = None            # (token, stage, out, new_cache, event)
        self._done = None
        self.chosen = None           # (out, new_cache) of the last commit

    # -- Executor contract ---------------------------------------------
    @property
    def busy(self):
        return self._running is not None

    def wcet(self, stage, n):
        return 0.0

    def _record(self):
        if self.tok.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.tok.device))
        return event

    def submit(self, stage, tasks, now):
        task = tasks[0]
        pos = torch.full((self.tok.shape[0],), task.sample, dtype=torch.int32,
                         device=self.tok.device)
        if self._spec is not None and self._spec[:2] == (task.sample, stage):
            out, new_cache, event = self._spec[2:]
            self.spec_hits += 1
        else:
            out, new_cache = self.steps[stage](self.params, self.cache,
                                               self.tok, pos)
            event = self._record()
        self._spec = None
        if self.speculate and stage + 1 < len(self.steps):
            o2, c2 = self.steps[stage + 1](self.params, self.cache, self.tok,
                                           pos)
            self._spec = (task.sample, stage + 1, o2, c2, self._record())
            self.speculated += 1
        self._running = (stage, tasks, out, new_cache, event, now)

    def finish_time(self):
        return None if self.busy else math.inf

    def complete(self, clock):
        stage, tasks, out, new_cache, event, t0 = self._running
        self._running = None
        if event is not None:
            event.synchronize()
        self.total_busy += clock.now() - t0
        self._done = (out, new_cache)
        return stage, tasks

    def commit(self, task, k):
        self.chosen = self._done
        return float(self._done[0].confidences[-1].mean())

    def running_tasks(self):
        return list(self._running[1]) if self._running is not None else []


@register_executor("decode")
def _make_decode(args, ctx):
    r = ctx.resources
    return DecodeExecutor(r["steps"], r["params"], r["cache"], r["tok"],
                          speculate=bool(args.get("speculate", False)))


class TokenLoopSource:
    """Closed loop of one token request at a time: retiring token *t*
    commits the chosen depth's cache, lets the ``advance`` callback sample
    token *t+1*, and issues it as the next request."""

    def __init__(self, n_tokens, n_stages, executor, advance):
        self.n_tokens = n_tokens
        self.n_stages = n_stages
        self.executor = executor
        self.advance = advance
        self._next = 0
        self._ready = n_tokens > 0
        self._issue_time = 0.0

    def has_pending(self):
        return self._ready

    def next_time(self):
        return self._issue_time if self._ready else math.inf

    def pop(self, now):
        self._ready = False
        return Task(arrival=now, deadline=math.inf,
                    stage_times=(0.0,) * self.n_stages, mandatory=1,
                    sample=self._next)

    def on_retire(self, task, now):
        out, new_cache = self.executor.chosen
        self.executor.cache = new_cache
        self.executor.tok = self.advance(task, out)
        self._next += 1
        if self._next < self.n_tokens:
            self._ready = True
            self._issue_time = now


@register_source("token-loop")
def _make_token_loop(args, ctx):
    return TokenLoopSource(int(args["n_tokens"]), int(args["n_stages"]),
                           ctx.executor, ctx.resources["advance"])


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def build_spec(args, n_stages: int) -> ServeSpec:
    """The launcher's serving configuration, declared once."""
    return ServeSpec(
        policy="conf-target", policy_args={"target": args.conf_target},
        executor="decode", executor_args={"speculate": bool(args.pipeline)},
        clock="wall", source="token-loop",
        source_args={"n_tokens": args.tokens, "n_stages": n_stages},
        batching={"mode": "none", "stage_times": [0.0] * n_stages})


def _step(cfg, upto_stage, params, cache, tok, pos):
    return decode_step(cfg, params, cache, tok, pos, upto_stage=upto_stage)


def make_steps(cfg, n_stages: int) -> list:
    """One decode step per depth 1..n_stages: the engine's dispatch units,
    ``steps[d - 1](params, cache, tok, pos) -> (ExitsOut, new_cache)``."""
    return [functools.partial(_step, cfg, d) for d in range(1, n_stages + 1)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--conf-target", type=float, default=0.7)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--pipeline", action="store_true",
                    help="speculatively launch the next-deeper step "
                         "before reading the current confidence (async "
                         "host/device overlap)")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate + print the ServeSpec (registry check) "
                         "without touching the model")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch).reduced()
    if cfg.modality == "features":
        raise SystemExit("classifier serving lives in chip_smoke.py's serve "
                         "phase (Service -> device-kernel)")
    n_stages = len(cfg.stage_boundaries())
    spec = build_spec(args, n_stages)
    if args.dry_run:
        spec.validate()
        print(spec.to_json(indent=1))
        print(f"DRY RUN OK: {args.arch} ({n_stages} stages, "
              f"{args.tokens} tokens) resolves through the registry")
        return spec
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt: reading the JAX package's msgpack checkpoints is not "
            "ported to repro_torch yet (ROADMAP Queue A item 1)")

    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    B = args.batch
    cache = init_decode_cache(cfg, B, slots=args.tokens + 1,
                              device=args.device)
    tok = torch.zeros(B, dtype=torch.int32, device=args.device)
    depth_hist = np.zeros(n_stages, np.int64)

    def advance(task, out):
        """Token transition: record depth, print, sample the next token."""
        d = task.executed
        depth_hist[d - 1] += 1
        print(f"token {task.sample:3d}: depth={d} "
              f"conf={task.last_confidence:.3f}")
        return out.logits[-1].argmax(-1).to(torch.int32)

    svc = Service.from_spec(spec, steps=make_steps(cfg, n_stages),
                            params=params, cache=cache, tok=tok,
                            advance=advance)
    t0 = time.time()
    met = svc.run()
    dt = time.time() - t0
    svc.close()
    ex = svc.executor
    if args.pipeline:
        print(f"pipelined decode: {ex.speculated - ex.spec_hits} speculative "
              f"deeper steps dispatched and discarded "
              f"({ex.spec_hits} consumed)")
    print(f"\n{args.tokens} tokens in {dt:.1f}s; depth histogram "
          f"{depth_hist.tolist()} (mean {met.mean_depth:.2f} "
          f"of {n_stages}) — stages shed: "
          f"{1 - depth_hist @ np.arange(1, n_stages+1) / (args.tokens * n_stages):.0%} compute saved")
    return met


if __name__ == "__main__":
    main()
