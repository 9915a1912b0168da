"""Near-optimal depth assignment — paper §II-C, Algorithm 1.

Dynamic program over (task index sorted by deadline, quantized cumulative
reward).  P(i, r) = least cumulative execution time for the top-i
earliest-deadline tasks to attain exactly reward r; S(i, r) the argmin depth
choice.  Feasibility of executing task i+1 to depth l requires
P_{i+1}^l + P(i, r̄) <= d_{i+1} - now (prefix property of EDF: tasks run in
deadline order, so the cumulative time of the first i+1 chosen prefixes is
exactly when task i+1 finishes).

FPTAS: with Δ = εR/N the plan is a (1-ε)-approximation (Theorem 1) —
property-tested against brute force in tests/test_dp.py.

Row updates run vectorized over the reward axis in numpy.  `plan()` exposes
Algorithm 1's incremental form: rows for tasks ordered before the first
changed task are reused when the planning instant is unchanged (consecutive
arrivals in a burst); otherwise feasibility thresholds (now-relative slacks)
have moved and the affected suffix is recomputed — the recompute-from-k
structure of Algorithm 1 with k = index of the first change.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INF = np.inf
SKIP = -1  # option index meaning "task contributes nothing" (P(i,r) branch)


@dataclasses.dataclass
class Option:
    depth: int           # resulting depth l
    cost: float          # additional execution time from current state
    reward: float        # predicted R_i^l
    q: int               # quantized reward


def task_options(task, predictor, delta: float):
    """Enumerate depth options for one task (paper's l ∈ {ω_i..L_i} plus the
    already-banked 'stop where we are' option for started tasks).  Rewards
    are importance-weighted (paper §II-A: the metric extends trivially to
    weighted accuracy)."""
    opts = []
    w = float(getattr(task, "weight", 1.0))
    e = task.executed
    if e >= 1:
        r = w * float(task.confidences[e - 1])
        opts.append(Option(e, 0.0, r, int(r / delta)))
        lo = e + 1
    else:
        lo = max(1, task.mandatory)
    for l in range(lo, task.num_stages + 1):
        r = w * float(predictor.predict(task, l))
        opts.append(Option(l, task.remaining_time(l), r, int(r / delta)))
    return opts


class DepthPlanner:
    """Algorithm 1 with traceback."""

    def __init__(self, delta: float = 0.1, rmax: float = 1.0,
                 max_tasks: int = 64):
        self.delta = delta
        self.rmax = rmax
        # fixed table width (Algorithm 1 grows columns with N; a fixed
        # capacity keeps previously computed rows reusable across arrivals)
        self.max_tasks = max_tasks
        self._cache_key: Optional[tuple] = None
        self._rows = []          # list of (P_row, choice_row, options)
        self.row_updates = 0     # instrumentation for the overhead benchmark

    # -- internals -----------------------------------------------------------

    def _signature(self, tasks_sorted, now):
        return (round(now, 9),) + tuple(
            (t.tid, t.executed,
             round(t.confidences[-1], 9) if t.confidences else None)
            for t in tasks_sorted)

    def _update_row(self, prev_P, prev_C, opts, slack, Q):
        P = prev_P.copy()                       # SKIP branch: P(i,r)
        C = np.full(Q + 1, SKIP, np.int32)
        for oi, o in enumerate(opts):
            if o.q == 0:
                shifted = prev_P
            else:
                shifted = np.concatenate([np.full(o.q, INF), prev_P[:Q + 1 - o.q]])
            cand = shifted + o.cost
            if o.cost > 0:                      # executing more: deadline check
                cand = np.where(cand <= slack + 1e-9, cand, INF)
            better = cand < P
            P = np.where(better, cand, P)
            C = np.where(better, oi, C)
        self.row_updates += 1
        return P, C

    # -- API -----------------------------------------------------------------

    def plan(self, tasks, now: float, predictor) -> dict:
        """Returns {tid: depth}.  Tasks with no feasible option (cannot run
        even their mandatory part by the deadline) get depth = executed
        (i.e. dropped if nothing ran yet)."""
        tasks_sorted = sorted(tasks, key=lambda t: (t.deadline, t.tid))
        N = len(tasks_sorted)
        if N == 0:
            self._cache_key = None
            return {}
        wmax = max((getattr(t, "weight", 1.0) for t in tasks_sorted),
                   default=1.0)
        Q = int(max(N, self.max_tasks) * max(1.0, wmax) * self.rmax
                / self.delta)

        sig = self._signature(tasks_sorted, now)
        k = 0
        if self._cache_key is not None and len(self._rows) and \
                sig[0] == self._cache_key[0]:
            old = self._cache_key[1:]
            new = sig[1:]
            while (k < min(len(old), len(new)) and old[k] == new[k]
                   and k < len(self._rows)
                   and len(self._rows[k][0]) == Q + 1):
                k += 1
        self._rows = self._rows[:k]

        prev_P = (self._rows[k - 1][0] if k else
                  np.concatenate([[0.0], np.full(Q, INF)]))
        for i in range(k, N):
            t = tasks_sorted[i]
            opts = task_options(t, predictor, self.delta)
            P, C = self._update_row(prev_P, None, opts, t.slack(now), Q)
            self._rows.append((P, C, opts))
            prev_P = P
        self._cache_key = sig

        # traceback from the best reachable reward (max r, then min time)
        finalP = self._rows[-1][0]
        feasible = np.isfinite(finalP)
        assignment = {}
        if not feasible.any():
            r = 0
        else:
            r = int(np.max(np.nonzero(feasible)[0]))
        for i in range(N - 1, -1, -1):
            P, C, opts = self._rows[i]
            t = tasks_sorted[i]
            ci = int(C[r]) if np.isfinite(P[r]) else SKIP
            if ci == SKIP:
                assignment[t.tid] = t.executed      # nothing more (drop if 0)
            else:
                o = opts[ci]
                assignment[t.tid] = o.depth
                r -= o.q
        return assignment


def brute_force_plan(tasks, now: float, predictor):
    """Exhaustive optimal depth assignment (exponential; tests only).

    Returns (best_total_reward, {tid: depth}).  Uses *exact* (unquantized)
    rewards — the FPTAS bound is asserted against this.
    """
    import itertools

    tasks_sorted = sorted(tasks, key=lambda t: (t.deadline, t.tid))
    choice_sets = []
    for t in tasks_sorted:
        opts = [(t.executed if t.executed else 0, 0.0,
                 float(t.confidences[-1]) if t.executed else 0.0)]
        lo = t.executed + 1 if t.executed else max(1, t.mandatory)
        for l in range(lo, t.num_stages + 1):
            opts.append((l, t.remaining_time(l),
                         float(predictor.predict(t, l))))
        choice_sets.append(opts)
    best = (-1.0, None)
    for combo in itertools.product(*choice_sets):
        cum = 0.0
        reward = 0.0
        ok = True
        for t, (depth, cost, r) in zip(tasks_sorted, combo):
            if cost > 0:
                cum += cost
                if cum > t.slack(now) + 1e-9:
                    ok = False
                    break
            reward += r
        if ok and reward > best[0]:
            best = (reward, {t.tid: d for t, (d, _, _) in
                             zip(tasks_sorted, combo)})
    return best
