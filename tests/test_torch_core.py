"""The port's scheduling core against the JAX package's, on seeded inputs.

``repro_torch.core`` is a copy of ``repro.core``; these tests run both on
the same instances and hold them to the claims of ``tests/test_scheduler.py``:
the exp, max and lin utility predictors (point predictions and whole
curves, equal), Algorithm 1's ``DepthPlanner`` (the FPTAS plan, equal, and
within (1 - eps) of ``brute_force_plan``'s optimum; the incremental plan
equal to a fresh one), Eq. 7's ``greedy_update`` (the same swap and
depths) and the weighted planner.  Tasks are made in both packages from
the same numbers; plans are compared in the tasks' order, since task ids
come from each package's own counter.
"""
import numpy as np
import pytest

from repro import core as jax_core
from repro_torch import core

PRIOR = [0.5, 0.75, 0.875]
PACKAGES = (core, jax_core)


def _spec(rng, i, *, partial=0.4, max_stages=3):
    """The numbers of one random task (``test_fptas_bound_property``'s
    distribution, weights drawn from {1, 2, 3})."""
    L = int(rng.integers(1, max_stages + 1))
    spec = dict(deadline=float(rng.uniform(0.02, 0.6)),
                times=tuple(float(x) for x in rng.uniform(0.01, 0.1, L)),
                sample=i, executed=0, confs=[],
                weight=float(rng.choice([1.0, 2.0, 3.0])))
    if rng.uniform() < partial:
        spec["executed"] = 1
        spec["confs"] = [float(rng.uniform(0.2, 0.9))]
    return spec


def _task(pkg, spec, weighted=False):
    t = pkg.Task(arrival=0.0, deadline=spec["deadline"],
                 stage_times=spec["times"], mandatory=1,
                 sample=spec["sample"])
    t.executed = spec["executed"]
    t.confidences = list(spec["confs"])
    if "assigned" in spec:
        t.assigned_depth = spec["assigned"]
    if weighted:
        t.weight = spec["weight"]
    return t


def _instance(seed, n, **kw):
    rng = np.random.default_rng(seed)
    return [_spec(rng, i, **kw) for i in range(n)]


@pytest.mark.parametrize("name", ("exp", "max", "lin"))
def test_predictors_match_jax(name):
    specs = _instance(11, 24, partial=0.6)
    for spec in specs:
        spec["executed"] = len(spec["confs"])
    preds = [pkg.make_predictor(name, prior_curve=PRIOR) for pkg in PACKAGES]
    for spec in specs:
        tasks = [_task(pkg, spec) for pkg in PACKAGES]
        for depth in range(0, len(spec["times"]) + 1):
            got, want = (p.predict(t, depth) for p, t in zip(preds, tasks))
            assert got == want, (spec, depth)
        got, want = (p.curve(t) for p, t in zip(preds, tasks))
        np.testing.assert_array_equal(got, want)
        assert np.all(np.diff(got) >= -1e-9)        # monotone curves


def test_predictor_claims_hold_on_the_port():
    """``tests/test_scheduler.py``'s worked examples, on the port."""
    def mk(times, confs):
        return _task(core, dict(deadline=1.0, times=tuple(times), sample=0,
                                executed=len(confs), confs=confs))
    p = core.ExpIncrease(PRIOR)
    t = mk([0.1] * 4, [0.4, 0.6])
    assert [p.predict(t, d) for d in (2, 3, 4)] == \
        pytest.approx([0.6, 0.8, 0.9])
    p = core.MaxIncrease(PRIOR)
    t = mk([0.1] * 3, [0.3])
    assert [p.predict(t, d) for d in (1, 2, 3)] == \
        pytest.approx([0.3, 1.0, 1.0])
    p = core.LinIncrease(PRIOR)
    t = mk([0.1, 0.1, 0.2], [0.4])
    assert [p.predict(t, d) for d in (2, 3)] == pytest.approx([0.8, 1.0])


def _plan(pkg, specs, delta, *, weighted=False, planner=None):
    tasks = [_task(pkg, s, weighted) for s in specs]
    pred = pkg.make_predictor("exp", prior_curve=PRIOR)
    planner = planner or pkg.DepthPlanner(delta=delta)
    plan = planner.plan(tasks, 0.0, pred)
    return tasks, pred, [plan[t.tid] for t in tasks]


@pytest.mark.parametrize("seed", range(6))
def test_fptas_plan_matches_jax_and_bound(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 5))
    eps = float(rng.choice([0.05, 0.1, 0.25]))
    specs = _instance(seed, n)
    tasks, pred, depths = _plan(core, specs, eps / n)
    _, _, want = _plan(jax_core, specs, eps / n)
    assert depths == want
    reward = sum(pred.predict(t, d) for t, d in zip(tasks, depths) if d > 0)
    opt, best = core.brute_force_plan(tasks, 0.0, pred)
    jtasks = [_task(jax_core, s) for s in specs]
    jopt, jbest = jax_core.brute_force_plan(
        jtasks, 0.0, jax_core.make_predictor("exp", prior_curve=PRIOR))
    assert opt == jopt
    assert [best[t.tid] for t in tasks] == [jbest[t.tid] for t in jtasks]
    assert reward >= (1 - eps) * opt - 1e-9
    # chosen depths run as EDF prefixes within their deadlines
    cum = 0.0
    for t, d in sorted(zip(tasks, depths), key=lambda p: p[0].deadline):
        if d > t.executed:
            cum += t.remaining_time(d)
            assert cum <= t.deadline + 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_incremental_plan_matches_fresh_and_jax(seed):
    rng = np.random.default_rng(seed)
    specs = [dict(deadline=float(rng.uniform(0.05, 0.5)),
                  times=tuple(float(x) for x in rng.uniform(0.01, 0.08, 3)),
                  sample=i, executed=0, confs=[]) for i in range(6)]
    planners = {pkg: pkg.DepthPlanner(delta=0.1) for pkg in PACKAGES}
    preds = {pkg: pkg.make_predictor("exp", prior_curve=PRIOR)
             for pkg in PACKAGES}
    tasks = {pkg: [] for pkg in PACKAGES}
    for spec in specs:
        plans = []
        for pkg in PACKAGES:
            tasks[pkg].append(_task(pkg, spec))
            inc = planners[pkg].plan(tasks[pkg], 0.0, preds[pkg])
            fresh = pkg.DepthPlanner(delta=0.1).plan(tasks[pkg], 0.0,
                                                     preds[pkg])
            assert inc == fresh
            plans.append([inc[t.tid] for t in tasks[pkg]])
        assert plans[0] == plans[1]


@pytest.mark.parametrize("seed", range(6))
def test_greedy_update_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    specs = []
    for i in range(4):
        times = tuple(float(x) for x in rng.uniform(0.01, 0.08, 3))
        specs.append(dict(deadline=float(rng.uniform(0.1, 0.5)), times=times,
                          sample=i, executed=1,
                          confs=[float(rng.uniform(0.1, 0.98))],
                          assigned=int(rng.integers(1, 4)),
                          weight=float(rng.choice([1.0, 2.0]))))
    specs[0]["assigned"] = 3                 # J_1 has stages to give away
    out = []
    for pkg in PACKAGES:
        ts = [_task(pkg, s, weighted=True) for s in specs]
        swapped = pkg.greedy_update(ts[0], ts[1:],
                                    pkg.make_predictor("exp",
                                                       prior_curve=PRIOR))
        out.append((swapped, [t.assigned_depth for t in ts]))
    assert out[0] == out[1]


def test_greedy_claims_hold_on_the_port():
    """``tests/test_scheduler.py``'s three greedy cases, on the port."""
    p = core.make_predictor("exp", prior_curve=PRIOR)

    def mk(deadline, times, conf, assigned):
        return _task(core, dict(deadline=deadline, times=tuple(times),
                                sample=0, executed=1, confs=[conf],
                                assigned=assigned))
    cur, other = mk(0.2, [0.05] * 3, 0.96, 3), mk(0.4, [0.05] * 3, 0.3, 1)
    assert core.greedy_update(cur, [other], p)
    assert cur.assigned_depth == 1 and other.assigned_depth >= 2
    cur, other = mk(0.2, [0.05] * 3, 0.3, 3), mk(0.4, [0.05] * 3, 0.96, 1)
    assert not core.greedy_update(cur, [other], p)
    assert cur.assigned_depth == 3
    cur = mk(0.2, [0.01, 0.01, 0.01], 0.9, 2)
    other = mk(0.4, [0.01, 0.5, 0.5], 0.1, 1)
    assert not core.greedy_update(cur, [other], p)


@pytest.mark.parametrize("seed", range(4))
def test_weighted_plan_matches_jax(seed):
    specs = _instance(200 + seed, 4, partial=0.0)
    tasks, pred, depths = _plan(core, specs, 0.02, weighted=True)
    assert depths == _plan(jax_core, specs, 0.02, weighted=True)[2]
    reward = sum(t.weight * pred.predict(t, d)
                 for t, d in zip(tasks, depths) if d > 0)
    # the weighted optimum by exhaustive search over EDF prefixes
    order = sorted(tasks, key=lambda t: t.deadline)
    best = 0.0
    for combo in np.ndindex(*(t.num_stages + 1 for t in order)):
        cum, rew = 0.0, 0.0
        for t, d in zip(order, combo):
            if d > 0:
                cum += t.cum_time(d)
                if cum > t.deadline:
                    break
                rew += t.weight * pred.predict(t, d)
        else:
            best = max(best, rew)
    assert reward >= (1 - 0.15) * best - 1e-9


def test_weighted_task_wins_contention_on_the_port():
    p = core.make_predictor("exp", prior_curve=PRIOR)
    spec = dict(deadline=0.16, times=(0.15,) * 3, executed=1, confs=[0.5])
    a = _task(core, dict(spec, sample=0))
    b = _task(core, dict(spec, sample=1, weight=3.0), weighted=True)
    plan = core.DepthPlanner(delta=0.01).plan([a, b], 0.0, p)
    assert plan[b.tid] == 2 and plan[a.tid] == 1
