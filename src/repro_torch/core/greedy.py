"""Greedy depth reassignment on confidence updates — paper §II-E, Eq. (7).

When the current task J_1 finishes a stage and its measured confidence makes
the previous depth assignment look suboptimal, a full DP recompute is too
cumbersome (it would touch every later row).  Instead: try to hand J_1's
remaining time budget to the single task whose extra stages buy the most
predicted reward within that budget; swap iff its gain beats J_1's own
predicted residual gain.
"""
from __future__ import annotations


def greedy_update(current, others, predictor) -> bool:
    """Mutates assigned_depth in place.  Returns True if a swap happened.

    current: the task that just finished a stage (earliest deadline, J_1).
    others: remaining active tasks (J_2..J_N) with valid assigned_depth.
    """
    l1 = current.executed
    l1_star = current.assigned_depth
    if l1_star <= l1:
        return False
    budget = sum(current.stage_times[l1:l1_star])      # Σ p_1l, l=l_1+1..l_1*
    w_cur = float(getattr(current, "weight", 1.0))
    gain_current = w_cur * (predictor.predict(current, l1_star)
                            - predictor.predict(current, l1))

    best_gain, best_task, best_depth = 0.0, None, None
    for t in others:
        w_t = float(getattr(t, "weight", 1.0))
        li_star = max(t.assigned_depth, t.executed)
        base = predictor.predict(t, li_star) if li_star >= 1 else 0.0
        add_time = 0.0
        for l in range(li_star + 1, t.num_stages + 1):
            add_time += t.stage_times[l - 1]
            if add_time > budget + 1e-12:
                break
            gain = w_t * (predictor.predict(t, l) - base)
            if gain > best_gain:
                best_gain, best_task, best_depth = gain, t, l

    if best_task is not None and best_gain > gain_current + 1e-12:
        current.assigned_depth = l1                     # stop J_1 here
        best_task.assigned_depth = best_depth
        return True
    return False
