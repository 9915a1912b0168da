"""Utility (confidence) prediction for future stages — paper §II-D.

Given a task's measured exit confidences so far, predict R_i^l for deeper
stages.  The three paper heuristics plus the oracle:

  Max:  R^{l+1} = 1                     (favors lowest-confidence tasks)
  Exp:  R^{l+1} = R^l + 0.5 (1 - R^l)   (paper's best performer)
  Lin:  R^{l+1} = min(1, R^l * P^{l+1}/P^l)
  Oracle: true confidence of every stage, known a priori (upper bound)

For a task that has not yet executed any stage there is no measured
confidence; predictors seed from a *prior curve* (mean per-stage confidence
on the training set — available to the serving system from calibration).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class UtilityPredictor:
    name = "base"

    def __init__(self, prior_curve: Sequence[float]):
        self.prior = np.asarray(prior_curve, np.float64)

    def seed(self, task) -> float:
        """Confidence to extrapolate from (measured, else prior)."""
        if task.confidences:
            return float(task.confidences[-1])
        return float(self.prior[0])

    def predict(self, task, depth: int) -> float:
        """Predicted R_i^depth (depth in 1..L).  Must be non-decreasing in
        depth for depths > executed; equals measured value at executed."""
        raise NotImplementedError

    def curve(self, task) -> np.ndarray:
        """R_i^l for l = 1..L (measured prefix + predicted suffix)."""
        L = task.num_stages
        out = np.zeros(L)
        for l in range(1, L + 1):
            out[l - 1] = self.predict(task, l)
        return out


class ExpIncrease(UtilityPredictor):
    """Each extra stage halves the distance to 1."""
    name = "exp"

    def predict(self, task, depth):
        e = task.executed
        if depth <= e and task.confidences:
            return float(task.confidences[depth - 1])
        if not task.confidences:
            # prior curve value, halving beyond its measured range
            base = float(self.prior[min(depth, len(self.prior)) - 1])
            return base
        c = float(task.confidences[-1])
        j = depth - e
        return 1.0 - (1.0 - c) * 0.5 ** j


class MaxIncrease(UtilityPredictor):
    """Assume the next stage reaches full confidence."""
    name = "max"

    def predict(self, task, depth):
        e = task.executed
        if depth <= e and task.confidences:
            return float(task.confidences[depth - 1])
        if not task.confidences:
            return 1.0 if depth > 1 else float(self.prior[0])
        return 1.0


class LinIncrease(UtilityPredictor):
    """Confidence grows proportionally to cumulative execution time."""
    name = "lin"

    def predict(self, task, depth):
        e = task.executed
        if depth <= e and task.confidences:
            return float(task.confidences[depth - 1])
        c = self.seed(task)
        anchor = max(e, 1)
        p_anchor = task.cum_time(anchor)
        p_depth = task.cum_time(depth)
        if p_anchor <= 0:
            return c
        return float(min(1.0, c * p_depth / p_anchor))


class Oracle(UtilityPredictor):
    """Knows the computed confidence of every stage beforehand (paper's
    unrealizable upper bound).  table: (n_samples, L) true confidences."""
    name = "oracle"

    def __init__(self, table: np.ndarray):
        super().__init__(table.mean(0))
        self.table = np.asarray(table, np.float64)

    def predict(self, task, depth):
        return float(self.table[task.sample, depth - 1])


PREDICTORS = {"exp": ExpIncrease, "max": MaxIncrease, "lin": LinIncrease}


def make_predictor(name: str, prior_curve=None, oracle_table=None):
    if name == "oracle":
        assert oracle_table is not None
        return Oracle(oracle_table)
    if prior_curve is None:
        prior_curve = [0.5]
    return PREDICTORS[name](prior_curve)
