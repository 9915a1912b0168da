"""The claims of ``tests/test_system.py`` on the port: train the anytime
classifier on the CPU with the reference test's recipe (250 steps, batch
128, the same data seeds; the port's params from ``torch.Generator`` seed
0), then check what it claims about the model on the trained tables.

The scheduling claim (RTDeepIoT at least the best baseline) fails in the
reference itself (ROADMAP C-ref 2), so it is not asserted here.  What is
held instead: on the port's trained tables, the port's ``simulate`` gives
the JAX ``simulate``'s accuracy, miss rate, mean depth and per-request
records (all but the process-wide task id) for RTDeepIoT, EDF, LCF and RR
bit for bit.
"""
import warnings

import pytest
import torch

from repro.core import EDF as JaxEDF
from repro.core import LCF as JaxLCF
from repro.core import RR as JaxRR
from repro.core import RTDeepIoT as JaxRTDeepIoT
from repro.core import Workload as JaxWorkload
from repro.core import make_predictor as jax_make_predictor
from repro.core import simulate as jax_simulate
from repro_torch.configs import get_config
from repro_torch.core import (EDF, LCF, RR, RTDeepIoT, Workload,
                              make_predictor, simulate)
from repro_torch.models import init_params
from repro_torch.serving import deprecation
from repro_torch.training import (AdamW, DifficultyDataset,
                                  eval_exit_metrics, make_train_step,
                                  warmup_cosine)


@pytest.fixture(scope="module")
def trained():
    """A quickly-trained anytime classifier + its oracle tables."""
    cfg = get_config("anytime-classifier")
    ds = DifficultyDataset(num_classes=cfg.vocab_size, seed=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, 250))
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, exit_weights=(0.2, 0.3, 0.5))
    for i in range(250):
        b = ds.sample(128, seed=50_000 + i)
        params, opt_state, m = step(params, opt_state,
                                    {"inputs": b["inputs"],
                                     "labels": b["labels"]})
    test = ds.sample(600, seed=123_456)
    metrics = eval_exit_metrics(cfg, params, test)
    return cfg, params, test, metrics


def test_training_learns_task(trained):
    _, _, _, m = trained
    assert m["correct"][:, -1].mean() > 0.35      # >> 10% chance


def test_confidence_correlates_with_correctness(trained):
    """Mean confidence of correct predictions exceeds that of incorrect
    ones by 0.02 at every stage that has both (the reference's guard,
    ``(~c).any() is False``, never holds; this one skips a stage whose
    samples are all right or all wrong)."""
    _, _, _, m = trained
    checked = 0
    for s in range(m["correct"].shape[1]):
        c, conf = m["correct"][:, s], m["confidence"][:, s]
        if c.all() or not c.any():
            continue
        assert conf[c].mean() > conf[~c].mean() + 0.02
        checked += 1
    assert checked > 0


def test_difficulty_drives_depth_utility(trained):
    """Easy samples (short chains) are solved earlier than hard ones."""
    _, _, test, m = trained
    easy = test["difficulty"] <= 2
    hard = test["difficulty"] >= 7
    assert m["correct"][easy, 0].mean() > m["correct"][hard, 0].mean() + 0.1


POLICIES = {
    "rtdeepiot": (lambda conf: JaxRTDeepIoT(jax_make_predictor(
        "exp", prior_curve=conf.mean(0))),
                  lambda conf: RTDeepIoT(make_predictor(
                      "exp", prior_curve=conf.mean(0)))),
    "edf": (lambda conf: JaxEDF(), lambda conf: EDF()),
    "lcf": (lambda conf: JaxLCF(), lambda conf: LCF()),
    "rr": (lambda conf: JaxRR(), lambda conf: RR()),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_simulate_matches_jax_on_the_trained_tables(trained, policy):
    _, _, _, m = trained
    conf, correct = m["confidence"], m["correct"]
    times = (0.007, 0.007, 0.007)
    wl = dict(n_clients=20, d_lo=0.01, d_hi=0.2, n_requests=400)
    make_jax, make_port = POLICIES[policy]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax_simulate(make_jax(conf), JaxWorkload(**wl), times, conf,
                            correct)
        got = simulate(make_port(conf), Workload(**wl), times, conf, correct)
    assert got.n_requests == want.n_requests == 400
    assert (got.accuracy, got.miss_rate, got.mean_depth, got.mean_conf,
            got.makespan) == (want.accuracy, want.miss_rate,
                              want.mean_depth, want.mean_conf,
                              want.makespan)
    # every field of every request record but ``tid``, a process-wide
    # task counter that depends on how many tasks the process made before
    def records(res):
        return [{k: v for k, v in r.items() if k != "tid"}
                for r in res.per_request]
    assert records(got) == records(want)


def test_simulate_warns_once(trained):
    _, _, _, m = trained
    deprecation._reset()
    wl = Workload(n_clients=2, d_lo=0.1, d_hi=0.2, n_requests=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            simulate(EDF(), wl, (0.007,) * 3, m["confidence"], m["correct"])
    msgs = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1
    assert "ServeSpec" in str(msgs[0].message)
