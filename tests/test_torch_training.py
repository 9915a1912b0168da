"""The port's training path against the JAX package's, on bridged weights.

The same seeded inputs go through ``repro.training`` and
``repro_torch.training``: the warmup-cosine schedule (the warmup equal,
the decay within ``peak_lr * 2^-22``: the two libraries' fp32 ``cos``
differ by an ulp at some steps), AdamW's
updates and moments (1e-7, clipping active, inactive and off, moments in
fp32 and bf16), the training forward per stage (1e-5), the multi-exit loss
(rtol 1e-5) and every gradient leaf restacked into the JAX tree (atol
1e-5), five train steps (params and both moments 2e-5, loss and grad norm
rtol 1e-5) and ``eval_exit_metrics`` (confidence 1e-5; ``correct`` equal
wherever the top two logits are more than 1e-4 apart).  What the port
lacks raises ``NotImplementedError`` naming its ROADMAP item.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.training import AdamW as JaxAdamW
from repro.training import eval_exit_metrics as jax_eval_exit_metrics
from repro.training import make_loss_fn as jax_make_loss_fn
from repro.training import make_train_step as jax_make_train_step
from repro.training import warmup_cosine as jax_warmup_cosine
from repro_torch.configs import get_config
from repro_torch.interop import from_reference, to_reference
from repro_torch.models import forward
from repro_torch.training import (AdamW, DifficultyDataset,
                                  eval_exit_metrics, make_loss_fn,
                                  make_train_step, warmup_cosine)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

EXIT_WEIGHTS = (0.2, 0.3, 0.5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _max_err(jax_tree, port_ref_tree):
    """Largest abs difference between a JAX tree and the port's tree
    restacked by ``to_reference`` (same structure, numpy leaves)."""
    assert jax.tree.structure(_np_tree(jax_tree)) == \
        jax.tree.structure(port_ref_tree)
    return max(float(np.abs(np.asarray(a, np.float32) - b).max())
               for a, b in zip(jax.tree.leaves(jax_tree),
                               jax.tree.leaves(port_ref_tree)))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("anytime-classifier")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("anytime-classifier")
    params = from_reference(cfg, _np_tree(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batch(n, seed):
    b = DifficultyDataset(num_classes=10, seed=0).sample(n, seed=seed)
    return {"inputs": b["inputs"], "labels": b["labels"]}


@pytest.mark.parametrize("sched", ((3e-3, 40, 700), (3e-3, 20, 250),
                                   (1e-3, 0, 800)))
def test_warmup_cosine_matches_jax(sched):
    steps = np.arange(801, dtype=np.int32)
    want = np.asarray(jax.vmap(jax_warmup_cosine(*sched))(jnp.asarray(steps)))
    got = warmup_cosine(*sched)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    peak, warmup, _ = sched
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    # the decay: one fp32 ulp of cos (<= 2^-23), times 0.45 peak, plus the
    # products' rounding
    np.testing.assert_allclose(got[warmup:], want[warmup:], rtol=0,
                               atol=peak * 2.0 ** -22)


def _opt_tree(rng, scale):
    """A small nested tree (dict keys in sorted order, so both packages
    sum the squared norms in the same order)."""
    return {"a": (scale * rng.normal(size=(4, 6))).astype(np.float32),
            "b": [(scale * rng.normal(size=(5,))).astype(np.float32),
                  {"c": (scale * rng.normal(size=(3, 2))).astype(np.float32)}]}


@pytest.mark.parametrize("state_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("clip", ("active", "inactive", "off"))
def test_adamw_update_matches_jax(clip, state_dtype):
    rng = np.random.default_rng(7)
    params = _opt_tree(rng, 1.0)
    # global norms: about 50 (clipped at 1.0) or about 0.05 (unclipped)
    gscale = {"active": 10.0, "inactive": 0.01, "off": 10.0}[clip]
    clip_norm = None if clip == "off" else 1.0
    kw = dict(weight_decay=0.01, clip_norm=clip_norm, state_dtype=state_dtype)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(3e-3, 2, 10), **kw)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 2, 10), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, state = jopt.init(jp), opt.init(tp)
    for _ in range(4):
        grads = _opt_tree(rng, gscale)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        tu, state = opt.update(tree_map(torch.from_numpy, grads), state, tp)
        for want, got in ((ju, tu), (jstate.mu, state.mu),
                          (jstate.nu, state.nu)):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                assert str(b.dtype) == f"torch.{a.dtype}"
                np.testing.assert_allclose(b.float().numpy(),
                                           np.asarray(a, np.float32),
                                           rtol=0, atol=1e-7)
    assert int(state.step) == int(jstate.step) == 4


@pytest.mark.parametrize("temperature", (1.0, 0.5))
@pytest.mark.parametrize("upto_stage", (None, 2))
def test_forward_matches_jax_per_stage(models, temperature, upto_stage):
    jcfg, jparams, cfg, params = models
    feats = _batch(16, seed=3)["inputs"]["features"]
    want = jax_forward(jcfg, jparams, {"features": feats}, mode="train",
                       upto_stage=upto_stage, conf_temperature=temperature)
    got = forward(cfg, params, {"features": torch.from_numpy(feats)},
                  upto_stage=upto_stage, conf_temperature=temperature)
    assert len(got.logits) == len(want.logits) == (upto_stage or 3)
    for a, b in zip(want.logits + want.confidences,
                    got.logits + got.confidences):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(got.h_final.numpy(), np.asarray(want.h_final),
                               rtol=0, atol=1e-5)
    assert float(got.aux) == float(want.aux) == 0.0


@pytest.mark.parametrize("weights", (EXIT_WEIGHTS, None))
def test_loss_and_gradients_match_jax(models, weights):
    jcfg, jparams, cfg, params = models
    batch = _batch(32, seed=4)
    jloss, jgrads = jax.value_and_grad(
        jax_make_loss_fn(jcfg, exit_weights=weights))(jparams, batch)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = make_loss_fn(cfg, exit_weights=weights)(
        tree_unflatten(params, live), batch)
    grads = tree_unflatten(params, torch.autograd.grad(loss, live))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert _max_err(jgrads, to_reference(cfg, grads)) <= 1e-5


def test_five_train_steps_match_jax(models):
    jcfg, jparams, cfg, params = models
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(3e-3, 2, 5),
                    weight_decay=0.01)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 2, 5), weight_decay=0.01)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, exit_weights=EXIT_WEIGHTS))
    step = make_train_step(cfg, opt, exit_weights=EXIT_WEIGHTS)
    jstate, state = jopt.init(jparams), opt.init(params)
    jp, tp = jparams, params
    for i in range(5):
        batch = _batch(64, seed=10_000 + i)
        jp, jstate, jm = jstep(jp, jstate, batch)
        tp, state, m = step(tp, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert _max_err(jp, to_reference(cfg, tp)) <= 2e-5
    assert _max_err(jstate.mu, to_reference(cfg, state.mu)) <= 2e-5
    assert _max_err(jstate.nu, to_reference(cfg, state.nu)) <= 2e-5
    assert int(state.step) == int(jstate.step) == 5


def test_train_step_leaves_its_params_as_given(models):
    _, _, cfg, params = models
    before = [p.clone() for p in tree_leaves(params)]
    opt = AdamW(learning_rate=1e-2)
    new, _, _ = make_train_step(cfg, opt)(params, opt.init(params),
                                          _batch(8, seed=5))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(new)))
    assert not any(p.requires_grad for p in tree_leaves(new))


@pytest.mark.parametrize("temperature", (1.0, 0.7))
def test_eval_exit_metrics_matches_jax(models, temperature):
    jcfg, jparams, cfg, params = models
    test = DifficultyDataset(num_classes=10, seed=0).sample(150, seed=999)
    want = jax_eval_exit_metrics(jcfg, jparams, test, temperature=temperature)
    got = eval_exit_metrics(cfg, params, test, temperature=temperature)
    assert got["correct"].shape == got["confidence"].shape == (150, 3)
    assert got["correct"].dtype == bool
    assert got["confidence"].dtype == np.float32
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               rtol=0, atol=1e-5)
    logits = jax_forward(jcfg, jparams, test["inputs"], mode="train").logits
    for s, lg in enumerate(logits):
        top2 = np.sort(np.asarray(lg), -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got["correct"][clear, s],
                                      want["correct"][clear, s])


@pytest.mark.parametrize("kwargs,item", (
    ({"ctx": object()}, "Queue A item 10"),
    ({"aux_exit_stride": 2}, "Queue A item 12")))
def test_unported_loss_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        make_loss_fn(get_config("anytime-classifier"), **kwargs)


def test_text_training_is_not_ported():
    cfg = get_config("qwen3-4b").reduced()
    params = from_reference(
        cfg, _np_tree(jax_init_params(jax_get_config("qwen3-4b").reduced(),
                                      jax.random.PRNGKey(0))), device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        forward(cfg, params, {"tokens": tokens})
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        make_loss_fn(cfg)(params, {"inputs": {"tokens": tokens},
                                   "labels": tokens})
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        make_loss_fn(dataclasses.replace(cfg, mtp=True))
