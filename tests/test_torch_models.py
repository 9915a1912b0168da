"""The port's anytime-classifier stages against the JAX package's.

The JAX params (from ``repro.models.init_params``) cross to the port
through the weight bridge (``repro_torch.interop``), inputs are numpy
arrays from a seed, and each stage's trunk output, logits, confidence and
fused exit are held together at fp32 atol 1e-5 with identical predictions.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import exit_rows as jax_exit_rows
from repro.models import exit_stats_fused as jax_exit_fused
from repro.models import init_params as jax_init_params
from repro.models import stage_forward as jax_stage_forward
from repro.models import stage_trunk as jax_stage_trunk
from repro_torch.configs import get_config
from repro_torch.interop import from_reference
from repro_torch.models import (exit_rows, exit_stats_fused, init_params,
                                stage_forward, stage_trunk)

ATOL = 1e-5
BATCH = 3


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("anytime-classifier")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("anytime-classifier")
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (BATCH, 16, 32)).astype(np.float32)
    # run the JAX stages once; every test compares against these
    jh, ref = {"features": x}, []
    for s in range(jcfg.num_stages):
        h_trunk = jax_stage_trunk(jcfg, jparams, s, jh, mode="train")
        h, logits, conf = jax_stage_forward(jcfg, jparams, s, jh, mode="train")
        fused = jax_exit_fused(jax_exit_rows(jcfg, h_trunk),
                               jparams["exits"][s]["ln"],
                               jparams["exit_shared"]["w_out"],
                               eps=jcfg.norm_eps)
        ref.append(dict(trunk=np.asarray(h_trunk), h=np.asarray(h),
                        logits=np.asarray(logits), conf=np.asarray(conf),
                        fused=[np.asarray(a) for a in fused]))
        jh = h
    return cfg, params, x, ref


def _port_stages(cfg, params, x):
    h = {"features": torch.from_numpy(x)}
    for s in range(cfg.num_stages):
        trunk = stage_trunk(cfg, params, s, h)
        h_out, logits, conf = stage_forward(cfg, params, s, h)
        yield s, trunk, h_out, logits, conf
        h = h_out


def test_stage_trunk_matches_jax(models):
    cfg, params, x, ref = models
    for s, trunk, *_ in _port_stages(cfg, params, x):
        np.testing.assert_allclose(trunk.numpy(), ref[s]["trunk"], rtol=0,
                                   atol=ATOL)


def test_stage_forward_matches_jax(models):
    cfg, params, x, ref = models
    for s, _trunk, h, logits, conf in _port_stages(cfg, params, x):
        np.testing.assert_allclose(h.numpy(), ref[s]["h"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(logits.numpy(), ref[s]["logits"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(conf.numpy(), ref[s]["conf"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      ref[s]["logits"].argmax(-1))


def test_fused_exit_matches_jax_kernel(models):
    cfg, params, x, ref = models
    for s, trunk, *_ in _port_stages(cfg, params, x):
        conf, pred, m, lse = exit_stats_fused(
            exit_rows(cfg, trunk), params["exits"][s]["ln"],
            params["exit_shared"]["w_out"], eps=cfg.norm_eps)
        jconf, jpred, jm, jlse = ref[s]["fused"]
        np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(pred.numpy(), jpred)
        np.testing.assert_allclose(m.numpy(), jm, rtol=0, atol=1e-4)
        np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=1e-4)


def test_init_params_has_the_bridged_layout(models):
    """The port's own init gives the same tree and shapes as the bridge
    makes of the JAX params, so either feeds the same functions."""
    cfg, bridged, _x, _ref = models
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype, tree.device.type)
    assert shapes(own) == shapes(bridged)
    assert [len(st) for st in own["stages"]] == [1, 2, 3]


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        get_config("xlstm-1.3b")
