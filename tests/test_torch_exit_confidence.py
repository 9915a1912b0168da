"""The port's exit-confidence function against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and to ``exit_stats_unfused``, with the JAX package's kernel-test
tolerances: conf atol 1e-5, max_logit / lse atol 1e-4, pred exact; in
fp32, and in bf16 as qwen3-4b's exit head holds its inputs.  The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.exit_confidence import exit_confidence as jax_exit_kernel
from repro.models import exit_stats_unfused as jax_exit_unfused
from repro_torch.kernels.exit_confidence import ops
from repro_torch.kernels.exit_confidence.ops import exit_confidence

CONF_ATOL, STAT_ATOL = 1e-5, 1e-4


def _inputs(n, d, v, seed, ties=()):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (0.02 * rng.standard_normal((d, v))).astype(np.float32)
    if ties:
        # the tied columns share the largest logit exactly (one nonzero
        # product), so the first of them must be the argmax
        h[:, 0] = 4.0
        scale[0] = 0.0
        for c in ties:
            w[:, c] = 0.0
            w[0, c] = 1.0
    return h, scale, w


def _port(h, scale, w, temperature=1.0):
    out = exit_confidence(torch.from_numpy(h), torch.from_numpy(scale),
                          torch.from_numpy(w), temperature=temperature)
    return [o.numpy() for o in out]


def _assert_close(port, ref):
    conf, pred, m, lse = port
    np.testing.assert_allclose(conf, np.asarray(ref[0]), rtol=0,
                               atol=CONF_ATOL)
    np.testing.assert_array_equal(pred, np.asarray(ref[1]))
    assert pred.dtype == np.int32
    np.testing.assert_allclose(m, np.asarray(ref[2]), rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(lse, np.asarray(ref[3]), rtol=0,
                               atol=STAT_ATOL)


@pytest.mark.parametrize("temperature", (1.0, 2.0))
@pytest.mark.parametrize("v", (10, 1000))
@pytest.mark.parametrize("d", (32, 128))
@pytest.mark.parametrize("n", (1, 3, 8, 13))
def test_plain_matches_jax_unfused(n, d, v, temperature):
    h, scale, w = _inputs(n, d, v, seed=n * 1000 + d + v)
    ref = jax_exit_unfused(h, scale, w, temperature=temperature)
    _assert_close(_port(h, scale, w, temperature), ref)


@pytest.mark.parametrize("n,d,v,temperature", [
    (1, 32, 10, 1.0), (3, 128, 1000, 2.0), (8, 32, 1000, 1.0),
    (13, 128, 10, 2.0), (13, 32, 1000, 2.0), (8, 128, 10, 1.0)])
def test_plain_matches_jax_kernel_interpret(n, d, v, temperature):
    h, scale, w = _inputs(n, d, v, seed=7 + n + d + v)
    ref = jax_exit_kernel(h, scale, w, temperature=temperature,
                          block_v=512, interpret=True)
    _assert_close(_port(h, scale, w, temperature), ref)


@pytest.mark.parametrize("ties", [(100, 300), (100, 700), (600, 900, 950)],
                         ids=["in-block", "cross-block", "later-block"])
def test_ties_take_first_index_like_jax_kernel(ties):
    h, scale, w = _inputs(13, 128, 1000, seed=3, ties=ties)
    ref = jax_exit_kernel(h, scale, w, block_v=512, interpret=True)
    port = _port(h, scale, w)
    _assert_close(port, ref)
    assert (port[1] == ties[0]).all()


@pytest.mark.parametrize("n,d,v", [(1, 32, 10), (8, 128, 1000),
                                   (13, 64, 517)])
def test_bf16_plain_matches_jax_kernel_interpret(n, d, v):
    """bf16 h, scale and w_out (as qwen3-4b's head holds them): both
    packages compute in fp32 from the same bf16 values and return fp32."""
    h, scale, w = _inputs(n, d, v, seed=50 + n + d + v)
    port = exit_confidence(*(torch.from_numpy(a).bfloat16()
                             for a in (h, scale, w)))
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    ref = jax_exit_kernel(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (h, scale, w)),
                          block_v=512, interpret=True)
    _assert_close([o.numpy() for o in port], ref)


def test_cpu_wrapper_leaves_launch_count():
    before = ops.exit_confidence.launches
    _port(*_inputs(4, 32, 10, seed=0))
    assert ops.exit_confidence.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "noncontiguous",
                                 "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, scale, w = (torch.from_numpy(a) for a in _inputs(4, 32, 10, seed=0))
    if bad == "dtype":
        h, exc = h.double(), TypeError
    elif bad == "mixed":
        w, exc = w.bfloat16(), TypeError
    elif bad == "noncontiguous":
        h, exc = torch.cat([h, h], dim=1)[:, ::2], ValueError
    else:
        w, exc = w[:16].contiguous(), ValueError
    with pytest.raises(exc):
        exit_confidence(h, scale, w)
