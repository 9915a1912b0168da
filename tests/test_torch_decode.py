"""The port's decode path against the JAX package's.

The JAX test's tiny decode config (``tests/test_kernel_serving.py``), a
qk-norm variant and a bf16 qk-norm variant: the JAX params and decode
caches cross to the port through the bridge (``repro_torch.interop``),
tokens and positions are numpy arrays from a seed.  Held together:

* ``stage_decode_step`` + fused exit (the ``device-kernel`` decode stage
  fns) against the JAX ones under ``ParallelCtx(decode_attn="kernel")``
  (the Pallas decode kernel in interpret mode), ten tokens in a row at
  ragged positions: ``h``, the new cache and ``(pred, conf)``;
* ``decode_step`` against the JAX ``decode_step(ctx=None)`` on uniform
  positions (the JAX jnp route reads row 0's slot map for every row);
* ragged batched decode against singleton decode, within the tolerance
  and with the same pred (batched and singleton matmuls need not be
  bitwise equal);
* ``slice``/``concat`` and the cache bridge round trips.

Tolerances: fp32 1e-5 (abs); bf16 2e-2, abs and relative, in the form of
``tests/test_kernels.py`` (a bf16 ulp is 2**-8 of the value); identical
preds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch.kernel import KernelDecodeStageFns as JaxDecodeFns
from repro.launch.mesh import make_serving_mesh
from repro.models import ParallelCtx
from repro.models import decode_step as jax_decode_step
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import (cache_from_reference, cache_to_reference,
                                 from_reference)
from repro_torch.launch.kernel import KernelDecodeStageFns
from repro_torch.models import (concat_decode_caches, decode_step,
                                init_decode_cache, init_params,
                                slice_decode_cache, stage_decode_step)

TINY = dict(name="tiny-decode-test", arch_type="dense", source="test",
            num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=32, period=("attn",),
            ffn_type="swiglu", modality="text", causal=True, num_stages=2,
            mandatory_stages=1, stage_ends=(2, 4), dtype="float32")
VARIANTS = {"fp32": {}, "qk-norm": {"qk_norm": True},
            "bf16": {"qk_norm": True, "dtype": "bfloat16"}}
TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SLOTS = 16


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    kw = dict(TINY, **VARIANTS[request.param])
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return jcfg, jparams, cfg, params, TOL[cfg.dtype]


def _jax_cache(jcfg, batch, rng):
    """A JAX decode cache with random contents and ragged written prefixes
    (slot_pos = slot index below each row's length, -1 above)."""
    cache = jax_init_decode_cache(jcfg, batch, SLOTS)
    lens = rng.integers(1, SLOTS // 2, batch)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:          # slot_pos: (..., B, S)
            s = np.arange(SLOTS)
            return np.where(s < lens[:, None], s, -1).astype(np.int32) \
                + np.zeros_like(x)
        return (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
    cache = jax.tree.map(fill, cache)
    return jax.tree.map(lambda x: jnp.asarray(x).astype(
        jcfg.dtype if x.dtype != np.int32 else np.int32), cache), lens


def _assert_cache_close(port_cache, jax_cache, cfg, tol):
    got = cache_to_reference(cfg, port_cache)
    want = _f32(jax_cache)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def test_stage_decode_step_matches_jax_kernel_route(model):
    """Ten tokens in a row through both stages, three rows at ragged
    positions (each row its own cur_pos and written prefix)."""
    jcfg, jparams, cfg, params, tol = model
    rng = np.random.default_rng(0)
    jcache, lens = _jax_cache(jcfg, 3, rng)
    cache = cache_from_reference(cfg, _f32(jcache), device="cpu")
    jfns = JaxDecodeFns(jcfg, (1, 2, 4), ParallelCtx(
        mesh=make_serving_mesh(1, 1), decode_attn="kernel"))
    fns = KernelDecodeStageFns(cfg, (1, 2, 4))
    for t in range(10):
        tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        cur = (lens + t).astype(np.int32)
        jh, h = jnp.asarray(tok), torch.from_numpy(tok)
        for s in range(cfg.num_stages):
            jh, jcache[s], jpred, jconf = jfns.fn(s)(jparams, jh, jcache[s],
                                                     jnp.asarray(cur))
            h, cache[s], pred, conf = fns.fn(s)(params, h, cache[s],
                                                torch.from_numpy(cur))
            np.testing.assert_allclose(h.float().numpy(),
                                       np.asarray(jh, np.float32), **tol)
            np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
            np.testing.assert_allclose(conf.numpy(), np.asarray(jconf),
                                       **tol)
            # the next stage starts from the same hidden state in both
            h = torch.from_numpy(np.array(jh, np.float32)).to(h.dtype)
    _assert_cache_close(cache, jcache, cfg, tol)


@pytest.mark.parametrize("route", ("jnp", "kernel"))
@pytest.mark.parametrize("upto", (1, 2))
def test_decode_step_matches_jax(model, upto, route):
    """Uniform positions, against the JAX ``decode_step`` with ``ctx=None``
    (its jnp attention) and with ``ParallelCtx(decode_attn="kernel")``
    (the Pallas kernel, the route whose arithmetic the port follows).  The
    caller's cache stays as it was; the stages past ``upto`` hand it back
    unchanged.  Logits agree within the tolerance everywhere, and preds are
    identical against the kernel route.  The jnp route rounds its softmax
    probabilities to the storage type, so in bf16 a near-tie may come out
    the other way: against it the pred is held where its top two logits are
    more than twice the tolerance apart."""
    jcfg, jparams, cfg, params, tol = model
    ctx = None if route == "jnp" else ParallelCtx(
        mesh=make_serving_mesh(1, 1), decode_attn="kernel")
    rng = np.random.default_rng(1)
    B = 2
    jcache = jax_init_decode_cache(jcfg, B, SLOTS)
    cache = init_decode_cache(cfg, B, SLOTS, device="cpu")
    for t in range(5):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        pos = np.full(B, t, np.int32)
        before = cache_to_reference(cfg, cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jcache,
                                       jnp.asarray(tok), jnp.asarray(pos),
                                       upto_stage=upto, ctx=ctx)
        out, new = decode_step(cfg, params, cache, torch.from_numpy(tok),
                               torch.from_numpy(pos), upto_stage=upto)
        for a, b in zip(jax.tree.leaves(before),
                        jax.tree.leaves(cache_to_reference(cfg, cache))):
            np.testing.assert_array_equal(a, b)
        assert all(a is b for a, b in zip(new[upto:], cache[upto:]))
        assert len(out.logits) == upto
        for lg, jlg, c, jc in zip(out.logits, jout.logits, out.confidences,
                                  jout.confidences):
            jlg = np.asarray(jlg, np.float32)
            np.testing.assert_allclose(lg.float().numpy(), jlg, **tol)
            top2 = np.sort(jlg, -1)[:, -2:]
            held = (top2[:, 1] - top2[:, 0] > 2 * tol["atol"]) \
                | (route == "kernel")
            np.testing.assert_array_equal(
                lg.float().argmax(-1).numpy()[held], jlg.argmax(-1)[held])
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), **tol)
        cache = new
    _assert_cache_close(cache, jcache, cfg, tol)


def test_ragged_batch_matches_singletons(model):
    """Co-batched decode at ragged positions against each request alone
    (the exactness the per-row slot map buys), within the tolerance and
    with the same pred."""
    jcfg, _jparams, cfg, params, tol = model
    rng = np.random.default_rng(2)
    fns = KernelDecodeStageFns(cfg, (1, 2, 4))
    states = []
    for pos in (3, 9, 14):
        cache = cache_from_reference(
            cfg, _f32(_jax_cache(jcfg, 1, rng)[0]), device="cpu")
        for st in cache:                 # written up to pos - 1
            for layer in st:
                layer["slot_pos"][:] = torch.where(
                    torch.arange(SLOTS) < pos, torch.arange(SLOTS), -1)
        states.append(dict(h=torch.tensor([rng.integers(cfg.vocab_size)]),
                           cache=cache,
                           cur=torch.tensor([pos], dtype=torch.int32)))
    h_b = torch.cat([st["h"] for st in states])
    cur_b = torch.cat([st["cur"] for st in states])
    batched = []
    for s in range(cfg.num_stages):
        cache_b = concat_decode_caches([st["cache"][s] for st in states])
        h_b, c_b, pred_b, conf_b = fns.fn(s)(params, h_b, cache_b, cur_b)
        batched.append((h_b, c_b, pred_b, conf_b))
    for i, st in enumerate(states):
        h = st["h"]
        for s in range(cfg.num_stages):
            h, c, pred, conf = fns.fn(s)(params, h, st["cache"][s],
                                         st["cur"])
            h_b, c_b, pred_b, conf_b = batched[s]
            np.testing.assert_allclose(h.float().numpy(),
                                       h_b[i:i + 1].float().numpy(), **tol)
            assert int(pred[0]) == int(pred_b[i])
            np.testing.assert_allclose(float(conf[0]), float(conf_b[i]),
                                       **tol)
            for a, b in zip(c, slice_decode_cache(c_b, i)):
                for key in ("k", "v"):
                    np.testing.assert_allclose(a[key].float().numpy(),
                                               b[key].float().numpy(), **tol)
                assert torch.equal(a["slot_pos"], b["slot_pos"])


def test_stage_step_writes_in_place_only_when_asked(model):
    """``inplace=False`` leaves the caller's cache as it was (the
    launcher's speculative step relies on it); ``inplace=True`` writes the
    new token's slot into the caller's tensors."""
    _jcfg, _jparams, cfg, params, _tol = model
    cache = init_decode_cache(cfg, 2, SLOTS, device="cpu")
    tok = torch.tensor([1, 2])
    cur = torch.tensor([0, 5], dtype=torch.int32)
    _h, new = stage_decode_step(cfg, params, 0, cache[0], tok, cur)
    assert all(bool((layer["slot_pos"] == -1).all()) and
               not layer["k"].any() for layer in cache[0])
    assert [int(x) for x in new[0]["slot_pos"][[0, 1], [0, 5]]] == [0, 5]
    _h, new = stage_decode_step(cfg, params, 0, cache[0], tok, cur,
                                inplace=True)
    assert new[0]["k"] is cache[0][0]["k"]
    assert [int(x) for x in cache[0][0]["slot_pos"][[0, 1], [0, 5]]] \
        == [0, 5]


def test_ring_cache_write_wraps(model):
    """A position past the slot count writes slot ``cur_pos % S``."""
    _jcfg, _jparams, cfg, params, _tol = model
    cache = init_decode_cache(cfg, 1, 4, device="cpu")
    for t in range(6):
        _h, cache[0] = stage_decode_step(
            cfg, params, 0, cache[0], torch.tensor([t % cfg.vocab_size]),
            torch.tensor([t], dtype=torch.int32))
    assert cache[0][0]["slot_pos"].tolist() == [[4, 5, 2, 3]]


def test_slice_concat_roundtrip():
    cfg = ModelConfig(**TINY)
    cache = init_decode_cache(cfg, 3, 8, device="cpu")
    for st in cache:
        for layer in st:
            layer["k"].normal_(generator=torch.Generator().manual_seed(0))
    rows = [slice_decode_cache(cache[0], i) for i in range(3)]
    back = concat_decode_caches(rows)
    for a, b in zip(cache[0], back):
        for key in a:
            assert torch.equal(a[key], b[key])
            assert a[key].data_ptr() != b[key].data_ptr()
    pair = slice_decode_cache(cache[1], 1, 3)
    assert pair[0]["k"].shape[0] == 2
    assert torch.equal(pair[0]["k"], cache[1][0]["k"][1:3])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cache_bridge_roundtrip(dtype):
    """JAX cache -> port -> JAX gives the same arrays; the port's layout is
    (B, KV, S, dh), contiguous."""
    kw = dict(TINY, dtype=dtype)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jcache, _lens = _jax_cache(jcfg, 2, np.random.default_rng(4))
    cache = cache_from_reference(cfg, _f32(jcache), device="cpu")
    layer = cache[0][0]
    assert layer["k"].shape == (2, cfg.num_kv_heads, SLOTS, 16)
    assert layer["k"].dtype == getattr(torch, dtype)
    assert layer["k"].is_contiguous()
    assert layer["slot_pos"].dtype == torch.int32
    back = cache_to_reference(cfg, cache)
    assert jax.tree.structure(back) == jax.tree.structure(_f32(jcache))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_f32(jcache))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_has_the_bridged_layout(variant):
    """The port's own init gives the same tree, shapes and dtypes as the
    bridge makes of the JAX params ("tok" embedding, qk-norm scales)."""
    kw = dict(TINY, **VARIANTS[variant])
    cfg = ModelConfig(**kw)
    bridged = from_reference(cfg, jax.tree.map(
        np.asarray, jax_init_params(JaxModelConfig(**kw),
                                    jax.random.PRNGKey(0))), device="cpu")
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert shapes(own) == shapes(bridged)
    mixer = own["stages"][0][0]["mixer"]
    assert ("q_norm" in mixer) == cfg.qk_norm
    assert own["embed"]["tok"].dtype == getattr(torch, cfg.dtype)


def test_bridge_casts_bf16_exactly():
    """Each leaf goes through fp32 numpy, then to the config's dtype: the
    bridged bf16 params hold the JAX bf16 values bit for bit."""
    kw = dict(TINY, dtype="bfloat16")
    jparams = jax_init_params(JaxModelConfig(**kw), jax.random.PRNGKey(0))
    params = from_reference(ModelConfig(**kw),
                            jax.tree.map(np.asarray, jparams), device="cpu")
    w = params["exit_shared"]["w_out"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jparams["exit_shared"]["w_out"], np.float32))


def test_text_prefill_and_features_decode_are_not_ported():
    """Only the decode step of a text model is ported: a text model's
    full-sequence trunk and a features model's decode step raise, naming
    the queue item."""
    from repro_torch.models import stage_trunk
    cfg = ModelConfig(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        stage_trunk(cfg, params, 0, {"tokens": torch.zeros(1, 4,
                                                           dtype=torch.long)})
    ccfg = get_config("anytime-classifier")
    cparams = init_params(ccfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        stage_decode_step(ccfg, cparams, 0,
                          init_decode_cache(ccfg, 1, 4, device="cpu")[0],
                          torch.zeros(1, 16, 32),
                          torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("reduce", (False, True))
def test_qwen3_4b_config_matches_jax(reduce):
    """The registered qwen3-4b, and the reduced variant the launcher
    serves, equal the JAX package's field for field."""
    cfg, jcfg = get_config("qwen3-4b"), jax_get_config("qwen3-4b")
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.stage_boundaries() == jcfg.stage_boundaries()
    if not reduce:
        assert cfg.stage_boundaries() == (12, 24, 36)
        assert (cfg.dtype, cfg.qk_norm, cfg.resolved_head_dim) == \
            ("bfloat16", True, 128)
