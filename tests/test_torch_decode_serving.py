"""The port's decode serving against the JAX package's, end to end.

* ``Service`` -> ``device-kernel`` (``mode="decode"``) on the JAX test's
  tiny decode config with bridged weights and bridged per-request caches:
  six one-token requests at ragged positions, on the virtual clock, at
  ``pipeline_depth`` 1 and 3; each response's (sample, prediction, depth,
  missed) must be equal and its confidence within rtol 1e-5.
* The token-loop launcher's components (``conf-target``, ``decode``,
  ``token-loop``) on the reduced qwen3-4b the launcher serves, with and
  without speculation, at three confidence targets: the same tokens, the
  same depth per token and the same speculation counts.
* ``--dry-run`` prints the JAX package's spec JSON; the launcher runs on
  the CPU when asked; ``--ckpt`` raises ``NotImplementedError``.
"""
import argparse
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
import repro_torch.launch.serve as serve
from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch.kernel import KernelDecodeStageFns as JaxDecodeFns
from repro.launch.mesh import make_serving_mesh
from repro.models import ParallelCtx
from repro.models import decode_step as jax_decode_step
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServeSpec as JaxServeSpec
from repro.serving import Service as JaxService
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import cache_from_reference, from_reference
from repro_torch.launch.kernel import (KernelDecodeStageFns,
                                       KernelDeviceExecutor)
from repro_torch.models import init_decode_cache
from repro_torch.serving import Request, ServeSpec, Service
from repro_torch.serving.registry import available

TINY = dict(name="tiny-decode-test", arch_type="dense", source="test",
            num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=32, period=("attn",),
            ffn_type="swiglu", modality="text", causal=True, num_stages=2,
            mandatory_stages=1, stage_ends=(2, 4), dtype="float32")
SLOTS = 16
POSITIONS = (3, 9, 14, 5, 0, 11)         # one request per position


def _spec(spec_cls, depth):
    return spec_cls(
        policy="rtdeepiot",
        policy_args={"predictor": "exp", "prior_curve": [0.5, 0.8]},
        executor="device-kernel",
        executor_args={"mode": "decode"}, clock="virtual", source="stream",
        pipeline_depth=depth,
        batching={"buckets": [1, 2, 4], "stage_times": [0.002, 0.003],
                  "marginal": 0.25})


@pytest.fixture(scope="module")
def decode_models():
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    # per-request caches: random contents, written up to each position
    rng = np.random.default_rng(0)
    caches = []
    for pos in POSITIONS:
        def fill(x, pos=pos):
            x = np.asarray(x)
            if x.dtype == np.int32:
                s = np.arange(SLOTS)
                return np.where(s < pos, s, -1).astype(np.int32) + 0 * x
            return (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        caches.append(jax.tree.map(fill, jax_init_decode_cache(jcfg, 1,
                                                               SLOTS)))
    tokens = rng.integers(0, jcfg.vocab_size, len(POSITIONS))
    # stage fns shared by the runs of each package (one jit cache)
    jfns = JaxDecodeFns(jcfg, (1, 2, 4), ParallelCtx(
        mesh=make_serving_mesh(1, 1), decode_attn="kernel"))
    fns = KernelDecodeStageFns(cfg, (1, 2, 4))
    return jcfg, jparams, jfns, cfg, params, fns, caches, tokens


def _stream(req_cls, caches, tokens, make):
    """Six requests, two every millisecond; ``make`` turns a request's
    (token, position, numpy cache) into its inputs dict."""
    return [(0.001 * (i // 2),
             req_cls(make(int(tok), pos, cache), 0.05, sample=i, client=i,
                     seq_len=SLOTS))
            for i, (tok, pos, cache) in enumerate(zip(tokens, POSITIONS,
                                                      caches))]


def _key(responses):
    return [(r.sample, r.prediction, r.depth, r.missed) for r in responses]


@pytest.mark.parametrize("depth", (1, 3))
def test_device_kernel_decode_service_matches_jax(decode_models, depth):
    jcfg, jparams, jfns, cfg, params, fns, caches, tokens = decode_models
    ref = JaxService.from_spec(_spec(JaxServeSpec, depth), cfg=jcfg,
                               params=jparams, stage_fns=jfns)
    ref_res = ref.run(_stream(
        JaxRequest, caches, tokens,
        lambda tok, pos, c: {"h": jnp.array([tok], jnp.int32),
                             "cache": jax.tree.map(jnp.asarray, c),
                             "cur_pos": jnp.array([pos], jnp.int32)}))
    svc = Service.from_spec(_spec(ServeSpec, depth), cfg=cfg, params=params,
                            stage_fns=fns)
    res = svc.run(_stream(
        Request, caches, tokens,
        lambda tok, pos, c: {"h": torch.tensor([tok], dtype=torch.int32),
                             "cache": cache_from_reference(cfg, c,
                                                           device="cpu"),
                             "cur_pos": torch.tensor([pos],
                                                     dtype=torch.int32)}))
    assert _key(svc.responses) == _key(ref.responses)
    np.testing.assert_allclose([r.confidence for r in svc.responses],
                               [r.confidence for r in ref.responses],
                               rtol=1e-5)
    ex = svc.executor
    assert ex.mode == "decode" and ex.max_inflight == max(1, depth - 1)
    assert res.n_requests == 6 and res.miss_rate == ref_res.miss_rate == 0
    assert res.n_dispatches == ref_res.n_dispatches > 0
    assert sum(ex.stage_dispatches.values()) == res.n_dispatches
    assert ex.cache_stats() == ref.executor.cache_stats()
    assert ex.cache_stats()["live"] == 0


def test_decode_commit_keeps_no_view_of_the_batch(decode_models,
                                                  monkeypatch):
    """Each committed row (hidden row and every stage-cache tensor) is a
    copy that owns one row's storage, not a view that would keep the
    whole padded batch of the dispatch alive; the responses stay those of
    the JAX package."""
    jcfg, jparams, jfns, cfg, params, fns, caches, tokens = decode_models
    ref = JaxService.from_spec(_spec(JaxServeSpec, 3), cfg=jcfg,
                               params=jparams, stage_fns=jfns)
    ref.run(_stream(
        JaxRequest, caches, tokens,
        lambda tok, pos, c: {"h": jnp.array([tok], jnp.int32),
                             "cache": jax.tree.map(jnp.asarray, c),
                             "cur_pos": jnp.array([pos], jnp.int32)}))
    commit, checked = KernelDeviceExecutor.commit, []

    def spy(ex, task, k):
        stage, ((h_out, new_cache), _pred, _conf) = ex._done
        conf = commit(ex, task, k)
        st = ex.states[task.tid][1]
        pairs = [(st["h"], h_out)] + [
            (layer[key], batch[key])
            for layer, batch in zip(st["cache"][stage], new_cache)
            for key in layer]
        for row, batch in pairs:
            assert row.shape == (1,) + tuple(batch.shape[1:])
            assert row.untyped_storage().data_ptr() \
                != batch.untyped_storage().data_ptr()
            assert row.untyped_storage().nbytes() \
                == row.numel() * row.element_size()
        checked.append(len(pairs))
        return conf

    monkeypatch.setattr(KernelDeviceExecutor, "commit", spy)
    svc = Service.from_spec(_spec(ServeSpec, 3), cfg=cfg, params=params,
                            stage_fns=fns)
    svc.run(_stream(
        Request, caches, tokens,
        lambda tok, pos, c: {"h": torch.tensor([tok], dtype=torch.int32),
                             "cache": cache_from_reference(cfg, c,
                                                           device="cpu"),
                             "cur_pos": torch.tensor([pos],
                                                     dtype=torch.int32)}))
    assert len(checked) == sum(r.depth for r in svc.responses) > 0
    assert _key(svc.responses) == _key(ref.responses)
    np.testing.assert_allclose([r.confidence for r in svc.responses],
                               [r.confidence for r in ref.responses],
                               rtol=1e-5)


def test_decode_service_leaves_request_inputs_unwritten(decode_models):
    """Commit builds a new state dict: the request's own inputs (here a
    shared cache, as a pool of sequences would hand out) stay as given."""
    _jcfg, _jparams, _jfns, cfg, params, fns, caches, tokens = decode_models
    shared = cache_from_reference(cfg, caches[0], device="cpu")
    before = [[{k: t.clone() for k, t in layer.items()} for layer in st]
              for st in shared]
    inputs = [{"h": torch.tensor([int(tok)], dtype=torch.int32),
               "cache": shared,
               "cur_pos": torch.tensor([POSITIONS[0]], dtype=torch.int32)}
              for tok in tokens[:3]]
    svc = Service.from_spec(_spec(ServeSpec, 3), cfg=cfg, params=params,
                            stage_fns=fns)
    svc.run([(0.0, Request(x, 0.05, sample=i, client=i, seq_len=SLOTS))
             for i, x in enumerate(inputs)])
    assert len(svc.responses) == 3
    for x in inputs:
        assert x["cache"] is shared and x["h"].shape == (1,)
    for st, st0 in zip(shared, before):
        for layer, layer0 in zip(st, st0):
            for k in layer:
                assert torch.equal(layer[k], layer0[k])


# ---------------------------------------------------------------------------
# the token-loop launcher's components
# ---------------------------------------------------------------------------

B, TOKENS = 4, 10


@pytest.fixture(scope="module")
def launcher_models():
    jcfg = jax_get_config("qwen3-4b").reduced()
    cfg = get_config("qwen3-4b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    n = len(jcfg.stage_boundaries())
    jsteps = [jax.jit(lambda p, c, t, pos, _d=d: jax_decode_step(
        jcfg, p, c, t, pos, upto_stage=_d)) for d in range(1, n + 1)]
    return jcfg, jparams, jsteps, cfg, params, n


def _run_launcher(jax_side, models, target, speculate):
    """One token loop through the package's Service, as its launcher's
    ``main`` builds it.  Returns (records, speculated, spec_hits, depths)
    with records = [(token index, depth, next tokens)]."""
    jcfg, jparams, jsteps, cfg, params, n = models
    args = argparse.Namespace(conf_target=target, pipeline=speculate,
                              tokens=TOKENS)
    records = []
    if jax_side:
        spec = jax_serve.build_spec(args, n)

        def advance(task, out):
            nxt = jnp.argmax(out.logits[-1], -1).astype(jnp.int32)
            records.append((task.sample, task.executed,
                            np.asarray(nxt).tolist(), task.last_confidence))
            return nxt
        svc = JaxService.from_spec(
            spec, steps=jsteps, params=jparams,
            cache=jax_init_decode_cache(jcfg, B, slots=TOKENS + 1),
            tok=jnp.zeros((B,), jnp.int32), advance=advance)
    else:
        spec = serve.build_spec(args, n)

        def advance(task, out):
            nxt = out.logits[-1].argmax(-1).to(torch.int32)
            records.append((task.sample, task.executed, nxt.tolist(),
                            task.last_confidence))
            return nxt
        svc = Service.from_spec(
            spec, steps=serve.make_steps(cfg, n), params=params,
            cache=init_decode_cache(cfg, B, slots=TOKENS + 1, device="cpu"),
            tok=torch.zeros(B, dtype=torch.int32), advance=advance)
    met = svc.run()
    svc.close()
    depths = [r["depth"] for r in met.per_request]
    return records, svc.executor.speculated, svc.executor.spec_hits, depths


@pytest.mark.parametrize("speculate", (False, True))
@pytest.mark.parametrize("target", ("zero", "median", "default"))
def test_token_loop_matches_jax(launcher_models, target, speculate):
    """The same tokens, depth per token and speculation counts.  "zero"
    stops every token at stage 1, "default" (0.7) runs every token to full
    depth on random weights, "median" (the median stage-1 confidence of
    the "zero" run) mixes the two."""
    conf = {"zero": 0.0, "default": 0.7}
    if target == "median":
        recs = _run_launcher(True, launcher_models, 0.0, False)[0]
        conf["median"] = float(np.median([r[3] for r in recs]))
    ref = _run_launcher(True, launcher_models, conf[target], speculate)
    got = _run_launcher(False, launcher_models, conf[target], speculate)
    assert [r[:3] for r in got[0]] == [r[:3] for r in ref[0]]
    np.testing.assert_allclose([r[3] for r in got[0]],
                               [r[3] for r in ref[0]], rtol=1e-5)
    assert got[1:] == ref[1:]
    n = launcher_models[-1]
    hist = np.bincount(got[3], minlength=n + 1)[1:]
    assert hist.sum() == TOKENS
    if target == "median":
        assert hist.min() > 0            # both depths occur
    if speculate and target != "zero":
        assert got[2] > 0                # speculative steps were consumed


@pytest.mark.parametrize("argv", (
    ["--dry-run"],
    ["--dry-run", "--pipeline", "--tokens", "8", "--conf-target", "0.5"]))
def test_dry_run_prints_the_jax_spec(argv):
    outs = []
    for main in (jax_serve.main, serve.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert "DRY RUN OK" in outs[1]


def test_launcher_main_runs_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        met = serve.main(["--tokens", "6", "--pipeline", "--device", "cpu"])
    assert met.n_requests == 6
    assert "depth histogram" in buf.getvalue()
    assert sum(1 for line in buf.getvalue().splitlines()
               if line.startswith("token ")) == 6


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--tokens", "2"])


def test_launcher_ckpt_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue A item 1"):
        serve.main(["--tokens", "2", "--ckpt", "x.ckpt", "--device", "cpu"])


def test_launcher_components_are_registered():
    assert "conf-target" in available("policy")
    assert "decode" in available("executor")
    assert "token-loop" in available("source")
    assert "device-kernel" in available("executor")
    ServeSpec(executor="device-kernel",
              executor_args={"mode": "decode",
                             "len_buckets": [256, 1024]}).validate()
