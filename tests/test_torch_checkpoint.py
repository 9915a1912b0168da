"""Checkpoints written by either package load in the other.

The port's msgpack codec gives msgpack-python's bytes for the payloads
checkpoints hold and reads what msgpack-python writes.  A JAX
``checkpoint.save`` loads through the port's ``load`` into the params
``from_reference`` gives; a port ``save`` loads through the JAX ``load``
into the JAX params, leaf for leaf and bit for bit, metadata kept; the two
files' leaves are byte-equal for the same params.  Both for the anytime
classifier (fp32, scan groups) and for the reduced qwen3-4b in bf16 (bf16
leaves).  ``to_reference`` rebuilds the JAX param tree key for key.  The
launcher's ``--ckpt`` gives the JAX launcher's tokens and depths.
"""
import contextlib
import dataclasses
import io
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
import repro_torch.launch.serve as serve
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.training import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.interop import from_reference, to_reference
from repro_torch.models import init_params
from repro_torch.training import checkpoint
from repro_torch.training.msgpack_lite import packb, unpackb
from repro_torch.tree import tree_leaves

INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63)
PAYLOADS = {
    "nil, bools, floats": [None, True, False, 1.5, -0.0, 3e-3, float("inf")],
    "ints at every width edge": list(INTS),
    "str of each length form": ["", "a" * 31, "a" * 32, "é" * 40, "a" * 255,
                                "a" * 256, "x" * 70_000],
    "bin of each length form": [b"", b"\x00" * 255, b"\x01" * 256,
                                b"\x02" * 70_000],
    "arrays and maps of each length form": {
        "a15": list(range(15)), "a16": list(range(16)),
        "a70k": [0] * 70_000, "tuple": (1, 2),
        "m16": {str(i): i for i in range(16)}, "empty": {}},
    "a checkpoint payload": {
        "tree": {"leaves": [{"dtype": "float32", "shape": [2, 3],
                             "data": np.arange(6, dtype=np.float32)
                             .tobytes()}],
                 "treedef": "PyTreeDef(*)"},
        "meta": {"config": "anytime-classifier", "steps": 700,
                 "temperatures": [0.8408964152537145, 1.0]}},
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_codec_matches_msgpack(name):
    obj = PAYLOADS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False)
    assert unpackb(packb(obj)) == msgpack.unpackb(want, raw=False)


def test_codec_reads_float32_and_refuses_what_it_cannot_write():
    assert unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(TypeError):
        packb({"x": np.int64(3)})
    with pytest.raises(ValueError):
        unpackb(msgpack.packb([1, 2])[:-1])


CONFIGS = ("anytime-classifier", "qwen3-4b-reduced-bf16")


def _configs(name):
    if name == "anytime-classifier":
        return jax_get_config(name), get_config(name)
    return tuple(dataclasses.replace(c.reduced(), dtype="bfloat16")
                 for c in (jax_get_config("qwen3-4b"), get_config("qwen3-4b")))


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    """(jax cfg, JAX params from PRNGKey(3), port cfg, the port's seed-0
    params as the skeleton)."""
    jcfg, cfg = _configs(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    like = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return jcfg, jparams, cfg, like


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
               zip(tree_leaves(a, sort_keys=True),
                   tree_leaves(b, sort_keys=True)))


def test_jax_checkpoint_loads_in_the_port(pair, tmp_path):
    jcfg, jparams, cfg, like = pair
    path = str(tmp_path / "jax.ckpt")
    jax_checkpoint.save(path, jparams, {"steps": 3, "temps": [1.0, 0.5]})
    params, meta = checkpoint.load(path, like, cfg=cfg)
    assert meta == {"steps": 3, "temps": [1.0, 0.5]}
    assert _equal(params, from_reference(cfg, _f32(jparams), device="cpu"))
    assert tree_leaves(params)[0].dtype == getattr(torch, cfg.dtype)


def test_port_checkpoint_loads_in_jax(pair, tmp_path):
    jcfg, jparams, cfg, like = pair
    params = from_reference(cfg, _f32(jparams), device="cpu")
    path = str(tmp_path / "port.ckpt")
    checkpoint.save(path, params, {"config": cfg.name, "steps": 5}, cfg=cfg)
    other = jax_init_params(jcfg, jax.random.PRNGKey(4))
    back, meta = jax_checkpoint.load(path, other)
    assert meta == {"config": cfg.name, "steps": 5}
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_both_packages_write_the_same_leaves(pair, tmp_path):
    jcfg, jparams, cfg, like = pair
    jax_checkpoint.save(str(tmp_path / "jax.ckpt"), jparams)
    checkpoint.save(str(tmp_path / "port.ckpt"),
                    from_reference(cfg, _f32(jparams), device="cpu"),
                    cfg=cfg)
    files = [msgpack.unpackb((tmp_path / f).read_bytes(), raw=False)
             for f in ("jax.ckpt", "port.ckpt")]
    want, got = (f["tree"]["leaves"] for f in files)
    assert got == want
    assert packb(got) == msgpack.packb(want, use_bin_type=True)
    assert {e["dtype"] for e in got} == {str(jparams["embed"][
        "w_in" if jcfg.modality == "features" else "tok"].dtype)}


def test_to_reference_rebuilds_the_jax_tree(pair):
    jcfg, jparams, cfg, like = pair
    ref = to_reference(cfg, from_reference(cfg, _f32(jparams), device="cpu"))
    assert jax.tree.structure(ref) == jax.tree.structure(_f32(jparams))
    assert [sorted(s) for s in ref["stages"]] == \
        [sorted(s) for s in jparams["stages"]]
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(_f32(jparams))):
        np.testing.assert_array_equal(a, b)


def test_the_classifier_tree_has_the_jax_leaf_order():
    """32 leaves: w_in, w_out, the three exit norms, the 9 leaves of stage
    0's prefix layer, then stage 1's (2, ...) and stage 2's (3, ...) scan
    leaves; stage 0 has no "scan" key."""
    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = to_reference(cfg, params)
    assert [sorted(s) for s in ref["stages"]] == [
        ["prefix", "tail"], ["prefix", "scan", "tail"],
        ["prefix", "scan", "tail"]]
    shapes = [np.shape(x) for x in tree_leaves(ref, sort_keys=True)]
    assert len(shapes) == 32
    assert shapes[:5] == [(32, 128), (128, 10), (128,), (128,), (128,)]
    assert shapes[5:14] == [(128,), (256, 128), (128, 256), (128, 256),
                            (128,), (128, 128), (128, 128), (128, 128),
                            (128, 128)]
    assert [s[0] for s in shapes[14:23]] == [2] * 9
    assert [s[0] for s in shapes[23:]] == [3] * 9


def test_wrong_leaf_count_or_shape_raises(tmp_path):
    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "c.ckpt")
    checkpoint.save(path, params, cfg=cfg)
    q = get_config("qwen3-4b").reduced()
    with pytest.raises(ValueError, match="checkpoint has 32 leaves, "
                                         "expected 26"):
        checkpoint.load(path, init_params(q, torch.Generator(), device="cpu"),
                        cfg=q)
    narrow = dataclasses.replace(cfg, d_ff=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load(path, init_params(narrow, torch.Generator(),
                                          device="cpu"), cfg=narrow)


def test_save_leaves_no_temporary_file(tmp_path, monkeypatch):
    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    checkpoint.save(str(tmp_path / "a" / "c.ckpt"), params, {"k": 1},
                    cfg=cfg)
    assert os.listdir(tmp_path / "a") == ["c.ckpt"]

    def fail(src, dst):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.os, "replace", fail)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(str(tmp_path / "a" / "d.ckpt"), params, cfg=cfg)
    assert os.listdir(tmp_path / "a") == ["c.ckpt"]


def _recording(service_cls, tokens):
    """``Service`` whose ``advance`` callback also records the tokens it
    returns (the launchers keep them to themselves)."""
    class Recording:
        @staticmethod
        def from_spec(spec, **resources):
            advance = resources["advance"]

            def recorded(task, out):
                tok = advance(task, out)
                tokens.append(np.asarray(tok.cpu() if hasattr(tok, "cpu")
                                         else tok).tolist())
                return tok
            return service_cls.from_spec(spec,
                                         **{**resources, "advance": recorded})
    return Recording


def test_launcher_ckpt_matches_the_jax_launcher(tmp_path, monkeypatch):
    """A JAX checkpoint of the reduced qwen3-4b (params from PRNGKey(5),
    not the launchers' seed 0): both launchers with ``--ckpt`` give the
    same tokens and the same depth per token."""
    jcfg = jax_get_config("qwen3-4b").reduced()
    path = str(tmp_path / "q.ckpt")
    jax_checkpoint.save(path, jax_init_params(jcfg, jax.random.PRNGKey(5)))
    outs, toks = [], []
    for mod, argv in ((jax_serve, []), (serve, ["--device", "cpu"])):
        tokens = []
        monkeypatch.setattr(mod, "Service", _recording(mod.Service, tokens))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--tokens", "6", "--ckpt", path] + argv)
        outs.append([line.split(" conf=")[0] for line in
                     buf.getvalue().splitlines() if line.startswith("token ")])
        toks.append(tokens)
    assert len(outs[1]) == 6
    assert outs[1] == outs[0]
    assert toks[1] == toks[0]
