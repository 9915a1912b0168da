"""The port's flash attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and, where every query sees a key, to the JAX
``flash_attention_ref``: a subset of ``tests/test_kernels.py``'s sweep
(MHA in fp32, GQA 3:1 with S ragged against the block in fp32 and bf16;
causal, not causal, causal with window 16), no causal mask with window 8,
window 0, and the JAX kernel's results across its block shapes.  The
bf16 CUDA kernel rounds P to bf16 for its P V product; its plain model,
``flash_attention_ref_bf16_p``, is held to the Pallas kernel (which
multiplies an fp32 P) over the bf16 sweep.  Tolerances are those of
``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2 (atol = rtol).  The CUDA
kernels themselves are held to the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_kernel
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_ref_bf16_p)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, H, KV, S, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, dh), (B, KV, S, dh), (B, KV, S, dh)))


def _port(arrays, dtype="float32", **kw):
    out = flash_attention(*(torch.from_numpy(a).to(TORCH[dtype])
                            for a in arrays), **kw)
    assert out.dtype == TORCH[dtype] and out.shape == arrays[0].shape
    return out.float().numpy()


def _jax(arrays, dtype="float32"):
    return tuple(jnp.asarray(a).astype(JNP[dtype]) for a in arrays)


@pytest.mark.parametrize("B,H,KV,S,dh,dtype", [
    (1, 2, 2, 32, 16, "float32"),        # MHA
    (2, 6, 2, 48, 32, "float32"),        # GQA 3:1, ragged seq vs block
    (2, 6, 2, 48, 32, "bfloat16"),
])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_plain_matches_jax_kernel_sweep(B, H, KV, S, dh, dtype, causal,
                                        window):
    arrays = _inputs(B, H, KV, S, dh, seed=0)
    port = _port(arrays, dtype, causal=causal, window=window)
    jargs = _jax(arrays, dtype)
    tol = TOL[dtype]
    for ref in (jax_kernel(*jargs, causal=causal, window=window,
                           block_q=64, block_k=64),
                jax_ref(*jargs, causal=causal, window=window)):
        np.testing.assert_allclose(port, np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_without_causal_mask_matches_jax_kernel(dtype):
    """``q - k < 8`` with no lower bound: every key after the query stays
    visible."""
    arrays = _inputs(2, 4, 2, 64, 32, seed=1)
    port = _port(arrays, dtype, causal=False, window=8)
    ref = jax_kernel(*_jax(arrays, dtype), causal=False, window=8,
                     block_q=16, block_k=16)
    tol = TOL[dtype]
    np.testing.assert_allclose(port, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_window_zero_gives_zeros_as_the_jax_kernel_does():
    """Causal with window 0 leaves no key visible: the Pallas kernel gives
    zeros (``l`` clamped at 1e-30), and so does the port.  The JAX
    package's ``flash_attention_ref`` gives a uniform average of v there
    (ROADMAP C-ref 9), so the port is not held to it."""
    arrays = _inputs(1, 2, 1, 16, 8, seed=2)
    port = _port(arrays, causal=True, window=0)
    ref = np.asarray(jax_kernel(*_jax(arrays), causal=True, window=0,
                                block_q=8, block_k=8))
    assert not port.any() and not ref.any()
    assert np.abs(np.asarray(jax_ref(*_jax(arrays), causal=True,
                                     window=0))).max() > 0.1


@pytest.mark.parametrize("block", [(8, 8), (16, 32), (64, 64)])
def test_plain_matches_jax_kernel_at_each_block_shape(block):
    """``tests/test_kernels.py``'s block-shape independence: the JAX
    kernel's result at each of its tile choices equals the port's."""
    arrays = _inputs(1, 2, 2, 64, 32, seed=3)
    ref = jax_kernel(*_jax(arrays), block_q=block[0], block_k=block[1])
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_cpu_tensor_never_loads_the_kernel(monkeypatch):
    def refuse(_source):
        raise AssertionError("a CPU tensor must not build or load the "
                             "kernel")
    monkeypatch.setattr(build, "load", refuse)
    before = ops.flash_attention.launches
    _port(_inputs(1, 2, 1, 16, 16, seed=0))
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "groups",
                                 "noncontiguous", "window", "mixed_device",
                                 "no_kernel_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 16, 16, 0))
    kw, exc = {}, ValueError
    if bad == "dtype":
        q, k, v, exc = q.double(), k.double(), v.double(), TypeError
    elif bad == "mixed":
        v, exc = v.bfloat16(), TypeError
    elif bad == "shape":
        k = k[:, :, :8].contiguous()
    elif bad == "groups":                    # H not a multiple of KV
        q = q[:, :3].contiguous()
    elif bad == "noncontiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "window":
        kw = {"window": -1}
    elif bad == "mixed_device":
        k = k.to("meta")
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(exc):
        flash_attention(q, k, v, **kw)


def test_kernel_check_rejects_an_unsupported_head_dim():
    """What only the CUDA kernel refuses (head dim 24), checked without a
    card by the wrapper's checking function; the plain version takes it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 24, 0))
    ops.check(q, k, v, None)
    with pytest.raises(ValueError, match="head dim 24"):
        ops.check(q, k, v, None, kernel=True)
    assert flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("B,H,KV,S,dh", [
    (2, 6, 2, 48, 32),                   # GQA 3:1, ragged seq vs block
    (1, 8, 1, 128, 64),
    (1, 4, 2, 72, 128),                  # qwen3-4b's head dim, S ragged
])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 8)])
def test_bf16_p_model_matches_jax_kernel(B, H, KV, S, dh, causal, window):
    """The bf16 kernel's numerics (P rounded to bf16 before P V) against the
    Pallas kernel, which multiplies an fp32 P, at the bf16 tolerance, on
    bf16 inputs."""
    arrays = _inputs(B, H, KV, S, dh, seed=4)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    model = flash_attention_ref_bf16_p(tq, tk, tv, causal=causal,
                                       window=window)
    assert model.dtype == torch.bfloat16 and model.shape == tq.shape
    ref = jax_kernel(*_jax(arrays, "bfloat16"), causal=causal,
                     window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(model.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_bf16_p_rounding_is_the_only_difference_in_fp32():
    """On fp32 inputs the model differs from the plain version only by P's
    rounding: by at most a bf16 step of P (2^-8 relative) times the
    largest |v|, and not by nothing."""
    arrays = _inputs(1, 4, 2, 100, 64, seed=5)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    diff = (flash_attention_ref_bf16_p(q, k, v)
            - flash_attention_ref(q, k, v)).abs().max()
    assert 0 < float(diff) <= 2.0 ** -8 * float(v.abs().max())


def test_bf16_p_model_window_zero_gives_zeros():
    arrays = _inputs(1, 2, 1, 16, 8, seed=2)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    assert not flash_attention_ref_bf16_p(q, k, v, causal=True,
                                          window=0).any()


def test_kernel_check_rejects_a_misaligned_tensor():
    """The kernels' 16-byte alignment (the bf16 kernel's TMA loads need
    it), checked without a card; the plain version takes the tensor."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 2, 1, 8, 16, 0))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ops.check(q, k, v, None, kernel=True)
    with pytest.raises(ValueError, match="16-byte"):
        ops.check(shifted, k, v, None, kernel=True)
    assert torch.equal(flash_attention(shifted, k, v), flash_attention(q, k,
                                                                       v))
