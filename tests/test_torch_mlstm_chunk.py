"""The port's mLSTM chunk against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and to the JAX ``mlstm_chunk_ref`` (the model's
``mlstm_chunked``) over ``tests/test_kernels.py``'s sweep ((1, 2, 8, 8),
(2, 4, 16, 16), (2, 2, 32, 32); fp32 and bf16; a state from 0.1 N(0, 1)
and m0 = 0), from a fresh state (m0 = -1e30), and two chunks chained
against one reference chunk of twice the length.  Tolerances are those of
``tests/test_kernels.py``: fp32 2e-5, bf16 8e-2 (the JAX reference keeps
its intra-chunk products in the input dtype), two chunks chained 2e-4
(atol = rtol).  The CUDA kernel itself is held to the plain version on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk import mlstm_chunk as jax_kernel
from repro.kernels.mlstm_chunk import mlstm_chunk_ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk

TOL = {"float32": 2e-5, "bfloat16": 8e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("h", "C1", "n1", "m1")


def _inputs(B, H, L, dh, seed, *, fresh=False):
    """q, k, v, i_pre, f_pre (raised by 2, as the JAX tests raise it), C0,
    n0, m0 as fp32 numpy arrays; ``fresh``: C0 = n0 = 0, m0 = -1e30."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((B, H, L)).astype(np.float32)
    f_pre = (rng.standard_normal((B, H, L)) + 2.0).astype(np.float32)
    if fresh:
        C0 = np.zeros((B, H, dh, dh), np.float32)
        n0 = np.zeros((B, H, dh), np.float32)
        m0 = np.full((B, H), -1e30, np.float32)
    else:
        C0 = (0.1 * rng.standard_normal((B, H, dh, dh))).astype(np.float32)
        n0 = (0.1 * rng.standard_normal((B, H, dh))).astype(np.float32)
        m0 = np.zeros((B, H), np.float32)
    return q, k, v, i_pre, f_pre, C0, n0, m0


def _port(arrays, dtype="float32"):
    """The port on CPU tensors: q, k, v rounded to ``dtype``, the gates
    and state fp32."""
    return mlstm_chunk(*(torch.from_numpy(a).to(TORCH[dtype]) if i < 3
                         else torch.from_numpy(a)
                         for i, a in enumerate(arrays)))


def _jax(arrays, dtype="float32"):
    return tuple(jnp.asarray(a).astype(JNP[dtype]) if i < 3
                 else jnp.asarray(a) for i, a in enumerate(arrays))


def _assert_close(port, ref, tol):
    for a, b, name in zip(port, ref, NAMES):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("B,H,L,dh,fresh", [
    (1, 2, 8, 8, False), (2, 4, 16, 16, False), (2, 2, 32, 32, False),
    (2, 4, 16, 16, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_sweep(B, H, L, dh, fresh, dtype):
    arrays = _inputs(B, H, L, dh, seed=8, fresh=fresh)
    port = _port(arrays, dtype)
    assert port[0].dtype == TORCH[dtype] and port[0].shape == (B, H, L, dh)
    assert all(t.dtype == torch.float32 for t in port[1:])
    assert port[1].shape == (B, H, dh, dh) and port[3].shape == (B, H)
    jargs = _jax(arrays, dtype)
    _assert_close(port, jax_kernel(*jargs), 2e-5 if dtype == "float32"
                  else 2e-2)
    _assert_close(port, jax_ref(*jargs), TOL[dtype])


def test_fresh_state_contributes_nothing():
    """m0 = -1e30 gives exp(m0 - g) = 0 exactly: a fresh state's C0 and n0
    leave h and the new state unchanged, whatever they hold."""
    arrays = _inputs(1, 2, 16, 16, seed=9, fresh=True)
    other = list(arrays)
    other[5] = np.full_like(arrays[5], 7.0)
    other[6] = np.full_like(arrays[6], -3.0)
    for a, b in zip(_port(arrays), _port(other)):
        assert torch.equal(a, b)


def test_two_chunks_chained_match_one_reference_chunk():
    """``tests/test_kernels.py``'s chaining: two port chunks of L from a
    fresh state, the second from the first's (C1, n1, m1), against one JAX
    reference chunk of 2L, and against the JAX kernel chained."""
    B, H, L, dh = 1, 2, 8, 8
    arrays = _inputs(B, H, 2 * L, dh, seed=10, fresh=True)
    halves = [tuple(np.ascontiguousarray(a[:, :, j * L:(j + 1) * L])
                    for a in arrays[:5]) for j in (0, 1)]
    h1, C1, n1, m1 = _port(halves[0] + arrays[5:])
    h2, C2, n2, m2 = mlstm_chunk(*(torch.from_numpy(a) for a in halves[1]),
                                 C1, n1, m1)
    href, Cref, _nref, mref = jax_ref(*_jax(arrays))
    np.testing.assert_allclose(torch.cat([h1, h2], 2).numpy(),
                               np.asarray(href), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(C2.numpy(), np.asarray(Cref), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(m2.numpy(), np.asarray(mref), atol=1e-5)
    j1 = jax_kernel(*_jax(halves[0] + arrays[5:]))
    j2 = jax_kernel(*_jax(halves[1]), *j1[1:])
    _assert_close((h2, C2, n2, m2), j2, 2e-4)


def test_plain_version_runs_in_float64_for_float64_inputs():
    """The float64 witness ``chip_smoke.py`` prints beside the card's
    check: float64 in, float64 out, and within the fp32 tolerance of the
    fp32 plain version at a small, well-conditioned shape."""
    arrays = _inputs(1, 2, 8, 8, seed=11)
    f64 = ops.mlstm_chunk_ref(*(torch.from_numpy(a).double()
                                for a in arrays))
    assert all(t.dtype == torch.float64 for t in f64)
    for a, b in zip(_port(arrays), f64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_condition_number_of_the_normaliser():
    """``mlstm_chunk_condition``, which scales the card check's fp32 h
    tolerance: 1 on a chunk whose normaliser cannot cancel (q, k, n0 all
    nonnegative), at least 1 and finite on random inputs, and above 1
    somewhere in the JAX sweep's (2, 2, 32, 32), where the normaliser's
    summands cancel."""
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_condition
    q, k, _, i_pre, f_pre, _, n0, m0 = (torch.from_numpy(a) for a in
                                        _inputs(2, 2, 32, 32, seed=12))
    kappa = mlstm_chunk_condition(q, k, i_pre, f_pre, n0, m0)
    assert kappa.shape == (2, 2, 32) and kappa.dtype == torch.float64
    assert bool(torch.isfinite(kappa).all()) and bool((kappa >= 1).all())
    assert float(kappa.max()) > 1.0
    ones = mlstm_chunk_condition(q.abs(), k.abs(), i_pre, f_pre, n0.abs(),
                                 m0)
    np.testing.assert_allclose(ones.numpy(), 1.0, rtol=1e-12)


def test_cpu_tensor_never_loads_the_kernel(monkeypatch):
    def refuse(_source):
        raise AssertionError("a CPU tensor must not build or load the "
                             "kernel")
    monkeypatch.setattr(build, "load", refuse)
    before = ops.mlstm_chunk.launches
    _port(_inputs(1, 1, 8, 8, seed=0))
    assert ops.mlstm_chunk.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "gates", "state_shape",
                                 "noncontiguous", "mixed_device",
                                 "no_kernel_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 8, 8, seed=0)]
    exc = ValueError
    if bad == "dtype":
        args[:3], exc = [t.double() for t in args[:3]], TypeError
    elif bad == "mixed":
        args[2], exc = args[2].bfloat16(), TypeError
    elif bad == "gates":
        args[3], exc = args[3].to(torch.int32), TypeError
    elif bad == "state_shape":
        args[6] = args[6][:, :1].contiguous()
    elif bad == "noncontiguous":
        args[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "mixed_device":
        args[5] = args[5].to("meta")
    else:
        args = [t.to("meta") for t in args]
    with pytest.raises(exc):
        mlstm_chunk(*args)


@pytest.mark.parametrize("L,dh", [(8, 128), (8, 12), (129, 8)])
def test_kernel_check_rejects_what_only_the_kernel_refuses(L, dh):
    """dh outside (8, 16, 32, 64) or L above 128, checked without a card
    by the wrapper's checking function; the plain version takes them."""
    args = [torch.from_numpy(a) for a in _inputs(1, 1, L, dh, seed=0)]
    ops.check(*args)
    with pytest.raises(ValueError, match="the kernel takes"):
        ops.check(*args, kernel=True)
    assert mlstm_chunk(*args)[0].shape == (1, 1, L, dh)
