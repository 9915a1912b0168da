"""The port's RMSNorm against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and to the JAX ``rmsnorm_ref`` over ``tests/test_kernels.py``'s
sweep (N, d of (8, 32), (37, 64), (256, 128), (5, 256); fp32 and bf16, the
scale in x's dtype), plus a bf16 x with an fp32 scale.  Tolerances are those
of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2 (atol = rtol).  The CUDA
kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jax_kernel
from repro.kernels.rmsnorm import rmsnorm_ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ops import rmsnorm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(N, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


@pytest.mark.parametrize("N,d", [(8, 32), (37, 64), (256, 128), (5, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_sweep(N, d, dtype):
    """N 37 is ragged against the JAX kernel's 16-row blocks; the port's
    kernel masks the ragged rows instead of padding."""
    x, s = _inputs(N, d, seed=6)
    port = rmsnorm(torch.from_numpy(x).to(TORCH[dtype]),
                   torch.from_numpy(s).to(TORCH[dtype]))
    assert port.dtype == TORCH[dtype] and port.shape == (N, d)
    jx, js = (jnp.asarray(a).astype(JNP[dtype]) for a in (x, s))
    tol = TOL[dtype]
    for ref in (jax_kernel(jx, js, block_rows=16), jax_ref(jx, js)):
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


def test_bf16_x_with_fp32_scale_matches_jax_kernel():
    x, s = _inputs(37, 64, seed=7)
    port = rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(s))
    assert port.dtype == torch.bfloat16
    ref = jax_kernel(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s),
                     block_rows=16)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_cpu_tensor_never_loads_the_kernel(monkeypatch):
    def refuse(_source):
        raise AssertionError("a CPU tensor must not build or load the "
                             "kernel")
    monkeypatch.setattr(build, "load", refuse)
    before = ops.rmsnorm.launches
    x, s = _inputs(8, 32, seed=0)
    rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert ops.rmsnorm.launches == before


@pytest.mark.parametrize("bad", ["dtype", "scale_dtype", "shape",
                                 "noncontiguous", "mixed_device",
                                 "no_kernel_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, s = (torch.from_numpy(a) for a in _inputs(8, 32, seed=0))
    if bad == "dtype":
        x, s, exc = x.double(), s.double(), TypeError
    elif bad == "scale_dtype":              # bf16 scale with fp32 x
        s, exc = s.bfloat16(), TypeError
    elif bad == "shape":
        s, exc = s[:16].contiguous(), ValueError
    elif bad == "noncontiguous":
        x, exc = x.t().contiguous().t(), ValueError
    elif bad == "mixed_device":
        s, exc = torch.empty(32, device="meta"), ValueError
    else:
        x, s, exc = x.to("meta"), s.to("meta"), ValueError
    with pytest.raises(exc):
        rmsnorm(x, s)
