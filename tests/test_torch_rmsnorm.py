"""The port's RMSNorm against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and to the JAX ``rmsnorm_ref`` over ``tests/test_kernels.py``'s
sweep (N, d of (8, 32), (37, 64), (256, 128), (5, 256); fp32 and bf16, the
scale in x's dtype), plus a bf16 x with an fp32 scale.  Tolerances are those
of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2 (atol = rtol).  The
kernel's planner (``ops.plan``: path, K and blocks from the shape) is
checked here; the CUDA kernel itself is held to the plain version on the
card by ``tests/test_torch_gpu.py``.
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


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_switches_path_at_the_stated_widths(itemsize):
    """The warp path up to ``warp_max_d`` (K = WARP_K_MAX), the block path
    one 16-byte chunk above it and up to ``block_max_d`` (d 4096 and 8192
    on it), the loop path past that and at widths that are not a multiple
    of the vector width."""
    vec = ops.vector(itemsize)
    top, wide = ops.warp_max_d(itemsize), ops.block_max_d(itemsize)
    assert top == 32 * ops.WARP_K_MAX[itemsize] * vec
    got = {d: ops.plan(64, d, itemsize) for d in
           (vec, top, top + vec, 4096, 8192, wide, wide + vec, top + 1, 99)}
    assert [got[d].path for d in got] == [
        "warp", "warp", "block", "block", "block", "block", "loop", "loop",
        "loop"]
    assert got[top].K == ops.WARP_K_MAX[itemsize]
    assert got[wide].K == ops.BLOCK_KS[itemsize][-1]
    assert ops.plan(64, 2560, 2)[:2] == ("warp", 10)   # qwen3-4b bf16


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [8, 512, 520, 2048, 2560, 2816, 2824, 4096,
                               8192, 12288, 16384, 99, 2561])
def test_plan_holds_each_row_in_its_chunks(itemsize, d):
    """The chunks a row's team holds (K a thread on the warp path's 32
    lanes or the block path's 256 threads) cover the row, and on the warp
    path K is the least that does."""
    p = ops.plan(5, d, itemsize)
    chunks, ragged = divmod(d, ops.vector(itemsize))
    if p.path == "loop":
        assert ragged or d > ops.block_max_d(itemsize)
        return
    team = 32 if p.path == "warp" else p.threads
    assert not ragged and p.K * team >= chunks
    if p.path == "warp":
        assert (p.K - 1) * team < chunks
    else:
        assert p.K in ops.BLOCK_KS[itemsize]


@pytest.mark.parametrize("N", [1, 3, 4, 5, 37, 1024, 16384, 100003])
@pytest.mark.parametrize("d,itemsize", [(512, 4), (2560, 2), (4096, 2),
                                        (100, 2)])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_covers_every_row_once(N, d, itemsize, sms):
    """The plan's blocks give every row its team (a warp, or the block on
    the block path); the grid, those blocks cut to what the card holds at
    once (here ``sms`` SMs of 4 blocks; the wrapper asks the occupancy
    calculator), covers every row exactly once through the teams' row
    walks."""
    p = ops.plan(N, d, itemsize)
    assert p.threads == ops.THREADS[p.path]
    rows = 1 if p.path == "block" else p.threads // 32
    assert p.blocks == -(-N // rows)
    grid = min(p.blocks, 4 * sms)
    # the kernel's row walk: team i (a warp, or the block on the block
    # path) takes rows i, i + teams, i + 2 teams, ...
    teams = grid * rows
    walks = [range(team, N, teams) for team in range(teams)]
    assert sorted(r for walk in walks for r in walk) == list(range(N))


def test_kernel_check_needs_16_byte_alignment():
    """What only the kernel needs, checked without a card: x starting 4
    bytes past a 16-byte boundary is refused by ``check(kernel=True)`` and
    taken by the plain version."""
    x = torch.zeros(8 * 32 + 1)[1:].view(8, 32)
    s = torch.zeros(32)
    ops.check(x, s)
    with pytest.raises(ValueError, match="16-byte"):
        ops.check(x, s, kernel=True)
    assert rmsnorm(x, s).shape == (8, 32)
