"""The port's decode-attention function against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) over the sweep of ``tests/test_kernels.py`` (shapes, fp32 and bf16,
window None and 8, ring semantics), plus ragged positions within a batch
and a row with no valid slot, which both kernels answer with zeros.  Rows
with at least one valid slot are also held to the JAX package's
``decode_attention_ref``.  Tolerances are those of ``tests/test_kernels.py``:
fp32 2e-5, bf16 2e-2 (atol = rtol).  The CUDA kernel itself is held to the
plain version on the card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_kernel
from repro.kernels.decode_attention import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import decode_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, H, KV, S, dh, seed, *, slot_pos, cur):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, dh)).astype(np.float32)
    return q, k, v, np.asarray(slot_pos, np.int32), np.asarray(cur, np.int32)


def _both(q, k, v, slot_pos, cur, dtype, **kw):
    """(port, Pallas kernel) outputs as fp32 numpy; the fp32 inputs are
    rounded to ``dtype`` the same way in both packages."""
    port = decode_attention(*(torch.from_numpy(a).to(TORCH[dtype])
                              for a in (q, k, v)),
                            torch.from_numpy(slot_pos),
                            torch.from_numpy(cur), **kw)
    assert port.dtype == TORCH[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v))
    ref = jax_kernel(jq, jk, jv, jnp.asarray(slot_pos), jnp.asarray(cur),
                     block_k=16, interpret=True, **kw)
    return (port.float().numpy(), np.asarray(ref, np.float32),
            (jq, jk, jv, jnp.asarray(slot_pos), jnp.asarray(cur)))


@pytest.mark.parametrize("B,H,KV,S,dh", [
    (2, 4, 2, 40, 32),
    (1, 8, 8, 64, 16),
    (3, 6, 1, 33, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_matches_jax_kernel_sweep(B, H, KV, S, dh, dtype, window):
    """``tests/test_kernels.py``'s sweep: every slot holds its own position,
    the last three are unwritten, rows decode at positions 10, 17, 24."""
    slot_pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    slot_pos[:, -3:] = -1
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=2, slot_pos=slot_pos,
                               cur=np.arange(B) * 7 + 10)
    port, ref, jargs = _both(q, k, v, sp, cur, dtype, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(port, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        port, np.asarray(jax_ref(*jargs, window=window), np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_ragged_rows_and_empty_row_match_jax_kernel(dtype, window):
    """Rows at different positions with different written prefixes in one
    batch, and a row with no valid slot: zeros, as the Pallas kernel gives
    (``decode_attention_ref`` would give a uniform average there, so it is
    held only on the other rows)."""
    B, H, KV, S, dh = 4, 8, 2, 48, 32
    lens = np.array([0, 5, 30, 48])              # row 0: nothing written
    slot_pos = np.where(np.arange(S)[None] < lens[:, None], np.arange(S), -1)
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=5, slot_pos=slot_pos,
                               cur=np.maximum(lens - 1, 0))
    port, ref, jargs = _both(q, k, v, sp, cur, dtype, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(port, ref, atol=tol, rtol=tol)
    assert not port[0].any() and not ref[0].any()
    np.testing.assert_allclose(
        port[1:], np.asarray(jax_ref(*jargs, window=window),
                             np.float32)[1:], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_semantics_match_jax_kernel(dtype):
    """``tests/test_kernels.py``'s ring: 16 slots after 20 tokens hold
    positions 16..19 then 4..15 (non-monotonic slot_pos)."""
    S = 16
    slot_pos = [[(16 + i) if i < 4 else i for i in range(S)]]
    q, k, v, sp, cur = _inputs(1, 2, 2, S, 16, seed=3, slot_pos=slot_pos,
                               cur=[19])
    port, ref, jargs = _both(q, k, v, sp, cur, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(port, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(port, np.asarray(jax_ref(*jargs), np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 3])
def test_ring_with_ragged_rows(window):
    """Per-row ring maps: each row wrapped a different number of times."""
    B, H, KV, S, dh = 3, 4, 2, 8, 16
    P = np.array([9, 13, 16])                    # tokens run per row
    slots = np.arange(S)[None]
    slot_pos = np.where(slots < (P - S)[:, None], slots + S, slots)
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=11, slot_pos=slot_pos,
                               cur=P - 1)
    port, ref, _ = _both(q, k, v, sp, cur, "float32", window=window)
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_leaves_launch_count():
    before = ops.decode_attention.launches
    q, k, v, sp, cur = _inputs(1, 2, 2, 8, 16, seed=0,
                               slot_pos=[list(range(8))], cur=[7])
    decode_attention(*(torch.from_numpy(a) for a in (q, k, v, sp, cur)))
    assert ops.decode_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "positions",
                                 "noncontiguous", "shape", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, sp, cur = (torch.from_numpy(a) for a in _inputs(
        2, 4, 2, 8, 16, seed=0, slot_pos=np.tile(np.arange(8), (2, 1)),
        cur=[3, 7]))
    kw = {}
    if bad == "dtype":
        q, k, v, exc = q.double(), k.double(), v.double(), TypeError
    elif bad == "mixed":
        k, exc = k.bfloat16(), TypeError
    elif bad == "positions":
        sp, exc = sp.long(), TypeError
    elif bad == "noncontiguous":
        k, exc = k.transpose(1, 2).contiguous().transpose(1, 2), ValueError
    elif bad == "shape":
        q, exc = q[:, :3].contiguous(), ValueError
    else:
        kw, exc = {"window": -1}, ValueError
    with pytest.raises(exc):
        decode_attention(q, k, v, sp, cur, **kw)
