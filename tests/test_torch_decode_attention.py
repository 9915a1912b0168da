"""The port's decode-attention function against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) over the sweep of ``tests/test_kernels.py`` (shapes, fp32 and bf16,
window None and 8, ring semantics), plus ragged positions within a batch
and a row with no valid slot, which both kernels answer with zeros.  Rows
with at least one valid slot are also held to the JAX package's
``decode_attention_ref``.  Tolerances are those of ``tests/test_kernels.py``:
fp32 2e-5, bf16 2e-2 (atol = rtol).  The CUDA kernels split the slots
across blocks and combine the splits; their plain model,
``decode_attention_split_ref``, is held to the Pallas kernel over the same
sweep at several split lengths, including splits with no valid slot, a
ring whose valid slots straddle splits, an empty row and S not a multiple
of the split, and its rows are checked to be bitwise those of singleton
calls.  The CUDA kernels themselves are held to the plain version on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_kernel
from repro.kernels.decode_attention import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

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


def _split_vs_jax(q, k, v, sp, cur, dtype, split, **kw):
    """The split model on ``dtype`` inputs against the Pallas kernel at the
    tolerance; returns the model's output (fp32 numpy)."""
    args = [torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)]
    model = decode_attention_split_ref(*args, torch.from_numpy(sp),
                                       torch.from_numpy(cur), split=split,
                                       **kw)
    assert model.dtype == TORCH[dtype] and model.shape == q.shape
    ref = jax_kernel(*(jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v)),
                     jnp.asarray(sp), jnp.asarray(cur), block_k=16,
                     interpret=True, **kw)
    tol = TOL[dtype]
    model = model.float().numpy()
    np.testing.assert_allclose(model, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)
    return model


@pytest.mark.parametrize("B,H,KV,S,dh", [
    (2, 4, 2, 40, 32),
    (1, 8, 8, 64, 16),
    (3, 6, 1, 33, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("split", [8, 16, 256])
def test_split_model_matches_jax_kernel_sweep(B, H, KV, S, dh, dtype, window,
                                              split):
    """``tests/test_kernels.py``'s sweep (the last three slots unwritten,
    rows at positions 10, 17, 24) through the split model: with split 8 the
    splits past a row's position hold no valid slot, S 33 and 40 are not
    multiples of 8 or 16, and 256 is the kernel's split (one split)."""
    slot_pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    slot_pos[:, -3:] = -1
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=2, slot_pos=slot_pos,
                               cur=np.arange(B) * 7 + 10)
    _split_vs_jax(q, k, v, sp, cur, dtype, split, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_ring_straddling_splits_and_empty_row(dtype):
    """Row 0 has no valid slot (zeros); row 1 is a ring whose valid slots
    (positions 20..39 of 24 slots, slots 0..15 rewritten) straddle the
    splits of 8 with non-monotonic slot_pos; row 2 has written only slots
    0..4, so two of its three splits hold no valid slot."""
    B, H, KV, S, dh = 3, 4, 2, 24, 32
    slots = np.arange(S)
    slot_pos = np.stack([np.full(S, -1),
                         np.where(slots < 16, slots + S, slots),
                         np.where(slots < 5, slots, -1)])
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=7, slot_pos=slot_pos,
                               cur=[0, 39, 4])
    model = _split_vs_jax(q, k, v, sp, cur, dtype, 8)
    assert not model[0].any()
    model_w = _split_vs_jax(q, k, v, sp, cur, dtype, 8, window=10)
    assert not model_w[0].any()


@pytest.mark.parametrize("split", [8, 256])
def test_split_model_rows_equal_singleton_calls_bitwise(split):
    """A row's result from a batched call of the split model is bitwise
    the result of the row called alone (ragged lengths, an empty row, a
    ring), and within the fp32 tolerance of the plain version."""
    B, H, KV, S, dh = 5, 8, 2, 40, 32
    rng = np.random.default_rng(8)
    slots = np.arange(S)
    lens = np.array([0, 3, 17, 40, 29])
    slot_pos = np.where(slots[None] < lens[:, None], slots, -1)
    slot_pos[4] = np.where(slots < 9, slots + S, slots)        # a ring
    cur = np.maximum(lens - 1, 0)
    cur[4] = S + 8
    q, k, v, sp, cur = _inputs(B, H, KV, S, dh, seed=9, slot_pos=slot_pos,
                               cur=cur)
    for dtype in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
        t += [torch.from_numpy(sp), torch.from_numpy(cur)]
        window = int(rng.integers(4, 12)) if dtype == torch.bfloat16 \
            else None
        batched = decode_attention_split_ref(*t, split=split, window=window)
        for b in range(B):
            alone = decode_attention_split_ref(*(a[b:b + 1] for a in t),
                                               split=split, window=window)
            assert torch.equal(batched[b], alone[0]), b
        if dtype == torch.float32:
            plain = decode_attention_ref(*t)
            np.testing.assert_allclose(batched.numpy(), plain.numpy(),
                                       atol=2e-5, rtol=2e-5)


def test_kernel_check_rejects_what_only_the_kernel_refuses():
    """Head dim 24 and a cache that does not start on a 16-byte boundary
    (the kernels' bulk copies need it), checked without a card; the plain
    version takes both."""
    q, k, v, sp, cur = (torch.from_numpy(a) for a in _inputs(
        1, 2, 1, 8, 24, seed=0, slot_pos=[list(range(8))], cur=[7]))
    ops.check(q, k, v, sp, cur, None)
    with pytest.raises(ValueError, match="head dim 24"):
        ops.check(q, k, v, sp, cur, None, kernel=True)
    assert decode_attention(q, k, v, sp, cur).shape == q.shape
    q, k, v, sp, cur = (torch.from_numpy(a) for a in _inputs(
        1, 2, 1, 8, 16, seed=0, slot_pos=[list(range(8))], cur=[7]))
    flat = torch.zeros(k.numel() + 1)
    shifted = flat[1:].view(k.shape)
    shifted.copy_(k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ops.check(q, k, v, sp, cur, None, kernel=True)
    with pytest.raises(ValueError, match="16-byte"):
        ops.check(q, shifted, v, sp, cur, None, kernel=True)
    assert torch.equal(decode_attention(q, shifted, v, sp, cur),
                       decode_attention(q, k, v, sp, cur))
