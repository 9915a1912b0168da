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
(atol = rtol); at L 256 and dh 1024 an fp32 h is held against float64
scaled by its row's condition number, as the card check holds it.  The
kernels' grids and scratch (``ops.plan``) and the arguments they receive
(``ops.pack``) are checked here; the CUDA kernels themselves are held to
the plain version on the card by ``tests/test_torch_gpu.py``.
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


@pytest.mark.parametrize("L,dh", [(8, 12), (8, 1032), (513, 8)])
def test_kernel_check_rejects_what_only_the_kernel_refuses(L, dh):
    """dh not a multiple of 8 or above 1024, or L above 512, checked
    without a card by the wrapper's checking function; the plain version
    takes them."""
    args = [torch.from_numpy(a) for a in _inputs(1, 1, L, dh, seed=0)]
    ops.check(*args)
    with pytest.raises(ValueError, match="the kernel takes"):
        ops.check(*args, kernel=True)
    assert mlstm_chunk(*args)[0].shape == (1, 1, L, dh)


@pytest.mark.parametrize("L,dh", [(8, 128), (8, 1024), (256, 8),
                                  (512, 72)])
def test_kernel_check_takes_wide_heads_and_long_chunks(L, dh):
    """dh 128 and xlstm-1.3b's 1024, L 256 and 512, and dh 72 (a multiple
    of 8, not of the 64-wide tile) pass the kernel's own check."""
    args = [torch.from_numpy(a).clone() for a in _inputs(1, 1, L, dh, seed=0)]
    ops.check(*args, kernel=True)
    assert (ops.KERNEL_MAX_DH, ops.KERNEL_MAX_L) == (1024, 512)


@pytest.mark.parametrize("B,H,L,dh", [(1, 2, 256, 128), (1, 1, 16, 1024)])
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_at_wide_heads(B, H, L, dh, fresh, dtype):
    """The plain version against the JAX kernel (interpret mode) at L 256
    with dh 128 and at xlstm-1.3b's dh 1024: C1, n1, m1 and a bf16 h
    elementwise at fp32 2e-5 / bf16 8e-2.  An fp32 h is held as
    ``chip_smoke._mlstm_compare`` holds the card's: both fp32 evaluations
    (the plain version's and the JAX kernel's) against the plain version in
    float64, at 2e-5 (1 + |h64|) times each row's condition number capped
    at 16 (the normaliser cancels: rows reach a condition of 10^3 here, and
    the two fp32 h differ by 8e-5 relative at L 256)."""
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_condition
    arrays = _inputs(B, H, L, dh, seed=13, fresh=fresh)
    port = _port(arrays, dtype)
    ref = jax_kernel(*_jax(arrays, dtype))
    tol = TOL[dtype]
    _assert_close(port[1:], ref[1:], tol)
    if dtype == "bfloat16":
        _assert_close(port[:1], ref[:1], tol)
        return
    t = [torch.from_numpy(a) for a in arrays]
    h64 = ops.mlstm_chunk_ref(*(x.double() for x in t))[0]
    kappa = mlstm_chunk_condition(t[0], t[1], t[3], t[4], t[6], t[7])
    allowed = tol * (1 + h64.abs()) * kappa.clamp(max=16.0)[..., None]
    for h in (port[0].double(),
              torch.from_numpy(np.asarray(ref[0], np.float64))):
        assert bool(((h - h64).abs() <= allowed).all())


@pytest.mark.parametrize("fresh", [True, False])
def test_jax_kernel_at_the_longest_chunk_is_within_tolerance_of_float64(
        fresh):
    """At L 512 (dh 64, fp32), the longest chunk the port's kernel takes,
    ``chip_smoke.py`` holds the kernel to the plain version run in float64
    instead of the fp32 plain version, whose own C1 on the card is off
    float64 by more than the tolerance (``MLSTM_FP32_REF_MAX_L``).  The
    reference's fp32 arithmetic agrees with float64 there: the JAX kernel
    (interpret mode) gives C1, n1 and m1 within 2e-5 of the plain version
    in float64, and h within 2e-5 (1 + |h64|) times its row's condition
    number capped at 16, as the card's h is held.  The plain version in
    fp32 on the CPU is held the same way, and to the JAX kernel at 2e-5."""
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_condition
    arrays = _inputs(1, 1, 512, 64, seed=13, fresh=fresh)
    port = _port(arrays)
    ref = jax_kernel(*_jax(arrays))
    _assert_close(port[1:], ref[1:], TOL["float32"])
    t = [torch.from_numpy(a) for a in arrays]
    want = ops.mlstm_chunk_ref(*(x.double() for x in t))
    kappa = mlstm_chunk_condition(t[0], t[1], t[3], t[4], t[6], t[7])
    allowed = TOL["float32"] * (1 + want[0].abs()) \
        * kappa.clamp(max=16.0)[..., None]
    for got in (port, [torch.from_numpy(np.array(r)) for r in ref]):
        _assert_close([x.double() for x in got[1:]], want[1:],
                      TOL["float32"])
        assert bool(((got[0].double() - want[0]).abs() <= allowed).all())


@pytest.mark.parametrize("B,H,L,dh", [(1, 1, 1, 8), (2, 4, 128, 64),
                                      (1, 2, 100, 64), (1, 4, 128, 1024),
                                      (1, 2, 200, 72), (3, 1, 512, 8),
                                      (1, 1, 17, 264)])
def test_plan_tiles_cover_every_row_and_column_once(B, H, L, dh):
    """The kernels' grids from ``ops.plan``: the scores blocks' 16-row
    tiles, the h tiles' rows and columns, the state tiles' (d, j) and the
    n1 blocks' columns each cover every index of their range exactly once,
    and no tile starts past the end."""
    p = ops.plan(B, H, L, dh)
    assert p.BH == B * H and (p.L, p.dh) == (L, dh)

    def cover(tiles, size, n):
        starts = [i * size for i in range(tiles)]
        assert all(s < n for s in starts)
        hits = [i for s in starts for i in range(s, min(s + size, n))]
        assert sorted(hits) == list(range(n))

    cover(p.row_tiles, ops.SCORE_ROWS, L)
    cover(p.t_tiles, ops.TILE, L)
    cover(p.d_tiles, ops.TILE, dh)
    cover(p.n1_blocks, ops.N1_COLUMNS, dh)
    cover(p.h_parts, ops.H_PART, dh)
    cover(p.k_parts, ops.SCORE_DPART, dh)
    assert p.output_blocks == p.BH * (p.t_tiles * p.d_tiles * p.h_parts
                                      + p.d_tiles ** 2 + p.n1_blocks)
    # the third launch: only when h comes in parts, 4 columns a thread
    assert (p.finish_blocks == 0) == (p.h_parts == 1)
    if p.finish_blocks:
        assert (p.finish_blocks - 1) * 1024 < p.BH * L * dh \
            <= p.finish_blocks * 1024


@pytest.mark.parametrize("B,H,L,dh", [(1, 1, 1, 8), (2, 4, 128, 64),
                                      (1, 2, 201, 72), (1, 4, 128, 1024),
                                      (1, 1, 3, 8), (3, 1, 5, 264)])
def test_plan_scratch_matches_the_shapes(B, H, L, dh):
    """The scratch holds W's row sums by column tile (BH, L, t_tiles), the
    state's part of the normaliser (BH, L) and, above dh 256, the scores
    parts' dot products and q . n0 in fp64, then, from a 16-byte
    boundary, W (BH, L, LP) with LP = L rounded up to 4 (16-byte rows),
    floor, inter, ws (BH, L) and decay (BH,), back to back, and above dh
    256, from a 16-byte boundary, h's numerator by part."""
    p = ops.plan(B, H, L, dh)
    BH = B * H
    assert p.LP % 4 == 0 and L <= p.LP < L + 4
    want = [("part", (BH, L, p.t_tiles), torch.float64),
            ("nq0", (BH, L), torch.float64)]
    if dh > ops.SCORE_DPART:
        want += [("pdot", (BH, p.row_tiles, p.t_tiles, p.k_parts, 16, 64),
                  torch.float64),
                 ("pqn", (BH, p.row_tiles, p.k_parts, 16), torch.float64)]
    want += [("W", (BH, L, p.LP), None), ("floor", (BH, L), None),
             ("inter", (BH, L), None), ("ws", (BH, L), None),
             ("decay", (BH,), None)]
    if dh > ops.H_PART:
        want.append(("hnum", (p.h_parts, BH, L, dh), None))
    assert list(p.scratch) == [w[0] for w in want]
    at = 0
    for (name, shape, dt), (got_name, (off, got_shape, got_dt)) in zip(
            want, p.scratch.items()):
        if name in ("W", "hnum"):
            at = -(-at // 4) * 4            # 16 bytes
        assert (got_name, off, got_shape) == (name, at, shape)
        assert got_dt == (dt or torch.float32)
        at += int(np.prod(shape)) * (2 if dt == torch.float64 else 1)
    assert p.scratch_floats == at


@pytest.mark.parametrize("B,H,L,dh", [(1, 1, 1, 8), (2, 4, 128, 64),
                                      (1, 4, 128, 1024), (3, 1, 5, 264)])
@pytest.mark.parametrize("is_bf16", [False, True])
def test_pack_passes_each_region_at_its_plan_offset(B, H, L, dh, is_bf16):
    """What the kernels receive (``ops.pack``): the twelve tensor addresses
    in order, each scratch region at the base plus its ``ops.plan`` offset
    (0 for a region the plan has not: ``pdot``/``pqn`` up to dh 256,
    ``hnum`` up to dh 256), then the sizes, the dtype flag and the plan's
    grid, the output and finish launches' blocks included."""
    p = ops.plan(B, H, L, dh)
    tensors = [0x1000 * (i + 1) for i in range(12)]
    base = 0x100000
    got = ops._LAUNCH.unpack(ops.pack(p, tensors, base, is_bf16))
    assert list(got[:12]) == tensors
    absent = ({"pdot", "pqn"} if dh <= ops.SCORE_DPART else set()) \
        | ({"hnum"} if dh <= ops.H_PART else set())
    assert set(ops.REGIONS) - set(p.scratch) == absent
    regions = dict(zip(ops.REGIONS, got[12:12 + len(ops.REGIONS)]))
    for name in ops.REGIONS:
        assert regions[name] == (base + 4 * p.scratch[name][0]
                                 if name in p.scratch else 0)
    assert list(got[12 + len(ops.REGIONS):]) == [
        B * H, L, dh, p.LP, int(is_bf16), p.row_tiles, p.t_tiles,
        p.d_tiles, p.n1_blocks, p.h_parts, p.k_parts, p.output_blocks,
        p.finish_blocks]
