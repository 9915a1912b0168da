"""The port's exit-confidence function against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version (``ref.py``); it is held to
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests
run it) and to ``exit_stats_unfused``, with the JAX package's kernel-test
tolerances: conf atol 1e-5, max_logit / lse atol 1e-4, pred exact; in
fp32, and in bf16 as qwen3-4b's exit head holds its inputs.  The model of
the bf16 kernel's numerics (``exit_confidence_ref_split``: hn as bf16 hi +
lo) is held to the JAX kernel the same way.  What the CPU can check of the
launch is checked here: ``ops.plan`` (path, tiles and each block's run of
them, the ring, the scratch) and what ``ops.pack`` hands the kernels.  The
CUDA kernels themselves are held to the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.exit_confidence import exit_confidence as jax_exit_kernel
from repro.models import exit_stats_unfused as jax_exit_unfused
from repro_torch.kernels import build
from repro_torch.kernels.exit_confidence import ops
from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref_split

CONF_ATOL, STAT_ATOL = 1e-5, 1e-4


def _inputs(n, d, v, seed, ties=()):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (0.02 * rng.standard_normal((d, v))).astype(np.float32)
    if ties:
        # the tied columns share the largest logit exactly (one nonzero
        # product), so the first of them must be the argmax
        h[:, 0] = 4.0
        scale[0] = 0.0
        for c in ties:
            w[:, c] = 0.0
            w[0, c] = 1.0
    return h, scale, w


def _port(h, scale, w, temperature=1.0):
    out = exit_confidence(torch.from_numpy(h), torch.from_numpy(scale),
                          torch.from_numpy(w), temperature=temperature)
    return [o.numpy() for o in out]


def _assert_close(port, ref):
    conf, pred, m, lse = port
    np.testing.assert_allclose(conf, np.asarray(ref[0]), rtol=0,
                               atol=CONF_ATOL)
    np.testing.assert_array_equal(pred, np.asarray(ref[1]))
    assert pred.dtype == np.int32
    np.testing.assert_allclose(m, np.asarray(ref[2]), rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(lse, np.asarray(ref[3]), rtol=0,
                               atol=STAT_ATOL)


@pytest.mark.parametrize("temperature", (1.0, 2.0))
@pytest.mark.parametrize("v", (10, 1000))
@pytest.mark.parametrize("d", (32, 128))
@pytest.mark.parametrize("n", (1, 3, 8, 13))
def test_plain_matches_jax_unfused(n, d, v, temperature):
    h, scale, w = _inputs(n, d, v, seed=n * 1000 + d + v)
    ref = jax_exit_unfused(h, scale, w, temperature=temperature)
    _assert_close(_port(h, scale, w, temperature), ref)


@pytest.mark.parametrize("n,d,v,temperature", [
    (1, 32, 10, 1.0), (3, 128, 1000, 2.0), (8, 32, 1000, 1.0),
    (13, 128, 10, 2.0), (13, 32, 1000, 2.0), (8, 128, 10, 1.0)])
def test_plain_matches_jax_kernel_interpret(n, d, v, temperature):
    h, scale, w = _inputs(n, d, v, seed=7 + n + d + v)
    ref = jax_exit_kernel(h, scale, w, temperature=temperature,
                          block_v=512, interpret=True)
    _assert_close(_port(h, scale, w, temperature), ref)


@pytest.mark.parametrize("ties", [(100, 300), (100, 700), (600, 900, 950)],
                         ids=["in-block", "cross-block", "later-block"])
def test_ties_take_first_index_like_jax_kernel(ties):
    h, scale, w = _inputs(13, 128, 1000, seed=3, ties=ties)
    ref = jax_exit_kernel(h, scale, w, block_v=512, interpret=True)
    port = _port(h, scale, w)
    _assert_close(port, ref)
    assert (port[1] == ties[0]).all()


@pytest.mark.parametrize("n,d,v", [(1, 32, 10), (8, 128, 1000),
                                   (13, 64, 517)])
def test_bf16_plain_matches_jax_kernel_interpret(n, d, v):
    """bf16 h, scale and w_out (as qwen3-4b's head holds them): both
    packages compute in fp32 from the same bf16 values and return fp32."""
    h, scale, w = _inputs(n, d, v, seed=50 + n + d + v)
    port = exit_confidence(*(torch.from_numpy(a).bfloat16()
                             for a in (h, scale, w)))
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    ref = jax_exit_kernel(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (h, scale, w)),
                          block_v=512, interpret=True)
    _assert_close([o.numpy() for o in port], ref)


def test_cpu_wrapper_leaves_launch_count():
    before = ops.exit_confidence.launches
    _port(*_inputs(4, 32, 10, seed=0))
    assert ops.exit_confidence.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "noncontiguous",
                                 "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, scale, w = (torch.from_numpy(a) for a in _inputs(4, 32, 10, seed=0))
    if bad == "dtype":
        h, exc = h.double(), TypeError
    elif bad == "mixed":
        w, exc = w.bfloat16(), TypeError
    elif bad == "noncontiguous":
        h, exc = torch.cat([h, h], dim=1)[:, ::2], ValueError
    else:
        w, exc = w[:16].contiguous(), ValueError
    with pytest.raises(exc):
        exit_confidence(h, scale, w)


@pytest.mark.parametrize("n,d,v,ties", [
    (1, 32, 10, ()), (8, 128, 1000, ()), (13, 64, 517, ()),
    (3, 200, 1000, ()), (13, 128, 1000, (100, 700)),
    (8, 128, 1000, (300, 301, 900))],
    ids=["n1", "n8", "n13-ragged-v", "d200", "ties-cross-block",
         "ties-adjacent"])
def test_split_model_matches_jax_kernel_interpret(n, d, v, ties):
    """The bf16 kernel's numerics (hn as bf16 hi + lo, W_out exact) held to
    the JAX kernel on the same bf16 inputs; tied columns give the first."""
    h, scale, w = _inputs(n, d, v, seed=90 + n + d + v, ties=ties)
    port = exit_confidence_ref_split(*(torch.from_numpy(a).bfloat16()
                                       for a in (h, scale, w)))
    ref = jax_exit_kernel(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (h, scale, w)),
                          block_v=512, interpret=True)
    _assert_close([o.numpy() for o in port], ref)
    if ties:
        assert (port[1].numpy() == ties[0]).all()


def test_split_model_holds_hn_to_about_2_to_the_minus_17():
    """hi + lo is within 2^-16 of hn relative to |hn| (hi carries 8 bits,
    lo the next 8), where bf16 alone is 2^-8 off."""
    rng = np.random.default_rng(5)
    hn = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = hn.bfloat16().float()
    lo = (hn - hi).bfloat16().float()
    assert float(((hi + lo - hn).abs() / hn.abs()).max()) <= 2.0 ** -16
    assert float(((hi - hn).abs() / hn.abs()).max()) > 2.0 ** -12


def test_cpu_tensor_never_loads_the_kernel(monkeypatch):
    def refuse(_source):
        raise AssertionError("a CPU tensor must not build or load the "
                             "kernel")
    monkeypatch.setattr(build, "load", refuse)
    before = ops.exit_confidence.launches
    _port(*_inputs(4, 32, 1000, seed=0))
    exit_confidence(*(torch.from_numpy(a).bfloat16()
                      for a in _inputs(3, 32, 10, seed=1)))
    assert ops.exit_confidence.launches == before


def test_kernel_check_rejects_only_past_the_widest_d():
    """d up to ``MAX_DIM`` (at least the 7 200 of the first kernel) is
    taken; one past it only the kernel refuses, the CPU route takes it."""
    assert ops.MAX_DIM >= 7200
    for d, ok in ((ops.MAX_DIM, True), (ops.MAX_DIM + 1, False)):
        h, scale = torch.zeros(1, d), torch.zeros(d)
        w = torch.zeros(d, 2)
        ops.check(h, scale, w)
        if ok:
            ops.check(h, scale, w, kernel=True)
        else:
            with pytest.raises(ValueError):
                ops.check(h, scale, w, kernel=True)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("V,aligned,path", [
    (1, True, "one"), (10, True, "one"), (ops.TILE, True, "one"),
    (ops.TILE, False, "one"), (ops.TILE + 1, False, "plain"),
    (ops.TILE + 8, True, "bulk"), (ops.TILE + 8, False, "plain"),
    (151936, True, "bulk"), (151935, False, "plain")])
def test_plan_chooses_the_path(itemsize, V, aligned, path):
    """One tile of columns or fewer: one launch; above it the bulk-copy
    ring where W_out's rows start on 16-byte boundaries, plain loads
    elsewhere; the same for any d and both dtypes."""
    for d in (32, 2560, ops.MAX_DIM):
        assert ops.plan(8, d, V, itemsize, aligned, 132).path == path


def test_rows_aligned_follows_the_dtype_and_the_pointer():
    """The wrapper's test for 16-byte rows: V % 8 == 0 in bf16, V % 4 == 0
    in fp32, and W_out's address on a 16-byte boundary."""
    for V, itemsize, ptr, want in ((151936, 2, 0x1000, True),
                                   (1004, 2, 0x1000, False),
                                   (1004, 4, 0x1000, True),
                                   (1001, 4, 0x1000, False),
                                   (151936, 2, 0x1008, False),
                                   (1004, 4, 0x1004, False)):
        assert ops.rows_aligned(V, itemsize, ptr) == want


@pytest.mark.parametrize("N,d,V,itemsize,resident", [
    (8, 2560, 151936, 2, 132), (1, 2560, 151936, 2, 132),
    (8, 2560, 151936, 4, 132), (13, 128, 1000, 4, 132),
    (13, 2600, 40000, 2, 132), (3, 32768, 1024, 2, 264),
    (8, 100, 129, 4, 132), (20, 64, 5000, 2, 7)])
def test_plan_covers_every_column_once_in_balanced_runs(N, d, V, itemsize,
                                                        resident):
    """Every tile of W_out in exactly one block's run, runs in block order
    and within one tile of each other; the k chunks cover d; one wave: the
    row groups' blocks together fit what the card holds."""
    p = ops.plan(N, d, V, itemsize, True, resident)
    assert p.groups == -(-N // ops.ROWS)
    assert p.tiles * ops.TILE >= V > (p.tiles - 1) * ops.TILE
    runs = p.runs
    assert len(runs) == p.blocks
    covered = [t for first, n in runs for t in range(first, first + n)]
    assert covered == list(range(p.tiles))
    sizes = {n for _, n in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert p.blocks == min(p.tiles, max(1, resident // p.groups))
    assert p.kc % 16 == 0 and 16 <= p.kc <= 256
    assert p.chunks * p.kc >= d > (p.chunks - 1) * p.kc


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [16, 100, 2560, 2600, 7200, ops.MAX_DIM])
def test_plan_ring_fits_and_keeps_bytes_in_flight(itemsize, d):
    """The ring fits a block's 227 KB of shared memory with the logits
    and barriers; at a full chunk it holds at least 64 KB of W_out beyond
    the stage being read; kc stays a multiple of 16 up to 256."""
    p = ops.plan(8, d, 151936, itemsize, True, 132)
    assert p.smem == ops.stream_smem(itemsize, p.kc, p.stages)
    assert p.smem <= 227 * 1024
    assert 2 <= p.stages <= ops.MAX_STAGES
    w_stage = p.kc * ops.TILE * itemsize
    if p.kc == ops.KC[itemsize]:
        assert (p.stages - 1) * w_stage >= 64 * 1024


@pytest.mark.parametrize("N,d,V,itemsize", [
    (8, 2560, 151936, 2), (13, 2600, 1000, 4), (1, 32, 10, 4),
    (13, 128, 10, 2)])
def test_pack_hands_the_kernels_the_plan_and_its_scratch(N, d, V, itemsize):
    """What the kernels receive (``ops.pack``): h, scale and w_out in
    order, each scratch region at the base plus its ``ops.plan`` offset (0
    for a region the one-launch path has not), hn on a 16-byte boundary
    with chunks * kc * 8 words a row group, ROWS partials a block, one
    ticket a group; then the plan's numbers, eps and the temperature; the
    regions lie one after another inside ``scratch_words``."""
    p = ops.plan(N, d, V, itemsize, True, 132)
    base = 0x100000
    got = ops._LAUNCH.unpack(ops.pack(p, (0x1000, 0x2000, 0x3000), base,
                                      itemsize == 2, 1e-6, 2.0))
    assert got[:3] == (0x1000, 0x2000, 0x3000)
    regions = dict(zip(ops.REGIONS, got[3:3 + len(ops.REGIONS)]))
    for name in ops.REGIONS:
        assert regions[name] == (base + 4 * p.scratch[name][0]
                                 if name in p.scratch else 0)
    assert p.scratch["out"] == (0, 4 * N)
    if p.path == "one":
        assert set(p.scratch) == {"out"} and p.scratch_words == 4 * N
    else:
        want = {"hn": p.groups * p.chunks * p.kc * ops.ROWS,
                "part_m": p.groups * p.blocks * ops.ROWS,
                "part_l": p.groups * p.blocks * ops.ROWS,
                "part_a": p.groups * p.blocks * ops.ROWS,
                "ticket": p.groups}
        assert {k: n for k, (_, n) in p.scratch.items() if k != "out"} == want
        assert regions["hn"] % 16 == 0
        spans = sorted(p.scratch.values())
        for (at, n), (nxt, _) in zip(spans, spans[1:]):
            assert at + n <= nxt
        assert spans[-1][0] + spans[-1][1] == p.scratch_words
    ints = got[3 + len(ops.REGIONS):-2]
    assert list(ints) == [N, d, V, ops.PATHS.index(p.path), p.groups,
                          p.tiles, p.kc, p.chunks, p.stages, p.blocks, p.run,
                          p.extra, p.smem, int(itemsize == 2)]
    assert got[-2] == pytest.approx(1e-6) and got[-1] == 2.0
