"""Wrapper of the fused exit-confidence CUDA kernels.

``exit_confidence(h, scale, w_out)`` dispatches on the tensors' device: CPU
tensors take the plain version (``ref.py``); CUDA tensors launch the kernels
(``exit_confidence.cu``, built at first use) or raise.  Nothing falls back
from one to the other.  ``exit_confidence.launches`` counts wrapper calls
that launched the kernels (plain-version calls do not count), so a run can
show that its main path went through them.

``plan(N, d, V, itemsize, aligned, resident)`` is the one owner of the
launch: the path, the tiles and each block's run of them, the ring's k
chunk and stages, the shared memory, and the scratch's regions.  Paths:

- ``"one"``: V <= ``TILE`` (the classifier's shapes): one launch, a block
  per ``ROWS`` rows, no partials;
- ``"bulk"``: W_out's rows on 16-byte boundaries (``V * itemsize % 16 ==
  0`` and an aligned pointer): a normalising launch, then W_out streamed
  through a ring of TMA copies by a grid of ``resident`` blocks (the card's
  SMs times the occupancy calculator's blocks an SM, ``resident``), whose
  last block folds the partials;
- ``"plain"``: other V: the same two launches, the ring filled with plain
  loads.

The wrapper makes one allocation (``plan``'s scratch: the outputs, hn, the
partials and the tickets) and passes everything in one packed struct
(``pack``).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref

SOURCE = pathlib.Path(__file__).with_name("exit_confidence.cu")
DTYPES = (torch.float32, torch.bfloat16)
PATHS = ("one", "bulk", "plain")
#: rows a block takes; columns a tile
ROWS = 8
TILE = 128
#: the widest d the kernels take
MAX_DIM = 32768
#: k rows a ring stage holds, by itemsize (a multiple of 16, at most 256:
#: 64 KB of W_out a stage at both widths); the ring's stages (at a full
#: chunk 64 KB in flight while a stage is read; at shorter chunks the
#: occupancy calculator fits more blocks an SM, which beat more stages on
#: an H100); the most stages the kernel takes
KC = {4: 128, 2: 256}
STAGES = 2
MAX_STAGES = 8
#: padded row of the block's logits in shared memory
RED_PITCH = TILE + 4
#: the scratch's regions, in the order of ``Launch`` in the source
REGIONS = ("out", "hn", "part_m", "part_l", "part_a", "ticket")
#: the kernels' arguments, packed into one struct (``Launch`` in the
#: source): h, scale, w_out, the scratch's regions, then the plan's
#: numbers (``Plan.numbers``), is_bf16, eps and the temperature
_LAUNCH = struct.Struct(f"<{3 + len(REGIONS)}Q14i2f")


def _cdiv(a, b):
    return -(-a // b)


def rows_aligned(V, itemsize, ptr):
    """W_out's rows start on 16-byte boundaries (what the bulk path's
    copies need): V % 8 == 0 in bf16, V % 4 == 0 in fp32, and an aligned
    pointer."""
    return (V * itemsize) % 16 == 0 and ptr % 16 == 0


def stream_smem(itemsize, kc, stages):
    """The streaming kernel's dynamic shared memory: alignment slack, W_out's
    ring, hn's ring, the tile's logits (4 warps' sums in fp32, one in bf16),
    the stages' barriers."""
    parts = 1 if itemsize == 2 else 4
    return (1024 + stages * (kc * TILE * itemsize + kc * 32)
            + parts * ROWS * RED_PITCH * 4 + 8 * stages)


class Plan(NamedTuple):
    path: str
    N: int
    d: int
    V: int
    groups: int      # blocks of ROWS rows (the grid's y)
    tiles: int       # TILE-column tiles of W_out (1 on the "one" path)
    kc: int          # k rows a ring stage holds (0 on the "one" path)
    chunks: int      # k chunks a tile: ceil(d / kc)
    stages: int      # ring stages
    blocks: int      # blocks a row group (the grid's x)
    run: int         # tiles a block: the first `extra` blocks take run + 1
    extra: int
    smem: int        # the streaming kernel's dynamic shared memory
    scratch: dict    # {region: (offset in 4-byte words, words)}
    scratch_words: int
    offsets: tuple   # each of REGIONS' offset (None: not in the scratch)
    numbers: tuple   # the plan's ints as ``Launch`` takes them

    @property
    def runs(self):
        """[first tile, tiles] of each block's run, in block order."""
        return [(b * self.run + min(b, self.extra),
                 self.run + (b < self.extra)) for b in range(self.blocks)]


@functools.lru_cache(maxsize=4096)
def plan(N, d, V, itemsize, aligned, resident):
    """The launch for h (N, d), w_out (d, V) of ``itemsize`` bytes;
    ``aligned``: W_out's rows start on 16-byte boundaries; ``resident``:
    streaming blocks the card holds at once (``resident()``)."""
    groups = _cdiv(N, ROWS)
    if V <= TILE:
        return _plan("one", N, d, V, groups, 1, 0, 0, 0, 1, 1, 0, 0,
                     {"out": (0, 4 * N)}, 4 * N)
    kc = min(KC[itemsize], _cdiv(d, 16) * 16)
    chunks = _cdiv(d, kc)
    tiles = _cdiv(V, TILE)
    # one wave: the row groups share the card
    blocks = min(tiles, max(1, resident // groups))
    run, extra = divmod(tiles, blocks)
    scratch, at = {}, 0
    for name, words in (("out", 4 * N),
                        ("hn", groups * chunks * kc * ROWS),
                        ("part_m", groups * blocks * ROWS),
                        ("part_l", groups * blocks * ROWS),
                        ("part_a", groups * blocks * ROWS),
                        ("ticket", groups)):
        if name == "hn":
            at = _cdiv(at, 4) * 4           # 16 bytes
        scratch[name] = (at, words)
        at += words
    return _plan("bulk" if aligned else "plain", N, d, V, groups, tiles, kc,
                 chunks, STAGES, blocks, run, extra,
                 stream_smem(itemsize, kc, STAGES), scratch, at)


def _plan(path, N, d, V, groups, tiles, kc, chunks, stages, blocks, run,
          extra, smem, scratch, words):
    return Plan(path, N, d, V, groups, tiles, kc, chunks, stages, blocks, run,
                extra, smem, scratch, words,
                tuple(scratch[name][0] if name in scratch else None
                      for name in REGIONS),
                (N, d, V, PATHS.index(path), groups, tiles, kc, chunks,
                 stages, blocks, run, extra, smem))


def pack(p, tensors, scratch, is_bf16, eps, temperature):
    """The kernels' arguments for plan ``p``: ``tensors`` the addresses of
    h, scale and w_out; ``scratch`` the address of a scratch of
    ``p.scratch_words`` 4-byte words, each region passed at its offset (0
    for a region the plan has not)."""
    return _LAUNCH.pack(*tensors, *[0 if o is None else scratch + 4 * o
                                    for o in p.offsets],
                        *p.numbers, is_bf16, eps, temperature)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    i = ctypes.c_int
    lib.exit_confidence_launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.exit_confidence_launch.restype = i
    lib.exit_confidence_blocks_per_sm.argtypes = [i, i, i]
    lib.exit_confidence_blocks_per_sm.restype = i
    lib.exit_confidence_error_string.argtypes = [i]
    lib.exit_confidence_error_string.restype = ctypes.c_char_p
    return lib, log


@functools.lru_cache(maxsize=None)
def resident(index, is_bf16, path, smem):
    """Blocks of the path's streaming kernel that card ``index`` holds at
    once: its SM count times the library's occupancy calculator.  One
    query a kernel and shared memory, then cached."""
    lib, _ = load_library()
    with build.on_device(torch.device("cuda", index)):
        per_sm = lib.exit_confidence_blocks_per_sm(is_bf16, PATHS.index(path),
                                                   smem)
    if per_sm < 1:
        raise RuntimeError(f"exit_confidence: no occupancy for the {path} "
                           f"path at {smem} bytes of shared memory")
    return build.sm_count(torch.device("cuda", index)) * per_sm


@functools.lru_cache(maxsize=4096)
def launch_plan(N, d, V, itemsize, aligned, index):
    """``plan`` with the streaming grid sized to card ``index``."""
    p = plan(N, d, V, itemsize, aligned, 1)
    if p.path == "one":
        return p
    return plan(N, d, V, itemsize, aligned,
                resident(index, itemsize == 2, p.path, p.smem))


def check(h, scale, w_out, *, kernel=False):
    """Raise on anything the wrapper does not take: h (N, d), scale (d,),
    w_out (d, V), all fp32 or all bf16, contiguous, on one device.
    ``kernel``: also what only the CUDA kernels need (d <= ``MAX_DIM``).
    Written to cost little host time on arguments it takes: every launch
    runs it."""
    dt = h.dtype
    if not (dt in DTYPES and scale.dtype == dt and w_out.dtype == dt
            and h.is_contiguous() and scale.is_contiguous()
            and w_out.is_contiguous()):
        for name, t in (("h", h), ("scale", scale), ("w_out", w_out)):
            if t.dtype not in DTYPES:
                raise TypeError(f"exit_confidence: {name} must be one of "
                                f"{DTYPES}, got {t.dtype}")
            if t.dtype != dt:
                raise TypeError(f"exit_confidence: {name} is {t.dtype}, h is "
                                f"{dt}; all three must share a dtype")
            if not t.is_contiguous():
                raise ValueError(f"exit_confidence: {name} must be "
                                 "contiguous")
    dev = h.device
    for name, t in (("scale", scale), ("w_out", w_out)):
        if t.device != dev:
            raise ValueError(f"exit_confidence: {name} is on {t.device}, "
                             f"h is on {dev}")
    if h.ndim != 2 or scale.ndim != 1 or w_out.ndim != 2 \
            or scale.shape[0] != h.shape[1] or w_out.shape[0] != h.shape[1] \
            or h.shape[0] < 1 or h.shape[1] < 1 or w_out.shape[1] < 1:
        raise ValueError("exit_confidence: want h (N, d), scale (d,), "
                         f"w_out (d, V); got {tuple(h.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(w_out.shape)}")
    if kernel and h.shape[1] > MAX_DIM:
        raise ValueError(f"exit_confidence: d={h.shape[1]} exceeds the "
                         f"kernel's limit of {MAX_DIM}")


def exit_confidence(h, scale, w_out, *, eps: float = 1e-6,
                    temperature: float = 1.0):
    """Fused RMSNorm → ``@ w_out / temperature`` → (conf, pred, max, lse).

    h: (N, d), scale: (d,), w_out: (d, V), all float32 or all bfloat16,
    contiguous on one device; the arithmetic is fp32 either way.  Returns
    float32 (conf (N,), pred (N,) int32, max_logit (N,), lse (N,))."""
    dev = h.device
    check(h, scale, w_out, kernel=dev.type == "cuda")
    if dev.type == "cpu":
        return exit_confidence_ref(h, scale, w_out, eps=eps,
                                   temperature=temperature)
    if dev.type != "cuda":
        raise ValueError(f"exit_confidence: no kernel for device {dev}")
    lib, _ = load_library()
    (N, d), V = h.shape, w_out.shape[1]
    itemsize = h.element_size()
    w = w_out.data_ptr()
    p = launch_plan(N, d, V, itemsize, rows_aligned(V, itemsize, w),
                    torch.cuda.current_device() if dev.index is None
                    else dev.index)
    with build.on_device(dev):
        buf = torch.empty(p.scratch_words, dtype=torch.float32, device=dev)
        rc = lib.exit_confidence_launch(
            pack(p, (h.data_ptr(), scale.data_ptr(), w), buf.data_ptr(),
                 itemsize == 2, eps, temperature),
            build.current_stream(dev))
    if rc != 0:
        raise RuntimeError("exit_confidence: kernel launch failed: "
                           f"{lib.exit_confidence_error_string(rc).decode()}"
                           f" (CUDA error {rc})")
    exit_confidence.launches += 1
    conf, pred, max_logit, lse = buf[:4 * N].view(4, N).unbind(0)
    return conf, pred.view(torch.int32), max_logit, lse


exit_confidence.launches = 0
