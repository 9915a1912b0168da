"""Wrapper of the mLSTM chunk CUDA kernels.

``mlstm_chunk(q, k, v, i_pre, f_pre, C0, n0, m0)`` dispatches on the
tensors' device: CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernels (``mlstm_chunk.cu``, built at first use) or
raise.  Nothing falls back from one to the other.  The gates and the state
are cast to contiguous fp32 first, as the JAX wrapper casts the state.
``mlstm_chunk.launches`` counts wrapper calls that launched the kernels
(plain-version calls do not count).

On the card a call is two to four launches: a scores pass, grid (B·H,
ceil(L / ``SCORE_ROWS``), ceil(L / ``TILE``)), writing W, its row sums and
the gate factors to a scratch; then an output pass of h tiles, state tiles
(``TILE`` × ``TILE`` each) and n1 blocks.  Above dh ``H_PART`` each h tile
comes in parts along C0's rows, and a last launch adds them; above dh
``SCORE_DPART`` the scores pass runs in parts of dh, and a combine launch
adds them before the output pass.  ``plan(B, H, L, dh)`` gives the grids
and the scratch's layout, the one place either is worked out: the wrapper
allocates the scratch and passes the kernels each region's address and
the grid (``pack``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

SOURCE = pathlib.Path(__file__).with_name("mlstm_chunk.cu")
DTYPES = (torch.float32, torch.bfloat16)
#: the head dims (multiples of 8) and the chunk lengths the kernels take
KERNEL_MAX_DH = 1024
KERNEL_MAX_L = 512
#: W rows a scores block; rows and columns of an h or state tile; columns
#: of k an n1 block sums; rows of C0 an h tile takes (above it, h tiles
#: come in parts and a last launch adds them)
SCORE_ROWS = 16
TILE = 64
N1_COLUMNS = 128
H_PART = 256
#: d a scores block takes: above it the scores pass runs in parts of dh
#: and a combine launch adds them
SCORE_DPART = 256
#: the scratch's regions, in the order of ``Scratch`` in the source
REGIONS = ("part", "nq0", "pdot", "pqn", "W", "floor", "inter", "ws",
           "decay", "hnum")
#: the kernels' arguments, packed into one struct (``Launch`` in the
#: source): 12 tensor pointers, the scratch's regions, then BH, L, dh, LP,
#: is_bf16 and the plan's grid
_LAUNCH = struct.Struct(f"<{12 + len(REGIONS)}Q13i")


def _cdiv(a, b):
    return -(-a // b)


class Plan(NamedTuple):
    BH: int
    L: int
    dh: int
    LP: int          # W's row stride: L rounded up to a multiple of 4
    row_tiles: int   # scores grid (BH, row_tiles, t_tiles): 16 x 64 tiles
    t_tiles: int     # h tiles (BH, t_tiles, d_tiles, h_parts); W's column
    d_tiles: int     # tiles; state tiles (BH, d_tiles, d_tiles)
    n1_blocks: int   # n1 blocks (BH, n1_blocks), N1_COLUMNS columns each
    h_parts: int     # parts of C0's rows an h tile is split into
    k_parts: int     # parts of dh a scores tile is split into
    output_blocks: int   # the output pass: h tiles (each in h_parts
                         # parts), then state tiles, then n1 blocks
    finish_blocks: int   # the third launch (4 columns of h a thread, 256
                         # threads a block), 0 when h comes in one part
    scratch: dict    # {region: (offset in fp32 units, shape, dtype)}
    scratch_floats: int  # size of the scratch in fp32 units


@functools.lru_cache(maxsize=1024)
def plan(B, H, L, dh):
    """Grids and scratch of the launches for q (B, H, L, dh).  The kernels
    take both from here: the grid in the packed arguments, each region of
    the scratch as a pointer.

    The scratch, in order: W's row sums by column tile ``part`` (BH, L,
    t_tiles), the state's part of the normaliser ``nq0`` (BH, L) and, with
    dh in parts, the parts' dot products ``pdot`` (BH, row_tiles, t_tiles,
    k_parts, 16, 64) and q . n0 ``pqn`` (BH, row_tiles, k_parts, 16) in
    fp64; then in fp32, from a 16-byte boundary, W (BH, L, LP), ``floor``
    exp(-m), ``inter`` exp(m0 - g), ``ws`` exp(u - g_L) (BH, L), ``decay``
    (BH,) and, from a 16-byte boundary, h's numerator by part ``hnum``
    (h_parts, BH, L, dh) when there is more than one part."""
    BH, LP = B * H, _cdiv(L, 4) * 4
    R, T, D = _cdiv(L, SCORE_ROWS), _cdiv(L, TILE), _cdiv(dh, TILE)
    N1, HP, KP = _cdiv(dh, N1_COLUMNS), _cdiv(dh, H_PART), \
        _cdiv(dh, SCORE_DPART)
    scratch, at = {}, 0
    f64, f32 = torch.float64, torch.float32
    regions = [("part", (BH, L, T), f64), ("nq0", (BH, L), f64)]
    if KP > 1:
        regions += [("pdot", (BH, R, T, KP, SCORE_ROWS, TILE), f64),
                    ("pqn", (BH, R, KP, SCORE_ROWS), f64)]
    regions += [("W", (BH, L, LP), f32), ("floor", (BH, L), f32),
                ("inter", (BH, L), f32), ("ws", (BH, L), f32),
                ("decay", (BH,), f32)]
    if HP > 1:
        regions.append(("hnum", (HP, BH, L, dh), f32))
    for name, shape, dtype in regions:
        if name in ("W", "hnum"):
            at = _cdiv(at, 4) * 4           # 16 bytes
        scratch[name] = (at, shape, dtype)
        at += math.prod(shape) * (2 if dtype is f64 else 1)
    return Plan(BH, L, dh, LP, R, T, D, N1, HP, KP,
                BH * (T * D * HP + D * D + N1),
                _cdiv(BH * L * dh // 4, 256) if HP > 1 else 0, scratch, at)


def pack(p, tensors, scratch, is_bf16):
    """The kernels' arguments for plan ``p``: ``tensors`` the addresses of
    q, k, v, i_pre, f_pre, C0, n0, m0, h, C1, n1, m1; ``scratch`` the
    address of a scratch of ``p.scratch_floats`` fp32 values, each region
    passed at its offset (0 for a region the plan has not)."""
    regions = [scratch + 4 * p.scratch[name][0] if name in p.scratch else 0
               for name in REGIONS]
    return _LAUNCH.pack(*tensors, *regions, p.BH, p.L, p.dh, p.LP, is_bf16,
                        p.row_tiles, p.t_tiles, p.d_tiles, p.n1_blocks,
                        p.h_parts, p.k_parts, p.output_blocks,
                        p.finish_blocks)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mlstm_chunk_launch.argtypes = [ctypes.c_char_p, vp]
    lib.mlstm_chunk_launch.restype = i
    lib.mlstm_chunk_error_string.argtypes = [i]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
    return lib, log


def check(q, k, v, i_pre, f_pre, C0, n0, m0, *, kernel=False):
    """Raise on anything the wrapper does not take: q, k, v (B, H, L, dh)
    of one dtype (fp32 or bf16), contiguous; floating gates (B, H, L) and
    state C0 (B, H, dh, dh), n0 (B, H, dh), m0 (B, H); all on one device.
    ``kernel``: also what only the CUDA kernels need (dh a multiple of 8 up
    to ``KERNEL_MAX_DH``, L <= ``KERNEL_MAX_L``, q, k, v and C0 on a
    16-byte boundary).  Written to cost little host time on arguments it
    takes: every launch runs it."""
    dt = q.dtype
    if dt not in DTYPES or k.dtype != dt or v.dtype != dt \
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous()):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.dtype not in DTYPES:
                raise TypeError(f"mlstm_chunk: {name} must be one of "
                                f"{DTYPES}, got {t.dtype}")
            if t.dtype != dt:
                raise TypeError(f"mlstm_chunk: {name} is {t.dtype}, q is "
                                f"{dt}; all three must share a dtype")
            if not t.is_contiguous():
                raise ValueError(f"mlstm_chunk: {name} must be contiguous")
    named = (("q", q), ("k", k), ("v", v), ("i_pre", i_pre),
             ("f_pre", f_pre), ("C0", C0), ("n0", n0), ("m0", m0))
    for name, t in named[3:]:
        if not t.is_floating_point():
            raise TypeError(f"mlstm_chunk: {name} must be floating, got "
                            f"{t.dtype}")
    dev = q.device
    for name, t in named[1:]:
        if t.device != dev:
            raise ValueError(f"mlstm_chunk: {name} is on {t.device}, q is "
                             f"on {dev}")
    shape = q.shape
    ok = len(shape) == 4 and min(shape) >= 1
    if ok:
        B, H, L, dh = shape
        ok = (k.shape == shape and v.shape == shape
              and i_pre.shape == f_pre.shape == (B, H, L)
              and C0.shape == (B, H, dh, dh) and n0.shape == (B, H, dh)
              and m0.shape == (B, H))
    if not ok:
        raise ValueError(
            "mlstm_chunk: want q, k, v (B, H, L, dh), i_pre and f_pre "
            "(B, H, L), C0 (B, H, dh, dh), n0 (B, H, dh), m0 (B, H); got "
            + ", ".join(f"{name} {tuple(t.shape)}" for name, t in named))
    if kernel:
        if dh % 8 or dh > KERNEL_MAX_DH or L > KERNEL_MAX_L:
            raise ValueError(f"mlstm_chunk: the kernel takes dh a multiple "
                             f"of 8 up to {KERNEL_MAX_DH} and L <= "
                             f"{KERNEL_MAX_L}; got dh {dh}, L {L}")
        if (q.data_ptr() | k.data_ptr() | v.data_ptr() | C0.data_ptr()) % 16:
            raise ValueError("mlstm_chunk: q, k, v and C0 must start on a "
                             "16-byte boundary")


def mlstm_chunk(q, k, v, i_pre, f_pre, C0, n0, m0):
    """One chunk of the stabilised mLSTM for every (batch, head).

    q, k, v: (B, H, L, dh), float32 or bfloat16; i_pre, f_pre: (B, H, L);
    C0: (B, H, dh, dh); n0: (B, H, dh); m0: (B, H) (-1e30 for a fresh
    state); all on one device.  Returns ``(h, C1, n1, m1)``: h (B, H, L,
    dh) in q's dtype, the state at the chunk's end in fp32."""
    dev = q.device
    check(q, k, v, i_pre, f_pre, C0, n0, m0, kernel=dev.type == "cuda")
    i_pre, f_pre, C0, n0, m0 = [
        t if t.dtype is torch.float32 and t.is_contiguous()
        else t.float().contiguous() for t in (i_pre, f_pre, C0, n0, m0)]
    if dev.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, C0, n0, m0)
    if dev.type != "cuda":
        raise ValueError(f"mlstm_chunk: no kernel for device {dev}")
    lib, _ = load_library()
    p = plan(*q.shape)
    with build.on_device(dev):
        h = torch.empty_like(q)
        C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
        scratch = torch.empty(p.scratch_floats, dtype=torch.float32,
                              device=dev)
        rc = lib.mlstm_chunk_launch(pack(p, [
            t.data_ptr() for t in (q, k, v, i_pre, f_pre, C0, n0, m0, h, C1,
                                   n1, m1)], scratch.data_ptr(),
            q.dtype == torch.bfloat16), build.current_stream(dev))
    if rc != 0:
        raise RuntimeError("mlstm_chunk: kernel launch failed: "
                           f"{lib.mlstm_chunk_error_string(rc).decode()} "
                           f"(CUDA error {rc})")
    mlstm_chunk.launches += 1
    return h, C1, n1, m1


mlstm_chunk.launches = 0
