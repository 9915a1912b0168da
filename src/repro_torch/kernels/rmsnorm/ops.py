"""Wrapper of the RMSNorm CUDA kernel.

``rmsnorm(x, scale, eps=1e-6)`` dispatches on the tensors' device: CPU
tensors take the plain version (``ref.py``); CUDA tensors launch the kernel
(``rmsnorm.cu``, built at first use) or raise.  Nothing falls back from
one to the other.  ``rmsnorm.launches`` counts kernel launches
(plain-version calls do not count).

``plan(N, d, itemsize)`` chooses the kernel's path, the 16-byte chunks a
thread holds (K) and the blocks that give every row its team, from the
shape alone:

- ``"warp"``: one warp a row, 4 rows a block, K = ceil(d / vector / 32)
  chunks a lane, up to ``WARP_K_MAX`` (rows up to ``WARP_MAX_D``);
- ``"block"``: wider rows, one block of 256 threads a row, the least K of
  ``BLOCK_KS`` that holds the row (rows up to ``BLOCK_MAX_D``);
- ``"loop"``: widths that are not a multiple of the vector width (4 fp32,
  8 bf16 values: 16 bytes) and rows wider than the block path holds; the
  row is read twice.

The grid is at most the blocks that fit the card at once (``resident``:
the SM count times the library's occupancy calculator), each walking rows
with a stride.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = pathlib.Path(__file__).with_name("rmsnorm.cu")
DTYPES = (torch.float32, torch.bfloat16)
PATHS = ("warp", "block", "loop")
#: threads a block on each path
THREADS = {"warp": 128, "block": 256, "loop": 256}
#: the largest K of the warp path and the K the block path is built for,
#: by x's itemsize: what fits in registers without spills (x's chunks and
#: 1 + scale in fp32, 8 or 12 registers a chunk; ptxas spills bf16 K 12
#: on the warp path, where it keeps a thread under 168 registers)
WARP_K_MAX = {4: 16, 2: 11}
BLOCK_KS = {4: (4, 8, 16), 2: (2, 4, 8, 12)}


def vector(itemsize):
    """Values in a 16-byte chunk."""
    return 16 // itemsize


def warp_max_d(itemsize):
    """The widest row of the warp path."""
    return 32 * WARP_K_MAX[itemsize] * vector(itemsize)


def block_max_d(itemsize):
    """The widest row of the block path."""
    return THREADS["block"] * BLOCK_KS[itemsize][-1] * vector(itemsize)


class Plan(NamedTuple):
    path: str
    K: int          # 16-byte chunks a thread holds (0 on the loop path)
    threads: int
    blocks: int     # blocks that give every row its team (a warp a row on
                    # the warp and loop paths, a block on the block path):
                    # the most the grid takes


@functools.lru_cache(maxsize=4096)
def plan(N, d, itemsize):
    """The kernel's path, K and most blocks for x (N, d) of ``itemsize``
    bytes."""
    vec = vector(itemsize)
    chunks, ragged = divmod(d, vec)
    if not ragged and chunks <= 32 * WARP_K_MAX[itemsize]:
        return Plan("warp", -(-chunks // 32), THREADS["warp"],
                    -(-N // (THREADS["warp"] // 32)))
    if not ragged and d <= block_max_d(itemsize):
        K = next(k for k in BLOCK_KS[itemsize]
                 if k * THREADS["block"] >= chunks)
        return Plan("block", K, THREADS["block"], N)
    return Plan("loop", 0, THREADS["loop"], -(-N // (THREADS["loop"] // 32)))


@functools.lru_cache(maxsize=None)
def resident(index, x_bf16, scale_bf16, path, K, ragged):
    """Blocks of the kernel of (path, K) that card ``index`` holds at once:
    its SM count times the library's occupancy calculator (``ragged``: the
    loop path's scalar kernel).  One query a kernel, then cached."""
    lib, _ = load_library()
    with build.on_device(torch.device("cuda", index)):
        per_sm = lib.rmsnorm_blocks_per_sm(x_bf16, scale_bf16,
                                           PATHS.index(path), K,
                                           1 if ragged else 16)
    if per_sm < 1:
        raise RuntimeError(f"rmsnorm: no occupancy for the {path} path, K "
                           f"{K} (x bf16 {x_bf16}, scale bf16 {scale_bf16})")
    return build.sm_count(torch.device("cuda", index)) * per_sm


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rmsnorm_launch.argtypes = [vp] * 3 + [i, i, f] + [i] * 5 + [vp]
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_blocks_per_sm.argtypes = [i] * 5
    lib.rmsnorm_blocks_per_sm.restype = i
    lib.rmsnorm_error_string.argtypes = [i]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib, log


def check(x, scale, *, kernel=False):
    """Raise on anything the wrapper does not take: x (N, d) fp32 or bf16,
    scale (d,) fp32 or x's dtype, both contiguous on one device.
    ``kernel``: also what only the CUDA kernel needs (x and scale on a
    16-byte boundary)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x must be one of {DTYPES}, got {x.dtype}")
    if scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm: scale must be float32 or x's dtype "
                        f"{x.dtype}, got {scale.dtype}")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x is on "
                         f"{x.device}")
    if x.ndim != 2 or scale.ndim != 1 or scale.shape[0] != x.shape[1] \
            or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"rmsnorm: want x (N, d) and scale (d,) with N, d "
                         f">= 1; got {tuple(x.shape)}, {tuple(scale.shape)}")
    if kernel and (x.data_ptr() % 16 or scale.data_ptr() % 16):
        raise ValueError("rmsnorm: x and scale must start on a 16-byte "
                         "boundary")


def rmsnorm(x, scale, *, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` per row, in fp32.

    x: (N, d), float32 or bfloat16; scale: (d,), float32 or x's dtype; both
    contiguous on one device.  Returns (N, d) in x's dtype."""
    dev = x.device
    check(x, scale, kernel=dev.type == "cuda")
    if dev.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {dev}")
    lib, _ = load_library()
    N, d = x.shape
    bf16 = x.dtype == torch.bfloat16
    scale_bf16 = scale.dtype == torch.bfloat16
    p = plan(N, d, x.element_size())
    index = torch.cuda.current_device() if dev.index is None else dev.index
    grid = min(p.blocks, resident(index, bf16, scale_bf16, p.path, p.K,
                                  d % vector(x.element_size()) != 0))
    with build.on_device(dev):
        out = torch.empty_like(x)
        rc = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), N, d, float(eps),
            bf16, scale_bf16, PATHS.index(p.path), p.K, grid,
            build.current_stream(dev))
    if rc != 0:
        raise RuntimeError("rmsnorm: kernel launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()} "
                           f"(CUDA error {rc})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
