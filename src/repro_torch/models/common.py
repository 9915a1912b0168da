"""Shared model utilities: RMSNorm, RoPE, seeded init (``repro.models.common``)."""
from __future__ import annotations

import torch


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, computed in fp32 and
    cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    The head dim is split into two halves (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: float = 0.02):
    """``scale * N(0, 1)`` drawn from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device), then moved to ``device``."""
    w = scale * torch.randn(shape, generator=generator, dtype=torch.float32)
    return w.to(device=device, dtype=dtype)


def param_dtype(cfg):
    return getattr(torch, cfg.dtype)
