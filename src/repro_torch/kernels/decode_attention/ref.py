"""Plain PyTorch version of the decode-attention kernel.

It computes what the Pallas kernel ``_decode_kernel``
(``repro.kernels.decode_attention.kernel``) computes, in fp32: per-row
slot validity (``slot_pos >= 0``, ``slot_pos <= cur_pos[b]`` and, with a
window, ``cur_pos[b] - slot_pos < window``), a softmax whose running max
starts at -1e30 and whose sum is clamped at 1e-30, so a row with no valid
slot gives zeros, as the Pallas kernel does (the JAX package's
``decode_attention_ref`` gives a uniform average there).  The wrapper in
``ops.py`` runs it for CPU tensors, the model's plain decode route runs it
on any device, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, slot_pos, cur_pos, *,
                         window=None, softmax_scale=None):
    """q: (B, H, dh); caches: (B, KV, S, dh); slot_pos: (B, S); cur_pos: (B,).

    Query head h reads KV head ``h // (H // KV)``.  Returns (B, H, dh) in
    q's dtype."""
    B, H, dh = q.shape
    KV = k_cache.shape[1]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, KV, H // KV, dh).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    cur = cur_pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= cur)
    if window is not None:
        valid &= cur - slot_pos < window
    valid = valid[:, None, None, :]
    m = torch.where(valid, s, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float()) / l
    return o.reshape(B, H, dh).to(q.dtype)
