"""Plain PyTorch version of the decode-attention kernel.

It computes what the Pallas kernel ``_decode_kernel``
(``repro.kernels.decode_attention.kernel``) computes, in fp32: per-row
slot validity (``slot_pos >= 0``, ``slot_pos <= cur_pos[b]`` and, with a
window, ``cur_pos[b] - slot_pos < window``), a softmax whose running max
starts at -1e30 and whose sum is clamped at 1e-30, so a row with no valid
slot gives zeros, as the Pallas kernel does (the JAX package's
``decode_attention_ref`` gives a uniform average there).  The wrapper in
``ops.py`` runs it for CPU tensors, the model's plain decode route runs it
on any device, and ``chip_smoke.py`` holds the CUDA kernels against it on
the card.

``decode_attention_split_ref`` is a test-only model of the kernels'
split-and-combine: the same function computed per split of ``split``
consecutive slots (each split's max, sum and unnormalised output), then
the splits combined in index order.  The wrapper never calls it.
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


def decode_attention_split_ref(q, k_cache, v_cache, slot_pos, cur_pos, *,
                               split, window=None, softmax_scale=None):
    """``decode_attention_ref`` as the CUDA kernels compute it: per split of
    ``split`` slots the max m_i of the valid scores (-1e30 where none is
    valid), l_i = sum exp(s - m_i) and acc_i = sum exp(s - m_i) v; then m =
    max m_i and out = sum e^{m_i - m} acc_i / max(sum e^{m_i - m} l_i,
    1e-30), summed over i in index order.  Every reduction is within one row,
    so a row's result does not depend on the others in its batch."""
    B, H, dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, KV, H // KV, 1, dh).float()
    cur = cur_pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= cur)
    if window is not None:
        valid &= cur - slot_pos < window
    parts = []
    for s0 in range(0, S, split):
        k = k_cache[:, :, s0:s0 + split].float()[:, :, None]
        v = v_cache[:, :, s0:s0 + split].float()[:, :, None]
        ok = valid[:, None, None, None, s0:s0 + split]
        s = (qg * k).sum(-1)[..., None, :] * scale     # (B, KV, G, 1, n)
        m = torch.where(ok, s, NEG_INF).amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), (p[..., None] * v[:, :, :, None])
                      .sum(-2)))
    m = torch.stack([mi for mi, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, acci in parts:
        w = torch.exp(mi - m)
        l = l + w * li
        acc = acc + w[..., None] * acci
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, dh).to(q.dtype)
