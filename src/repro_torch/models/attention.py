"""GQA attention (``repro.models.attention``): full sequence and decode step.

Two routes are ported:

* the full sequence (:func:`apply_gqa_full`): the unchunked dense attention
  (``attend_dense``) with an fp32 softmax, in plain torch ops, as the
  anytime classifier's trunk takes it (the JAX trunk leaves this to XLA
  rather than to a Pallas kernel);
* one decode step (:func:`apply_gqa_step`): the new token against a KV
  cache, through the decode-attention kernel
  (``repro_torch.kernels.decode_attention``) or its plain version, with the
  kernel route's per-row ``slot_pos`` masking.

qk-norm (per-head RMSNorm of q and k) applies on both.  Sliding-window
blocks, query chunking beyond ``q_chunk`` and MLA raise
``NotImplementedError`` (ROADMAP Queue A item 12).

The decode cache stores k and v as ``(B, KV, S, dh)``, the layout the
kernel reads; the JAX package keeps ``(B, S, KV, dh)`` and transposes the
whole cache in every layer of every step.  ``repro_torch.interop``
converts between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.common import (apply_rope, dense_init, param_dtype,
                                       rms_norm)

NEG_INF = -1e30


def attend_dense(q, k, v, *, causal: bool, q_pos, k_pos,
                 window: Optional[int] = None, softmax_scale: float):
    """Unchunked reference attention with GQA grouping.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd); *_pos: integer positions.
    """
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * softmax_scale
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def init_gqa(cfg, generator, device):
    dt = param_dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    p = {
        "ln": torch.zeros(d, dtype=dt, device=device),
        "wq": dense_init(generator, (d, H * hd), dt, device),
        "wk": dense_init(generator, (d, KV * hd), dt, device),
        "wv": dense_init(generator, (d, KV * hd), dt, device),
        "wo": dense_init(generator, (H * hd, d), dt, device,
                         scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dt, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dt, device=device)
    return p


def _project_qkv(cfg, params, x, positions):
    B, S = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    q = (x @ params["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:        # per-head qk-norm over the trailing head dim
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    pos = positions if positions.ndim == 2 else positions[None].expand(B, S)
    q = apply_rope(q.reshape(B, S, H, hd), pos, cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def apply_gqa_full(cfg, params, x, *, positions, local: bool = False,
                   q_chunk: int = 1024):
    """Attention block over the full sequence: pre-norm, GQA, residual."""
    B, S, _ = x.shape
    if local or S > q_chunk:
        raise NotImplementedError(
            "repro_torch attention ports only the unchunked dense route "
            "(no sliding window, S <= q_chunk); "
            "see ROADMAP Queue A item 12")
    hd = cfg.resolved_head_dim
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, params, h, positions)
    kp = positions if positions.ndim == 1 else positions[0]
    out = attend_dense(q, k, v, causal=cfg.causal, q_pos=kp, k_pos=kp,
                       softmax_scale=hd ** -0.5)
    y = out.reshape(B, S, cfg.num_heads * hd) @ params["wo"]
    return x + y


#: decode attention routes: the kernel's wrapper (the CUDA kernel for CUDA
#: tensors, its plain version for CPU tensors) or the plain version anywhere
DECODE_ATTN = {"kernel": decode_attention, "plain": decode_attention_ref}


def apply_gqa_step(cfg, params, x, *, cache, cur_pos, decode_attn="kernel",
                   inplace: bool = False):
    """Decode one token.  x: (B, d); cur_pos: (B,) int32 positions; cache:
    ``{"k": (B, KV, S, dh), "v": (B, KV, S, dh), "slot_pos": (B, S) int32}``.

    The token's k and v go to slot ``cur_pos % S`` of each row (a ring when
    the positions outrun the slots) and ``slot_pos`` records the position,
    so the mask is exact per row either way.  ``decode_attn`` picks the
    route (:data:`DECODE_ATTN`).

    ``inplace=False`` (the default) copies the cache before writing, so the
    caller's cache is left as it was: the launcher's speculative deeper
    step runs from the same cache as the shallower one, and a depth that is
    not chosen must leave its stages' slots unwritten.  ``inplace=True``
    writes into the caller's tensors; only a caller that owns the cache may
    ask for it, as ``KernelDeviceExecutor``'s dispatch does with the fresh
    cache its batch concatenation makes.

    Returns ``(x + attention @ wo, new_cache)``."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, params, h[:, None], cur_pos[:, None])
    q = q[:, 0].reshape(B, H, hd)        # KV-major heads: h reads KV h // G
    k_cache, v_cache, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    if not inplace:
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        slot_pos = slot_pos.clone()
    write = (cur_pos % k_cache.shape[2]).long()
    rows = torch.arange(B, device=x.device)
    k_cache[rows, :, write] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, :, write] = v[:, 0].to(v_cache.dtype)
    slot_pos[rows, write] = cur_pos.to(slot_pos.dtype)
    out = DECODE_ATTN[decode_attn](q.contiguous(), k_cache, v_cache,
                                   slot_pos, cur_pos, softmax_scale=hd ** -0.5)
    y = out.reshape(B, H * hd) @ params["wo"]
    return x + y, {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}
