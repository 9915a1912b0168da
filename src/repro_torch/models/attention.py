"""GQA attention over a full sequence (``repro.models.attention``).

Only the route the anytime classifier takes is ported: the unchunked dense
attention (``attend_dense``) with an fp32 softmax, in plain torch ops.  The
JAX trunk leaves this to XLA rather than to a Pallas kernel, so plain ops
keep the two packages comparable.  Sliding-window blocks, query chunking
beyond ``q_chunk``, qk-norm, MLA and decode steps raise
``NotImplementedError`` (ROADMAP Queue A items 8 and 12).
"""
from __future__ import annotations

from typing import Optional

import torch

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
    return {
        "ln": torch.zeros(d, dtype=dt, device=device),
        "wq": dense_init(generator, (d, H * hd), dt, device),
        "wk": dense_init(generator, (d, KV * hd), dt, device),
        "wv": dense_init(generator, (d, KV * hd), dt, device),
        "wo": dense_init(generator, (H * hd, d), dt, device,
                         scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }


def _project_qkv(cfg, params, x, positions):
    B, S = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    q = (x @ params["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    pos = positions if positions.ndim == 2 else positions[None].expand(B, S)
    q = apply_rope(q.reshape(B, S, H, hd), pos, cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def apply_gqa_full(cfg, params, x, *, positions, local: bool = False,
                   q_chunk: int = 1024):
    """Attention block over the full sequence: pre-norm, GQA, residual."""
    B, S, _ = x.shape
    if local or S > q_chunk or cfg.qk_norm:
        raise NotImplementedError(
            "repro_torch attention ports only the unchunked dense route "
            "(no sliding window, no qk-norm, S <= q_chunk); "
            "see ROADMAP Queue A item 12")
    hd = cfg.resolved_head_dim
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, params, h, positions)
    kp = positions if positions.ndim == 1 else positions[0]
    out = attend_dense(q, k, v, causal=cfg.causal, q_pos=kp, k_pos=kp,
                       softmax_scale=hd ** -0.5)
    y = out.reshape(B, S, cfg.num_heads * hd) @ params["wo"]
    return x + y
