"""Plain PyTorch version of the mLSTM chunk kernel.

It computes the chunk formula of the Pallas kernel ``_mlstm_chunk_kernel``
(``repro.kernels.mlstm_chunk.kernel``) directly, in fp32 for fp32 and bf16
inputs (and in float64 for float64 inputs, a witness of fp32 rounding):
``lf = log σ(f)``, ``b = cumsum lf``, ``u = i − b``, ``g = max(m0, cummax
u)``, ``m = b + g``; scores ``q kᵀ`` weighted by ``exp(u_s − g_t)`` for
``s ≤ t``; ``h = (W v + exp(m0 − g)·q C0) / max(|rowsum W + exp(m0 −
g)·q n0|, exp(−m))``; and the state at the chunk's end.  The wrapper in
``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _scans(i_pre, f_pre, m0):
    """The gate scans: b = cumsum log σ(f), u = i − b, g = max(m0, cummax
    u), in m0's dtype."""
    b = torch.cumsum(F.logsigmoid(f_pre.to(m0.dtype)), -1)
    u = i_pre.to(m0.dtype) - b
    return b, u, torch.maximum(m0[..., None], torch.cummax(u, -1).values)


def _normaliser(q, k, n0, m0, u, g):
    """W (B, H, L, L), exp(m0 − g) (B, H, L) and the signed normaliser
    ``rowsum W + exp(m0 − g)·q n0`` (B, H, L)."""
    L = q.shape[2]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    w = torch.einsum("bhtd,bhsd->bhts", q, k) * torch.where(
        causal, torch.exp(u[..., None, :] - g[..., :, None]), 0.0)
    inter = torch.exp(m0[..., None] - g)
    return w, inter, w.sum(-1) + inter * torch.einsum("bhtd,bhd->bht", q, n0)


def mlstm_chunk_ref(q, k, v, i_pre, f_pre, C0, n0, m0):
    """q, k, v: (B, H, L, dh); i_pre, f_pre: (B, H, L); C0: (B, H, dh, dh);
    n0: (B, H, dh); m0: (B, H).  Returns (h (B, H, L, dh) in q's dtype, C1,
    n1, m1 in fp32, or float64 for float64 q)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(dt), k.to(dt), v.to(dt)
    C0, n0, m0 = C0.to(dt), n0.to(dt), m0.to(dt)
    b, u, g = _scans(i_pre, f_pre, m0)
    m = b + g
    w, inter, nq = _normaliser(qf, kf, n0, m0, u, g)
    h_num = torch.einsum("bhts,bhsd->bhtd", w, vf) \
        + inter[..., None] * torch.einsum("bhtd,bhde->bhte", qf, C0)
    h = h_num / torch.maximum(nq.abs(), torch.exp(-m))[..., None]
    gL, bL = g[..., -1], b[..., -1]
    kw = kf * torch.exp(u - gL[..., None])[..., None]
    decay = torch.exp(m0 - gL)
    C1 = decay[..., None, None] * C0 + torch.einsum("bhsd,bhse->bhde", kw, vf)
    n1 = decay[..., None] * n0 + kw.sum(-2)
    return h.to(q.dtype), C1, n1, bL + gL


def mlstm_chunk_condition(q, k, i_pre, f_pre, n0, m0):
    """Condition number of each row's normaliser, (B, H, L) float64, at
    least 1: the normaliser of the same chunk on |q|, |k|, |n0| (the sum of
    its summands' sizes) over ``max(|normaliser|, exp(−m))``, the
    denominator of h.  Where the signed normaliser cancels, rounding its
    summands in fp32, in any order, moves h by this factor more than in a
    row without cancellation."""
    q, k, i_pre, f_pre, n0, m0 = (t.double() for t in
                                  (q, k, i_pre, f_pre, n0, m0))
    b, u, g = _scans(i_pre, f_pre, m0)
    nq = _normaliser(q, k, n0, m0, u, g)[2]
    mass = _normaliser(q.abs(), k.abs(), n0.abs(), m0, u, g)[2]
    return (mass / torch.maximum(nq.abs(), torch.exp(-(b + g)))).clamp_min(1.0)
