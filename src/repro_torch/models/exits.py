"""Early-exit heads — the imprecise-computation interface (``repro.models.exits``).

Each stage ends in a thin classifier (paper Fig. 1): RMSNorm → linear to the
output classes → softmax.  Its (prediction, confidence) pair is what the
RTDeepIoT scheduler consumes; confidence is the (optionally
temperature-calibrated) max-softmax probability.

The fused version (one kernel: RMSNorm → matmul → online max, Σexp and
argmax, logits never written to device memory) is
``repro_torch.kernels.exit_confidence``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.kernels.exit_confidence.ref import \
    exit_confidence_ref as exit_stats_unfused
from repro_torch.models.common import dense_init, param_dtype, rms_norm

__all__ = ["init_exit", "apply_exit", "exit_rows", "exit_stats_unfused",
           "exit_stats_fused", "confidence_from_logits"]


def init_exit(cfg, generator, device, shared: bool = False):
    """Per-stage exit params: each stage owns its norm scale; the output
    projection ``w_out`` (d, V) is shared across stages (``shared=True``)."""
    dt = param_dtype(cfg)
    if shared:
        return {"w_out": dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dt, device)}
    return {"ln": torch.zeros(cfg.d_model, dtype=dt, device=device)}


def apply_exit(cfg, params, h):
    """h: (B, S, d) -> logits.

    features: (B, V) classification logits read at cell 0;
    text:     (B, S, V) next-token logits."""
    if cfg.modality not in ("features", "text"):
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")
    hn = rms_norm(h, params["ln"], cfg.norm_eps)
    if cfg.modality == "features":
        return hn[:, 0] @ params["w_out"]
    return hn @ params["w_out"]


def exit_rows(cfg, h):
    """The rows the exit head reads: (B, d).

    features: the anchor cell (position 0); text: the last position; 2-D
    input (a decode step's current-token rows) is taken as given.
    RMSNorm is per position, so norming the selected rows equals selecting
    from the normed tensor — which lets the fused kernel skip the rest of
    the sequence.  The result is a view; the kernel wants it contiguous."""
    if h.ndim == 2:
        return h
    return h[:, 0] if cfg.modality == "features" else h[:, -1]


def exit_stats_fused(h_rows, scale, w_out, *, eps: float = 1e-6,
                     temperature: float = 1.0):
    """Fused exit epilogue through the exit-confidence kernel's wrapper.
    Same signature and returns as :func:`exit_stats_unfused`:
    (conf (N,), pred (N,) int32, max_logit (N,), lse (N,))."""
    return exit_confidence(h_rows.contiguous(), scale, w_out, eps=eps,
                           temperature=temperature)


def confidence_from_logits(logits, temperature: float = 1.0):
    """Max-softmax confidence over the trailing class axis (fp32)."""
    lg = logits.float() / temperature
    return torch.exp(lg.max(-1).values - torch.logsumexp(lg, -1))
