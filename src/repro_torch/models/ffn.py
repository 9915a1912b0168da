"""Dense SwiGLU FFN sublayer (``repro.models.ffn``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, param_dtype, rms_norm


def init_ffn(cfg, generator, device):
    dt = param_dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    down_scale = 0.02 / max(1, cfg.num_layers) ** 0.5
    return {"ln": torch.zeros(d, dtype=dt, device=device),
            "w_up": dense_init(generator, (d, f), dt, device),
            "w_down": dense_init(generator, (f, d), dt, device,
                                 scale=down_scale),
            "w_gate": dense_init(generator, (d, f), dt, device)}


def ffn_core(cfg, params, h):
    """The SwiGLU projection stack without norm/residual."""
    if cfg.ffn_type != "swiglu":
        raise NotImplementedError(
            f"ffn_type {cfg.ffn_type!r} is not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")
    a = F.silu(h @ params["w_gate"]) * (h @ params["w_up"])
    return a @ params["w_down"]


def apply_ffn(cfg, params, x):
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    return x + ffn_core(cfg, params, h)
