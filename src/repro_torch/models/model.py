"""Stage-structured anytime model (``repro.models.model``), classifier path.

The model is a stack of layers partitioned into ``cfg.num_stages`` stages —
the paper's schedulable unit — each ending in an exit head.  The JAX
package groups a stage's repeated layers into a scanned period stack
(leading period axis); eager PyTorch has nothing to gain from that, so here
each stage's params are a flat list of layers in order and the scan is a
Python loop.  ``repro_torch.interop`` unstacks the JAX params accordingly.

Weights keep the JAX layout ``(in, out)``, applied as ``x @ W``.

Ported so far: dense GQA + SwiGLU layers with the ``features`` modality —
the anytime classifier.  Other block kinds, modalities and the decode path
raise ``NotImplementedError`` (ROADMAP Queue A items 8 and 12).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention, exits, ffn
from repro_torch.models.common import dense_init, param_dtype

FEATURE_DIM = 32  # input feature width for the "features" modality


@dataclasses.dataclass(frozen=True)
class StageLayout:
    start: int
    end: int

    @property
    def layers(self) -> range:
        return range(self.start, self.end)


def stage_layouts(cfg):
    """One layout per stage: the absolute layer range ``[start, end)``."""
    out, start = [], 0
    for end in cfg.stage_boundaries():
        out.append(StageLayout(start, end))
        start = end
    return tuple(out)


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for any part of ``cfg`` the port lacks."""
    missing = []
    if cfg.modality != "features":
        missing.append(f"modality {cfg.modality!r}")
    if cfg.attention != "gqa" or cfg.qk_norm:
        missing.append("MLA / qk-norm attention")
    if cfg.moe is not None:
        missing.append("MoE layers")
    if cfg.ffn_type != "swiglu":
        missing.append(f"ffn_type {cfg.ffn_type!r}")
    kinds = set(cfg.layer_kinds())
    if kinds != {"attn"}:
        missing.append(f"block kinds {sorted(kinds - {'attn'})}")
    if cfg.mtp:
        missing.append("multi-token prediction")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")


def resolve_device(device) -> torch.device:
    """The explicit device a caller asked for; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device


def params_device(params) -> torch.device:
    """The device the parameters live on (where the model runs)."""
    return params["exit_shared"]["w_out"].device


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_layer(cfg, generator, device):
    return {"mixer": attention.init_gqa(cfg, generator, device),
            "ffn": ffn.init_ffn(cfg, generator, device)}


def apply_layer(cfg, params, h, positions):
    h = attention.apply_gqa_full(cfg, params["mixer"], h, positions=positions)
    return ffn.apply_ffn(cfg, params["ffn"], h)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random params from ``generator`` on ``device`` (the card by default).

    Returns ``{"embed": {"w_in"}, "stages": [[layer, ...], ...],
    "exits": [{"ln"}, ...], "exit_shared": {"w_out"}}``."""
    check_ported(cfg)
    device = resolve_device(device)
    dt = param_dtype(cfg)
    layouts = stage_layouts(cfg)
    return {
        "embed": {"w_in": dense_init(generator, (FEATURE_DIM, cfg.d_model),
                                     dt, device, scale=0.1)},
        "stages": [[init_layer(cfg, generator, device) for _ in lay.layers]
                   for lay in layouts],
        "exits": [exits.init_exit(cfg, generator, device) for _ in layouts],
        "exit_shared": exits.init_exit(cfg, generator, device, shared=True),
    }


def apply_embed(cfg, params, inputs):
    """Returns (h (B, S, d), positions (S,))."""
    if cfg.modality != "features":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")
    h = inputs["features"] @ params["w_in"]
    return h, torch.arange(h.shape[1], dtype=torch.int32, device=h.device)


def stage_trunk(cfg, params, stage_idx: int, h_or_inputs):
    """ONE stage's trunk (embed + blocks), without the exit head.

    Stage 0 takes raw inputs (``{"features": (B, S, FEATURE_DIM)}``) and
    embeds them; later stages take the hidden state (B, S, d).  Returns the
    stage-out hidden state (B, S, d)."""
    if stage_idx == 0:
        h, positions = apply_embed(cfg, params["embed"], h_or_inputs)
    else:
        h = h_or_inputs
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
    for layer in params["stages"][stage_idx]:
        h = apply_layer(cfg, layer, h, positions)
    return h


def stage_forward(cfg, params, stage_idx: int, h_or_inputs, *,
                  conf_temperature: float = 1.0):
    """Run ONE stage (the paper's non-preemptive unit) and its exit head.
    Returns (h, logits, confidence)."""
    h = stage_trunk(cfg, params, stage_idx, h_or_inputs)
    lg = exits.apply_exit(
        cfg, {**params["exits"][stage_idx], **params["exit_shared"]}, h)
    return h, lg, exits.confidence_from_logits(lg, conf_temperature)
