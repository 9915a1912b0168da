"""Stage-structured anytime model (``repro.models.model``): the classifier
path and the decode path.

The model is a stack of layers partitioned into ``cfg.num_stages`` stages —
the paper's schedulable unit — each ending in an exit head.  The JAX
package groups a stage's repeated layers into a scanned period stack
(leading period axis); eager PyTorch has nothing to gain from that, so here
each stage's params are a flat list of layers in order and the scan is a
Python loop.  ``repro_torch.interop`` unstacks the JAX params accordingly.

Weights keep the JAX layout ``(in, out)``, applied as ``x @ W``.

Ported so far: dense GQA (with or without qk-norm) + SwiGLU layers with
the ``features`` modality (the anytime classifier) or the ``text``
modality (qwen3-4b), over a full sequence (``stage_trunk`` /
``stage_forward``) or one decode step over a per-stage KV cache
(``stage_decode_step`` / ``decode_step``).  A stage's decode cache is a list
with one ``{"k", "v", "slot_pos"}`` dict per layer, k and v laid out
``(B, KV, S, dh)`` as the decode-attention kernel reads them.  Other block
kinds, modalities, MLA and MoE raise ``NotImplementedError`` (ROADMAP
Queue A item 12).
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
    if cfg.modality not in ("features", "text"):
        missing.append(f"modality {cfg.modality!r}")
    if cfg.attention != "gqa":
        missing.append("MLA attention")
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


def init_embed(cfg, generator, device):
    """``{"w_in": (FEATURE_DIM, d)}`` for features, ``{"tok": (V, d)}`` for
    text."""
    dt = param_dtype(cfg)
    if cfg.modality == "features":
        return {"w_in": dense_init(generator, (FEATURE_DIM, cfg.d_model), dt,
                                   device, scale=0.1)}
    return {"tok": dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                              device)}


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random params from ``generator`` on ``device`` (the card by default).

    Returns ``{"embed": {"w_in"} or {"tok"}, "stages": [[layer, ...], ...],
    "exits": [{"ln"}, ...], "exit_shared": {"w_out"}}``."""
    check_ported(cfg)
    device = resolve_device(device)
    layouts = stage_layouts(cfg)
    return {
        "embed": init_embed(cfg, generator, device),
        "stages": [[init_layer(cfg, generator, device) for _ in lay.layers]
                   for lay in layouts],
        "exits": [exits.init_exit(cfg, generator, device) for _ in layouts],
        "exit_shared": exits.init_exit(cfg, generator, device, shared=True),
    }


def apply_embed(cfg, params, inputs):
    """Returns (h (B, S, d), positions (S,))."""
    if cfg.modality != "features":
        raise NotImplementedError(
            f"full-sequence (prefill) embedding of modality {cfg.modality!r} "
            "is not ported to repro_torch yet (ROADMAP Queue A item 12)")
    h = inputs["features"] @ params["w_in"]
    return h, torch.arange(h.shape[1], dtype=torch.int32, device=h.device)


def embed_one(cfg, params_embed, token):
    """Decode-time embedding of one token per row: token (B,) integer ids.
    Returns (B, d)."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"decoding modality {cfg.modality!r} is not ported to "
            "repro_torch yet (ROADMAP Queue A item 12)")
    return params_embed["tok"].index_select(0, token.reshape(-1))


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


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExitsOut:
    """Per-stage exit outputs of :func:`decode_step`."""
    logits: list               # per stage, (B, V)
    confidences: list          # per stage, (B,)


def _layer_cache_struct(cfg, batch, slots, dtype, device):
    """One attention layer's empty cache: k and v ``(B, KV, S, dh)`` zeros,
    ``slot_pos`` ``(B, S)`` all -1 (unwritten)."""
    shape = (batch, cfg.num_kv_heads, slots, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((batch, slots), -1, dtype=torch.int32,
                                   device=device)}


def init_decode_cache(cfg, batch, slots, dtype=None, device="cuda"):
    """Empty decode cache: per stage, one layer cache per layer (see
    :func:`_layer_cache_struct`), on ``device`` (the card by default).
    ``slots`` is the number of KV slots of every layer."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or param_dtype(cfg)
    return [[_layer_cache_struct(cfg, batch, slots, dtype, device)
             for _ in lay.layers] for lay in stage_layouts(cfg)]


def slice_decode_cache(st_cache, i: int, j: int = None):
    """Rows ``[i:j)`` of one stage's decode cache (default the single row
    i), as views.  A serving executor keeps per-request cache state this
    way while it batches co-runners: it slices rows out of a batched step
    and concatenates them back (:func:`concat_decode_caches`) for the next
    dispatch."""
    j = i + 1 if j is None else j
    return [{k: x[i:j] for k, x in layer.items()} for layer in st_cache]


def concat_decode_caches(st_caches):
    """Concatenate same-stage decode caches along the batch axis (the
    inverse of :func:`slice_decode_cache`).  All members must share one
    slot count (in serving terms, one length bucket).  The result is always
    a new tensor (``torch.cat`` copies, even of one member), so its owner
    may write into it in place."""
    return [{k: torch.cat([c[li][k] for c in st_caches], dim=0)
             for k in st_caches[0][li]}
            for li in range(len(st_caches[0]))]


def _stage_decode(cfg, stage_params, st_cache, h, cur_pos, *, decode_attn,
                  inplace):
    new_cache = []
    for p, c in zip(stage_params, st_cache):
        h, c_new = attention.apply_gqa_step(cfg, p["mixer"], h, cache=c,
                                            cur_pos=cur_pos,
                                            decode_attn=decode_attn,
                                            inplace=inplace)
        h = ffn.apply_ffn(cfg, p["ffn"], h)
        new_cache.append(c_new)
    return h, new_cache


def stage_decode_step(cfg, params, stage_idx: int, st_cache, h, cur_pos, *,
                      decode_attn: str = "kernel", inplace: bool = False):
    """ONE stage of a decode step over its per-stage cache: the decode-mode
    dispatch unit (the serving executor keeps per-request caches on the
    device and batches co-runners at the same stage through this).

    Stage 0 takes the raw token(s) (and embeds them); later stages take the
    hidden state (B, d).  ``st_cache`` is ``init_decode_cache(...)
    [stage_idx]``; ``cur_pos`` (B,) int32 holds each row's own position.
    ``decode_attn`` ("kernel" or "plain") and ``inplace`` are those of
    :func:`repro_torch.models.attention.apply_gqa_step`: the cache is
    written in place only when the caller owns it.  Returns
    ``(h, new_st_cache)``."""
    if stage_idx == 0:
        h = embed_one(cfg, params["embed"], h)
    return _stage_decode(cfg, params["stages"][stage_idx], st_cache, h,
                         cur_pos, decode_attn=decode_attn, inplace=inplace)


def decode_step(cfg, params, cache, token, cur_pos, *, upto_stage=None,
                conf_temperature: float = 1.0):
    """One decode step through (up to) ``upto_stage`` stages.

    token: (B,) integer ids; cur_pos: (B,) int32 positions.  Attention goes
    through the decode-attention kernel's wrapper, whose per-row mask keeps
    rows at different positions exact.  The caller's cache is not written:
    stages past ``upto_stage`` keep it, the others get fresh copies.
    Returns ``(ExitsOut with each stage's (B, V) logits and confidence,
    new_cache)``."""
    layouts = stage_layouts(cfg)
    n_stages = len(layouts) if upto_stage is None else upto_stage
    h = embed_one(cfg, params["embed"], token)
    logits_list, conf_list = [], []
    new_cache = list(cache)
    for s in range(n_stages):
        h, new_cache[s] = _stage_decode(cfg, params["stages"][s], cache[s],
                                        h, cur_pos, decode_attn="kernel",
                                        inplace=False)
        lg = exits.apply_exit(
            cfg, {**params["exits"][s], **params["exit_shared"]},
            h[:, None])[:, 0]
        logits_list.append(lg)
        conf_list.append(exits.confidence_from_logits(lg, conf_temperature))
    return ExitsOut(logits_list, conf_list), new_cache
