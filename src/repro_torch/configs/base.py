"""Model configuration system (a copy of ``repro.configs.base``).

Every architecture is a `ModelConfig` constructed in its own module under
`repro_torch.configs`, registered by id.  The port registers
``anytime-classifier`` and ``qwen3-4b`` so far.  `reduced()` derives the CPU-smoke variant
of the same family (>=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # layers whose index % moe_every == moe_offset are MoE layers
    moe_every: int = 1
    moe_offset: int = 0
    first_dense_layers: int = 0  # deepseek: first k layers stay dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    source: str               # citation bracket from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads

    # --- block pattern -------------------------------------------------
    # one period of block kinds; tiled to cover num_layers (remainder kept
    # as an explicit tail).  kinds: "attn", "attn_local", "mamba", "mlstm",
    # "slstm".
    period: Sequence[str] = ("attn",)

    # --- attention ------------------------------------------------------
    attention: str = "gqa"                  # gqa | mla
    qk_norm: bool = False
    causal: bool = True                     # False: bidirectional (classifier)
    sliding_window: Optional[int] = None    # window for "attn_local" blocks
    rope_theta: float = 1e4
    mla: Optional[MLAConfig] = None

    # --- ffn --------------------------------------------------------------
    ffn_type: str = "swiglu"                # swiglu | relu2 | none
    moe: Optional[MoEConfig] = None

    # --- ssm / xlstm --------------------------------------------------------
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_d_conv: int = 4

    # --- anytime / imprecise-computation structure (the paper) -----------
    num_stages: int = 3
    mandatory_stages: int = 1
    # optional explicit stage ends (layer idx, exclusive); default: uniform
    stage_ends: Optional[tuple] = None

    # --- modality stubs ---------------------------------------------------
    modality: str = "text"                  # text | vision_stub | audio_stub
    num_codebooks: int = 1                  # musicgen: 4 EnCodec codebooks
    num_patches: int = 0                    # vlm: patch-embedding prefix len
    mtp: bool = False                       # deepseek multi-token prediction

    # --- numerics / misc ---------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                 # compute/param dtype for big runs

    # ----------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def layer_kinds(self) -> tuple:
        """Expand the period over num_layers."""
        p = tuple(self.period)
        reps = self.num_layers // len(p)
        tail = self.num_layers - reps * len(p)
        return p * reps + p[:tail]

    def is_moe_layer(self, idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if idx < m.first_dense_layers:
            return False
        return idx % m.moe_every == m.moe_offset

    def stage_boundaries(self) -> tuple:
        """Layer index (exclusive) ending each stage, rounded to period size."""
        if self.stage_ends is not None:
            return tuple(self.stage_ends)
        p = len(self.period)
        per = max(1, round(self.num_layers / self.num_stages / p)) * p
        bounds = []
        for s in range(1, self.num_stages):
            bounds.append(min(s * per, self.num_layers))
        bounds.append(self.num_layers)
        # dedupe while preserving order (tiny configs)
        out, seen = [], set()
        for b in bounds:
            if b not in seen and b > 0:
                out.append(b); seen.add(b)
        return tuple(out)

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family."""
        p = tuple(dict.fromkeys(self.period))  # one of each distinct kind
        n_layers = max(2, len(p)) * 2 if len(p) > 1 else 2
        d_model = min(self.d_model, 256)
        heads = 4
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else heads
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=256 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            period=p,
            moe=moe,
            mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                          qk_rope_head_dim=16, v_head_dim=32) if self.mla else None,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            num_stages=min(self.num_stages, 2) if n_layers < 3 else self.num_stages,
            dtype="float32",
        )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# Architectures the JAX package registers that the port has not taken up
# yet (ROADMAP Queue A item 12).
NOT_PORTED = (
    "mistral-large-123b",
    "deepseek-v3-671b",
    "nemotron-4-340b",
    "pixtral-12b",
    "xlstm-1.3b",
    "gemma3-4b",
    "musicgen-medium",
    "jamba-1.5-large-398b",
    "kimi-k2-1t-a32b",
)

_MODULES = {
    "anytime-classifier": "anytime_classifier",
    "qwen3-4b": "qwen3_4b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"architecture {name!r} is not ported to repro_torch yet "
                "(ROADMAP Queue A item 12)")
        mod = _MODULES.get(name)
        if mod is None:
            raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]
