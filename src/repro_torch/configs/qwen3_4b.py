"""Qwen3-4B (dense, GQA, qk-norm). [hf:Qwen/Qwen3-8B]

The decode path's model: 36 layers in 3 stages of 12, 32 query heads over
8 KV heads of 128, bf16.  ``reduced()`` gives the CPU-sized variant the
token-loop launcher serves."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    source="[hf:Qwen/Qwen3-8B]",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    period=("attn",),
    ffn_type="swiglu",
    qk_norm=True,            # per-head RMSNorm on q and k
    rope_theta=1e6,
))
