"""The paper's own workload analog: a small anytime classifier.

The paper trains a 3-stage ResNet on CIFAR-10/ImageNet with an exit head per
stage.  Offline-container analog: a compact transformer classifier over
synthetic difficulty-varying feature sequences (repro_torch.training.data), with the
identical 3-stage + exit-head + confidence structure.  vocab_size = number of
classes; modality "features" feeds continuous feature vectors through a linear
embed.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="anytime-classifier",
    arch_type="dense",
    source="[paper:RTDeepIoT §III-A analog]",
    num_layers=6,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=10,           # classes
    period=("attn",),
    ffn_type="swiglu",
    modality="features",
    causal=False,           # bidirectional encoder for classification
    num_stages=3,
    mandatory_stages=1,
    # anytime stages of 1/2/3 layers: pointer-chase reach doubles per layer,
    # so stage depth maps to solvable chain length (the paper's "complex
    # images need more layers" premise, made structural)
    stage_ends=(1, 3, 6),
    dtype="float32",
))
