"""PyTorch and CUDA port of the RTDeepIoT serving system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module names and runs on an NVIDIA GPU (the card by default: pass
``device="cpu"`` to run on the CPU).  It imports torch and numpy only —
never jax, and nothing of ``repro``.  What is ported so far, and what is
still to come, is listed in ROADMAP.md.
"""
