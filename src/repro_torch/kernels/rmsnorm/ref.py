"""Plain PyTorch version of the RMSNorm kernel.

It is the port's own ``repro_torch.models.common.rms_norm``, as the JAX
package's ``rmsnorm_ref`` is ``repro.models.common.rms_norm``: ``x *
rsqrt(mean(x²) + eps) * (1 + scale)`` in fp32, cast back to x's dtype.  The
wrapper in ``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""
from __future__ import annotations

from repro_torch.models.common import rms_norm


def rmsnorm_ref(x, scale, *, eps=1e-6):
    """x: (N, d); scale: (d,).  Returns (N, d) in x's dtype."""
    return rms_norm(x, scale, eps)
