from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref

__all__ = ["exit_confidence", "exit_confidence_ref"]
