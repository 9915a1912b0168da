from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

__all__ = ["mlstm_chunk", "mlstm_chunk_ref"]
