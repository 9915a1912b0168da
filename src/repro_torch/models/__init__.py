from repro_torch.models.exits import (exit_rows, exit_stats_fused,
                                      exit_stats_unfused)
from repro_torch.models.model import (FEATURE_DIM, ExitsOut,
                                      concat_decode_caches, decode_step,
                                      embed_one, init_decode_cache,
                                      init_params, params_device,
                                      slice_decode_cache, stage_decode_step,
                                      stage_forward, stage_layouts,
                                      stage_trunk, synchronize)

__all__ = ["FEATURE_DIM", "ExitsOut", "concat_decode_caches", "decode_step",
           "embed_one", "exit_rows", "exit_stats_fused",
           "exit_stats_unfused", "init_decode_cache", "init_params",
           "params_device", "slice_decode_cache", "stage_decode_step",
           "stage_forward", "stage_layouts", "stage_trunk", "synchronize"]
