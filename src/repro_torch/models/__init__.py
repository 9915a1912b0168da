from repro_torch.models.exits import (exit_rows, exit_stats_fused,
                                      exit_stats_unfused)
from repro_torch.models.model import (FEATURE_DIM, init_params,
                                      params_device, stage_forward,
                                      stage_layouts, stage_trunk,
                                      synchronize)

__all__ = ["FEATURE_DIM", "exit_rows", "exit_stats_fused",
           "exit_stats_unfused", "init_params", "params_device",
           "stage_forward", "stage_layouts", "stage_trunk", "synchronize"]
