from repro_torch.core.task import Task
from repro_torch.core.dp import DepthPlanner, brute_force_plan, task_options
from repro_torch.core.greedy import greedy_update
from repro_torch.core.utility import (ExpIncrease, LinIncrease, MaxIncrease,
                                      Oracle, make_predictor)
from repro_torch.core.schedulers import (EDF, LCF, RR, Policy, RTDeepIoT,
                                         WeightedRTDeepIoT)
from repro_torch.core.simulator import SimResult, Workload, simulate

__all__ = ["Task", "DepthPlanner", "brute_force_plan", "task_options",
           "greedy_update", "ExpIncrease", "LinIncrease", "MaxIncrease",
           "Oracle", "make_predictor", "EDF", "LCF", "RR", "Policy",
           "RTDeepIoT", "WeightedRTDeepIoT", "SimResult", "Workload",
           "simulate"]
