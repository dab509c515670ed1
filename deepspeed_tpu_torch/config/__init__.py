from .config import (AUTO, BF16Config, Config, FP16Config, OptimizerConfig,
                     RematConfig, SchedulerConfig, is_auto)

__all__ = ["AUTO", "BF16Config", "Config", "FP16Config", "OptimizerConfig",
           "RematConfig", "SchedulerConfig", "is_auto"]
