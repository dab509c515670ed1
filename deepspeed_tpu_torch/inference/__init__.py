from .config import InferenceConfig, ServingConfig
from .engine import InferenceEngine, init_inference

__all__ = ["InferenceConfig", "InferenceEngine", "ServingConfig",
           "init_inference"]
