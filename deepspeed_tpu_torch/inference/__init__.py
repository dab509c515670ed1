from .config import InferenceConfig
from .engine import InferenceEngine, init_inference

__all__ = ["InferenceConfig", "InferenceEngine", "init_inference"]
