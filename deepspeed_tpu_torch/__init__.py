"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference this package is held
against; this package imports neither it nor JAX. It carries the
single-card dense ``init_inference(...).generate(...)`` path; ROADMAP.md
lists what follows.
"""

from . import models
from .inference import InferenceConfig, InferenceEngine, init_inference

__all__ = ["InferenceConfig", "InferenceEngine", "init_inference", "models"]
