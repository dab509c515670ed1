"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference this package is held
against; this package imports neither it nor JAX. It carries the
single-card ``init_inference(...).generate(...)`` path (dense and
weight-only-quantized), the continuous-batching
``ServingEngine(init_inference(...), {...})`` over contiguous KV slots or
the paged KV pool with radix prefix sharing and int8 KV, and
the training step,
``initialize(config, build_model(cfg, attention_fn=make_flash_attention()))
.train_batch(batch)``, on one device or, after ``init_distributed()``, one
process per device under ZeRO stages 0-3 (hpZ, qwZ, MiCS), with crash-safe
checkpoints (``save_checkpoint`` / ``load_checkpoint``, async saves,
``resilience.resume: "auto"``, the ``PreemptionGuard``). Dense and
Mixture-of-Experts (``models.mixtral``) trunks take every one of these
paths; ROADMAP.md lists what follows.
"""

from . import models
from .inference import (InferenceConfig, InferenceEngine, ServingConfig,
                        init_inference)
from .models import build_model
from .ops.flash_attention import make_flash_attention
from .platform.distributed import init_distributed
from .resilience import NonFiniteLossError, PreemptionGuard
from .runtime import Engine, initialize
from .serving import ServingEngine

__all__ = ["Engine", "InferenceConfig", "InferenceEngine",
           "NonFiniteLossError", "PreemptionGuard", "ServingConfig",
           "ServingEngine", "build_model", "init_distributed",
           "init_inference", "initialize",
           "make_flash_attention", "models"]
