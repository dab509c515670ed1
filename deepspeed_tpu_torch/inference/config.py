"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

The port carries the single-card generate() path, dense or with int8/int4
weight-only quantization (WOQ). The JAX config's other knobs are accepted
at their defaults, so a JAX config ports as it is, and raise
``NotImplementedError`` when set: each names the ROADMAP.md item (queue 1)
that will port it. Unknown keys raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16}

_PAR = "item 6 (tensor and expert parallelism)"
# key → (the JAX default, accepted as a no-op; the ROADMAP item that ports it)
_LATER = {
    "tensor_parallel": (1, _PAR), "expert_parallel": (1, _PAR),
    "tp_comm_quant": (0, _PAR),
    "observability": (False, "item 9 (observability)"),
    "trace_ring_size": (256, "item 9 (observability)"),
    "serving": (None, "item 1 (ServingEngine)"),
}


@dataclasses.dataclass
class InferenceConfig:
    dtype: str = "bfloat16"            # compute dtype for decode
    max_out_tokens: int = 256
    eos_token_id: Optional[int] = None
    seed: int = 0                      # the engine's persistent sampling stream
    # The CUDA decode-attention kernel (ops/decode_attention.py) for the
    # 1-token decode step. None = auto: on for a CUDA device, off on the CPU.
    flash_decode: Optional[bool] = None
    # Decode in host-checked chunks of this many steps; between chunks the
    # engine reads the (B,) done flags and stops once every row hit eos.
    # 0 keeps one uninterrupted decode loop with no host read-back.
    decode_chunk: int = 0
    # Weight-only quantization (inference/quantization.py): the engine
    # stores the matmul weights as int8 or row-pair-packed int4 with fp32
    # scales over groups of quant_group_size rows, and decode reads them
    # quantized.
    quantize: bool = False
    quant_group_size: int = 128
    quant_bits: int = 8                # 8 or 4
    # WOQ only: the CUDA GEMMs of ops/woq_matmul.py for every quantized
    # projection and head of the decode step. None = auto: on for a CUDA
    # device, off on the CPU. False dequantizes each weight to the compute
    # dtype at its point of use instead (the JAX package's off-TPU path).
    woq_kernel: Optional[bool] = None
    # Obsolete JAX knob, accepted with a warning: decode always keeps the
    # weights quantized.
    dequant_per_step: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown inference dtype {self.dtype!r}; "
                             f"one of {sorted(_DTYPES)}")
        if self.decode_chunk < 0:
            raise ValueError(f"decode_chunk must be >= 0, got "
                             f"{self.decode_chunk}")
        if self.quant_bits not in (4, 8):
            raise ValueError(f"quant_bits must be 8 or 4, got "
                             f"{self.quant_bits}")
        if self.quant_group_size <= 0:
            raise ValueError(f"quant_group_size must be > 0, got "
                             f"{self.quant_group_size}")

    def flash_decode_resolved(self, device: torch.device) -> bool:
        if self.flash_decode is not None:
            return self.flash_decode
        return torch.device(device).type == "cuda"

    def woq_kernel_resolved(self, device: torch.device) -> bool:
        if self.woq_kernel is not None:
            return self.woq_kernel
        return torch.device(device).type == "cuda"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def from_any(cls, cfg: "InferenceConfig | dict | None") -> "InferenceConfig":
        if cfg is None:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        flat = dict(cfg)
        tp = flat.get("tensor_parallel")
        if isinstance(tp, dict):       # the reference's {"tp_size": N}
            flat["tensor_parallel"] = int(tp.get("tp_size", 1))
        moe = flat.pop("moe", None)
        if moe is not None:            # the reference's {"ep_size": N}
            if set(moe) - {"ep_size"}:
                raise ValueError(f"unknown moe config keys: "
                                 f"{sorted(set(moe) - {'ep_size'})}")
            flat.setdefault("expert_parallel", int(moe.get("ep_size", 1)))
        for key, (default, item) in _LATER.items():
            if key in flat and flat.pop(key) != default:
                raise NotImplementedError(
                    f"inference config {key!r} is not ported yet: "
                    f"ROADMAP.md queue 1, {item}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(flat) - known
        if unknown:
            raise ValueError(f"unknown inference config keys: {sorted(unknown)}")
        return cls(**flat)
