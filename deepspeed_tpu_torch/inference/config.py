"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

The port carries the generate() path, dense or with int8/int4
weight-only quantization (WOQ), and the continuous-batching
``ServingEngine`` over contiguous slots or the paged KV pool
(:class:`ServingConfig`), with self-speculative decoding
(``speculation``) and the paged pool's KV tiers (``host_pool_bytes``,
``nvme_pool_bytes``, ``demote_ahead_idle_s``), on one card or sharded over a ``torch.distributed``
world by ``tensor_parallel`` and ``expert_parallel``. The JAX
configs' other knobs are accepted at their defaults, so a JAX config ports
as it is, and raise ``NotImplementedError`` when set: each names the
ROADMAP.md item (queue 1) that will port it. Unknown keys raise
``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.roadmap import later
from .speculation import SpeculationConfig

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16}

# key → (the JAX default, accepted as a no-op; the ROADMAP item that ports it)
_LATER = {
    "observability": (False, 7), "trace_ring_size": (256, 7),
}

# ServingConfig keys of the JAX package not ported yet: (default, item)
_SERVING_LATER = {
    "autoscale": (None, (6, "c")),
    "spans": (False, 7), "spans_ring": (4096, 7), "flight_dir": (None, 7),
    "flight_max_dumps": (8, 7), "slo": (None, 7), "workload": (None, 7),
    "kvscope": (None, 7), "goodput": (False, 7), "capture": (False, 7),
    "capture_ring": (4096, 7), "loadscope": (None, 7),
    "tenantscope": (None, 7), "telemetry": (None, 7), "watchdog_s": (0.0, 7),
    "chaos": (None, 8),
}


def _refuse_later(section: str, flat: dict, table: dict) -> None:
    """Pop every key of ``table`` from ``flat``; raise naming its ROADMAP
    item when it is set to anything but the JAX default."""
    for key, (default, item) in table.items():
        if key in flat and flat.pop(key) != default:
            raise NotImplementedError(
                f"{section} config {key!r} is not ported yet: {later(item)}")


@dataclasses.dataclass
class ServingConfig:
    """Continuous-batching knobs of ``serving/engine.py`` (the JAX
    package's ``ServingConfig``)."""

    slots: int = 8                  # persistent KV slots (the decode batch)
    max_len: int = 256              # per-slot cache capacity; a request is
                                    # admitted only if P + max_new <= max_len
    prefill_chunk: int = 32         # prompts prefill in chunks of this many
                                    # tokens (or a power-of-two bucket
                                    # below), one chunk per iteration
    max_queue: int = 0              # submit() backpressure; 0 = unbounded
    # the engine-wide sampling policy; every request draws from its own
    # generator, seeded from its request seed
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    greedy: bool = False
    # default per-request deadlines in seconds on the serving clock (0 =
    # none; submit() takes per-request overrides): TTFT is submit -> first
    # token, total is submit -> retirement; expiry retires with TIMEOUT
    ttft_deadline_s: float = 0.0
    total_deadline_s: float = 0.0
    # paged KV cache (serving/pages.py): > 0 pools pages of this many
    # positions shared by every slot through per-slot page tables, with
    # radix-tree prefix sharing and copy-on-write; 0 keeps contiguous slots
    page_size: int = 0
    # pool pages, scratch page 0 included; 0 = 1 + slots * max_len /
    # page_size (every slot coverable with no sharing). Fewer overcommit:
    # admission defers on transient pressure and sheds a request that can
    # never fit with a typed PagePoolExhausted
    pool_pages: int = 0
    prefix_sharing: bool = True
    # 8 = int8 KV pool with per-token, per-head fp32 scales (paged only)
    kv_quant_bits: int = 0
    # the KV tiers (serving/hostkv.py, serving/tiering.py), paged only:
    # host_pool_bytes > 0 bounds a pinned host store that keeps the pages
    # eviction frees (full blocks, int8 scales included, keyed by their
    # token prefix) and restores a matched cold prefix into the prefill
    # cache instead of recomputing it; a lost, pruned or corrupt copy is
    # recomputed. 0 builds no tier
    host_pool_bytes: int = 0
    # nvme_pool_bytes > 0 (needs the host tier) adds a disk rung under it:
    # the host store's prune victims spill to one file per block through
    # ops/aio.py, and an admission reads them back through the same
    # restore. nvme_path: the directory (default $TMPDIR/dstpu_kv_nvme;
    # each engine takes a fresh subdirectory)
    nvme_pool_bytes: int = 0
    nvme_path: Optional[str] = None
    # demote_ahead_idle_s > 0 (needs the host tier): tree-held blocks idle
    # this many seconds are staged into the tier at the end of a step, so
    # a later eviction of them frees without a copy. 0 = off
    demote_ahead_idle_s: float = 0.0
    # self-speculative decoding (inference/speculation.py, a
    # SpeculationConfig or its dict): per-slot n-gram drafts verified by one
    # fixed-shape (max_draft + 1)-token forward a step; greedy only (the
    # engine enforces it). None keeps the plain one-token step
    speculation: Optional[SpeculationConfig] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"serving needs >= 1 slot, got {self.slots}")
        c = self.prefill_chunk
        if c < 8 or (c & (c - 1)) != 0:
            raise ValueError(
                f"prefill_chunk must be a power of two >= 8 (the chunk "
                f"bucket set), got {c}")
        if self.max_len < c:
            raise ValueError(f"max_len={self.max_len} < prefill_chunk={c}")
        if self.page_size:
            if self.page_size < 8 or self.max_len % self.page_size != 0:
                raise ValueError(
                    f"page_size must be >= 8 and divide max_len="
                    f"{self.max_len}, got {self.page_size}")
            if self.pool_pages == 0:
                self.pool_pages = 1 + self.slots * (self.max_len
                                                    // self.page_size)
            elif self.pool_pages < 2:
                raise ValueError(
                    f"pool_pages={self.pool_pages} < 2 (one usable page "
                    "+ the reserved scratch page)")
        if self.kv_quant_bits not in (0, 8):
            raise ValueError(f"kv_quant_bits must be 0 (off) or 8, "
                             f"got {self.kv_quant_bits}")
        if self.kv_quant_bits and not self.page_size:
            raise ValueError("kv_quant_bits requires the paged KV cache "
                             "(set serving.page_size)")
        if self.host_pool_bytes < 0:
            raise ValueError(f"host_pool_bytes must be >= 0, "
                             f"got {self.host_pool_bytes}")
        if self.host_pool_bytes and not self.page_size:
            raise ValueError("host_pool_bytes (the tiered host KV store) "
                             "requires the paged KV cache (set "
                             "serving.page_size)")
        if self.nvme_pool_bytes < 0:
            raise ValueError(f"nvme_pool_bytes must be >= 0, "
                             f"got {self.nvme_pool_bytes}")
        if self.nvme_pool_bytes and not self.host_pool_bytes:
            raise ValueError("nvme_pool_bytes (the NVMe KV rung) requires "
                             "the host tier above it (set "
                             "serving.host_pool_bytes)")
        if self.demote_ahead_idle_s < 0:
            raise ValueError(f"demote_ahead_idle_s must be >= 0, "
                             f"got {self.demote_ahead_idle_s}")
        if self.demote_ahead_idle_s and not self.host_pool_bytes:
            raise ValueError("demote_ahead_idle_s (background demotion) "
                             "requires the tiered host KV store (set "
                             "serving.host_pool_bytes)")
        for knob in ("ttft_deadline_s", "total_deadline_s"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0, "
                                 f"got {getattr(self, knob)}")
        if self.speculation is not None:
            self.speculation = SpeculationConfig.from_any(self.speculation)

    @classmethod
    def from_any(cls, cfg: "ServingConfig | dict | None") -> "ServingConfig":
        if cfg is None:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        flat = dict(cfg)
        _refuse_later("serving", flat, _SERVING_LATER)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(flat) - known
        if unknown:
            raise ValueError(f"unknown serving config keys: {sorted(unknown)}")
        return cls(**flat)


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
    # Continuous-batching knobs for serving.ServingEngine (ignored by
    # generate()); None = ServingConfig's defaults.
    serving: Optional[ServingConfig] = None
    # Ranks of the mesh's ``model`` axis (Megatron tensor parallelism: the
    # heads, the FFN width and the vocabulary split) and of its ``expert``
    # axis (an MoE model's experts split); their product is the world of
    # ``init_distributed``.
    tensor_parallel: int = 1
    expert_parallel: int = 1
    # 8: the decode step's row-split reductions (``wo``, the dense MLP's
    # ``w_out``) travel as two-sided int8 (``comm/compressed.py``); 0 off
    tp_comm_quant: int = 0

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
        for knob in ("tensor_parallel", "expert_parallel"):
            if int(getattr(self, knob)) < 1:
                raise ValueError(f"{knob} must be >= 1, got "
                                 f"{getattr(self, knob)}")
        if self.tp_comm_quant not in (0, 8):
            raise ValueError(f"tp_comm_quant must be 0 (off) or 8 (int8), "
                             f"got {self.tp_comm_quant}")

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
        _refuse_later("inference", flat, _LATER)
        if flat.get("serving") is not None:
            flat["serving"] = ServingConfig.from_any(flat["serving"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(flat) - known
        if unknown:
            raise ValueError(f"unknown inference config keys: {sorted(unknown)}")
        return cls(**flat)
