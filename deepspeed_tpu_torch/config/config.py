"""Training config (counterpart of ``deepspeed_tpu/config/config.py``).

Plain dataclasses (the JAX package's config is pydantic, which the card's
machine does not have) over the fields the single-card training step
reads: the batch triple with its ``"auto"`` sentinel, ``optimizer``,
``scheduler``, ``bf16`` / ``fp16``, ``gradient_clipping``,
``zero_optimization`` (stages 0-3, hpZ, qwZ, MiCS), ``mesh.data`` /
``mesh.zero``, ``remat``, ``data_types.grad_accum_dtype``, ``checkpoint``,
``resilience``, ``moe`` and ``seed``. Every other key the JAX
config accepts is taken at its JAX default and raises
``NotImplementedError`` when set to anything else, naming the ROADMAP.md
item that ports it; unknown keys raise ``ValueError``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Any, Optional, Union

import torch

from ..utils.roadmap import later

AUTO = "auto"


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value.lower() == AUTO


def _sci_int(value: Any) -> int:
    return int(float(value)) if isinstance(value, str) else int(value)


_FREE = {}   # a free-form dict default: any non-empty value counts as set

# section -> (the JAX defaults, the ROADMAP item that ports it)
_LATER_SECTIONS = {
    "monitor": (dict(enabled=False, tensorboard=_FREE, csv_monitor=_FREE,
                     wandb=_FREE, jsonl=_FREE, prometheus=_FREE,
                     request_log=_FREE), 7),
    "observability": (dict(hbm_watermark=True, trace_steps=None,
                           trace_dir="./xla_trace", spans=False,
                           spans_ring=4096, flight_dir=None,
                           flight_max_dumps=8, slo=_FREE, goodput=False,
                           telemetry=_FREE, commscope=_FREE), 7),
    "comms_logger": (dict(enabled=False, verbose=False, prof_all=True,
                          prof_ops=[]), 7),
    "flops_profiler": (dict(enabled=False, profile_step=1, detailed=True,
                            output_file=None), 8),
    "gradient_compression": (dict(enabled=False, type="int8", overlap=False,
                                  bucket_elems=0), 8),
    "data_efficiency": (dict(
        curriculum_learning=dict(
            enabled=False, min_difficulty=64, max_difficulty=1024,
            total_curriculum_step=10000, schedule_type="fixed_linear",
            difficulty_step=8, root_degree=2, difficulties=[], max_steps=[]),
        random_ltd=dict(enabled=False, start_tokens=128, total_steps=10000,
                        difficulty_step=64, seed=17)), 8),
    "compression": (dict(
        weight_quantization=dict(
            enabled=False, bits=8, group_size=0, symmetric=True,
            schedule_offset=0, start_bits=None, quantize_period=100,
            eigenvalue=False, eigenvalue_threshold=0.5),
        sparse_pruning=dict(enabled=False, density=0.5, schedule_offset=0),
        row_pruning=dict(enabled=False, density=0.5, schedule_offset=0),
        head_pruning=dict(enabled=False, density=0.5, schedule_offset=0)),
        8),
    "lora": (dict(enabled=False, rank=8, alpha=16.0), 8),
    "elasticity": (dict(enabled=False, max_train_batch_size=2048,
                        micro_batch_sizes=[2, 4, 8], min_devices=1,
                        max_devices=1024, prefer_larger_batch=True,
                        ignore_non_elastic_batch_info=False, version=0.1), 8),
    "progressive_layer_drop": (dict(enabled=False, theta=0.5, gamma=0.001),
                               8),
}
# top-level scalar keys: (JAX default, item)
_LATER_KEYS = {"wall_clock_breakdown": (False, 7),
               "sparse_gradients": (False, (6, "b"))}
# zero_optimization keys not ported: (JAX default, item). The int8
# gradient path of zero_quantized_gradients is comm/compressed.py.
_ZERO_LATER = {
    "offload_optimizer": (dict(device="none", nvme_path=None, buffer_count=4,
                               pin_memory=True, pipeline_read=True,
                               pipeline_write=True), (6, "b")),
    "offload_param": (dict(device="none", nvme_path=None, buffer_count=4,
                           pin_memory=True, pipeline_read=True,
                           pipeline_write=True), (6, "b")),
    "zero_quantized_gradients": (False, 8),
}
# the training engine's mesh axes above 1 -> the ROADMAP item that ports
# them (``model`` and ``expert`` train: item 4)
_MESH_LATER = {"pipe": 8, "seq": 8}
REMAT_POLICY_NAMES = ("none", "full", "dots_saveable", "save_nothing",
                      "save_names", "save_names_mlp", "offload_dots")


def _check_later(where: str, given: Any, default: Any, item: int) -> None:
    """Raise unless ``given`` equals the JAX default (recursively for
    sections); unknown keys of a section raise ``ValueError``."""
    if default is _FREE:
        if given:
            raise NotImplementedError(f"config {where} is not ported yet: "
                                      f"{later(item)}")
        return
    if isinstance(default, dict):
        if not isinstance(given, dict):
            raise ValueError(f"config {where} must be a dict")
        unknown = set(given) - set(default)
        if unknown:
            raise ValueError(f"unknown config keys in {where}: "
                             f"{sorted(unknown)}")
        for k, v in given.items():
            _check_later(f"{where}.{k}", v, default[k], item)
        return
    if given != default:
        raise NotImplementedError(f"config {where}={given!r} is not ported "
                                  f"yet: {later(item)}")


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BF16Config:
    enabled: bool = True


@dataclasses.dataclass
class FP16Config:
    """fp16 with a dynamic loss scale (``loss_scale`` 0) or a static one."""
    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class RematConfig:
    enabled: bool = False
    policy: str = "dots_saveable"
    offload: bool = False

    def __post_init__(self):
        if self.policy not in REMAT_POLICY_NAMES:
            raise ValueError(f"unknown remat policy {self.policy!r}; one of "
                             f"{REMAT_POLICY_NAMES}")
        if self.offload:
            raise NotImplementedError(f"config remat.offload is not ported "
                                      f"yet: {later(6, 'b')}")

    @property
    def resolved(self) -> Optional[str]:
        """The policy name ``TransformerLM.apply`` takes, None when off."""
        return self.policy if self.enabled and self.policy != "none" \
            else None


def _one_of(where: str, value, allowed: tuple) -> None:
    if value not in allowed:
        raise ValueError(f"config {where} must be one of {allowed}, got "
                         f"{value!r}")


@dataclasses.dataclass
class CheckpointConfig:
    """``save_checkpoint`` / ``load_checkpoint`` (JAX ``config.py:238``).

    ``async_save`` snapshots the state into pinned host buffers and writes
    on a thread; ``latest`` flips only once the write is durable
    (``wait_for_checkpoint``, the next save or load). ``verify``: the
    manifest level (``resilience/integrity.py``). ``keep_last``: prune to
    the newest K tags after each commit (0 keeps all). ``tag_validation``
    compares the tag's hash across ranks before a save or load (``warn`` /
    ``fail`` on every rank alike); ``load_universal`` has nothing to do
    (every tag is whole tensors, which any world size reads);
    ``use_node_local_storage`` is refused by the engine, as by JAX's."""
    use_node_local_storage: bool = False
    tag_validation: str = "warn"
    load_universal: bool = False
    async_save: bool = False
    verify: str = "size"
    keep_last: int = 0

    def __post_init__(self):
        _one_of("checkpoint.tag_validation", self.tag_validation,
                ("ignore", "warn", "fail"))
        _one_of("checkpoint.verify", self.verify, ("off", "size", "checksum"))
        if int(self.keep_last) < 0:
            raise ValueError(f"config checkpoint.keep_last must be >= 0, got "
                             f"{self.keep_last}")


@dataclasses.dataclass
class ResilienceConfig:
    """Crash safety and the runaway guard (JAX ``config.py:258``).

    ``resume: "auto"`` makes engine construction load the newest loadable
    checkpoint under ``resume_dir`` (verified-manifest fallback included);
    an empty or missing directory is a fresh run. ``max_consecutive_bad_
    steps`` halts with ``NonFiniteLossError`` after K consecutive bad
    optimizer steps (fp16 overflow skips, or a non-finite loss), evaluated
    at each ``steps_per_print`` boundary (0 = off)."""
    resume: str = "none"
    resume_dir: Optional[str] = None
    max_consecutive_bad_steps: int = 0

    def __post_init__(self):
        _one_of("resilience.resume", self.resume, ("none", "auto"))


@dataclasses.dataclass
class ZeroConfig:
    """``zero_optimization`` (JAX ``config.py:83``). ``overlap_comm`` and
    ``contiguous_gradients`` act only under gradient compression in JAX
    (ROADMAP item 8(3)), so they change nothing here;
    ``reduce_bucket_size`` sizes stage 2's flat reduce-scatter buffers (in
    elements). ``zero_hpz_partition_size`` (hpZ) and ``mics_shard_size``
    (MiCS) carve the mesh's ``zero`` sub-axis out of the data-parallel
    degree; ``zero_quantized_weights`` (qwZ) needs hpZ."""
    stage: int = 0
    param_persistence_threshold: int = 10_000
    reduce_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    contiguous_gradients: bool = True
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    mics_shard_size: int = 0

    def __post_init__(self):
        self.stage = int(self.stage)
        self.param_persistence_threshold = _sci_int(
            self.param_persistence_threshold)
        self.reduce_bucket_size = _sci_int(self.reduce_bucket_size)
        if not 0 <= self.stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.stage}")
        if self.reduce_bucket_size < 1:
            raise ValueError("zero_optimization.reduce_bucket_size must be "
                             f">= 1, got {self.reduce_bucket_size}")


@dataclasses.dataclass
class MoEConfig:
    """``moe`` (JAX ``config.py:446``): with ``enabled``, the engine sets
    the model's MoE knobs from these (``num_experts`` must be the model's
    own). Expert parallelism is ``mesh.expert`` (ROADMAP item 4)."""
    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_weight: float = 0.01


@dataclasses.dataclass
class MeshConfig:
    """``mesh`` (JAX ``config.py:116``): parallelism degrees; ``data=-1``
    takes the ranks the others leave. ``data`` is the whole data-parallel
    degree; hpZ / MiCS carve ``zero`` out of it."""
    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    zero: int = 1

    def __post_init__(self):
        for axis, item in _MESH_LATER.items():
            if int(getattr(self, axis)) != 1:
                raise NotImplementedError(
                    f"config mesh.{axis}={getattr(self, axis)} is not ported "
                    f"yet for training: {later(item)}")


_DATACLASSES = {"optimizer": OptimizerConfig, "bf16": BF16Config,
                "fp16": FP16Config, "remat": RematConfig,
                "checkpoint": CheckpointConfig,
                "resilience": ResilienceConfig, "mesh": MeshConfig,
                "zero_optimization": ZeroConfig, "moe": MoEConfig}


@dataclasses.dataclass
class Config:
    train_batch_size: Union[int, str] = AUTO
    train_micro_batch_size_per_gpu: Union[int, str] = AUTO
    gradient_accumulation_steps: Union[int, str] = AUTO
    steps_per_print: int = 10
    seed: int = 42
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    zero_optimization: ZeroConfig = dataclasses.field(
        default_factory=ZeroConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    remat: RematConfig = dataclasses.field(default_factory=RematConfig)
    grad_accum_dtype: Optional[str] = None
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)

    @classmethod
    def from_any(cls, cfg: "Config | dict | str | Path | None") -> "Config":
        if cfg is None:
            return cls()
        if isinstance(cfg, Config):
            return cfg
        if isinstance(cfg, (str, Path)):
            with open(cfg) as f:
                cfg = json.load(f)
        flat = copy.deepcopy(dict(cfg))
        if "zero" in flat:                       # the JAX deprecated alias
            flat.setdefault("zero_optimization", flat.pop("zero"))
        for key, (default, item) in _LATER_SECTIONS.items():
            if key in flat:
                _check_later(key, flat.pop(key), default, item)
        for key, (default, item) in _LATER_KEYS.items():
            if key in flat:
                _check_later(key, flat.pop(key), default, item)
        kw = {}
        zero = dict(flat.pop("zero_optimization", None) or {})
        if "cpu_offload" in zero:
            zero.setdefault("offload_optimizer", zero.pop("cpu_offload"))
        for k in list(zero):
            if k in _ZERO_LATER:
                default, item = _ZERO_LATER[k]
                _check_later(f"zero_optimization.{k}", zero.pop(k), default,
                             item)
        flat["zero_optimization"] = zero
        flat["mesh"] = flat.pop("mesh", None) or {}
        dtypes = flat.pop("data_types", None) or {}
        if set(dtypes) - {"grad_accum_dtype"}:
            raise ValueError(f"unknown data_types keys: {sorted(dtypes)}")
        kw["grad_accum_dtype"] = dtypes.get("grad_accum_dtype")
        sched = flat.pop("scheduler", None)
        if sched is not None:
            kw["scheduler"] = SchedulerConfig(**sched)
        for key, klass in _DATACLASSES.items():
            if key in flat:
                section = flat.pop(key)
                if not isinstance(section, dict):
                    raise ValueError(f"config {key} must be a dict")
                unknown = set(section) - {f.name for f in
                                          dataclasses.fields(klass)}
                if unknown:
                    raise ValueError(f"unknown config keys in {key}: "
                                     f"{sorted(unknown)}")
                kw[key] = klass(**section)
        known = {f.name for f in dataclasses.fields(cls)} - {
            "grad_accum_dtype"}
        unknown = set(flat) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        out = cls(**flat, **kw)
        if out.prescale_gradients:
            raise ValueError(
                "prescale_gradients has no effect: the gradient reduction "
                "order has no pre-allreduce division point, and fp16 "
                "overflow is handled by dynamic loss scaling — remove the "
                "flag")
        if out.grad_accum_dtype not in (None, "fp32", "float32", "bf16",
                                        "bfloat16", "fp16", "float16"):
            raise ValueError(f"unknown grad_accum_dtype "
                             f"{out.grad_accum_dtype!r}")
        zc, m = out.zero_optimization, out.mesh
        sub = {"zero_hpz_partition_size": int(zc.zero_hpz_partition_size) > 1,
               "mics_shard_size": int(zc.mics_shard_size or 0) > 0,
               "zero_quantized_weights": bool(zc.zero_quantized_weights),
               "mesh.zero": int(m.zero or 1) != 1}
        on = [k for k, v in sub.items() if v]
        if on and (int(m.model) != 1 or int(m.expert) != 1):
            raise NotImplementedError(
                f"{', '.join(on)} under mesh.model={m.model} / mesh.expert="
                f"{m.expert} (hpZ / MiCS / qwZ composed with tensor or "
                f"expert parallelism) is not ported yet: {later(4)}")
        return out

    def to_dict(self) -> dict:
        """The config in the JAX config dict's shape (what ``meta.json``
        records); ``Config.from_any`` reads it back to an equal config."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name != "grad_accum_dtype"}
        out = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
               for k, v in out.items()}
        out["data_types"] = {"grad_accum_dtype": self.grad_accum_dtype}
        return copy.deepcopy(out)

    def resolve_batch_sizes(self, dp_world_size: int) -> "Config":
        """Solve the train / micro / GAS triple (``config.py:516``)."""
        tb = None if is_auto(self.train_batch_size) \
            else int(self.train_batch_size)
        mb = (None if is_auto(self.train_micro_batch_size_per_gpu)
              else int(self.train_micro_batch_size_per_gpu))
        gas = (None if is_auto(self.gradient_accumulation_steps)
               else int(self.gradient_accumulation_steps))
        if tb is not None and mb is not None and gas is None:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro_batch*dp "
                    f"({mb}*{dp_world_size})")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None and mb is None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by gas*dp "
                    f"({gas}*{dp_world_size})")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = tb or mb * gas * dp_world_size
        elif tb is not None:
            gas = 1
            if tb % dp_world_size != 0:
                raise ValueError(f"train_batch_size {tb} not divisible by "
                                 f"dp_world_size {dp_world_size}")
            mb = tb // dp_world_size
        else:
            mb, gas, tb = 1, 1, dp_world_size
        if tb != mb * gas * dp_world_size:
            raise ValueError(
                f"inconsistent batch config: train_batch_size={tb} != "
                f"micro({mb}) * gas({gas}) * dp({dp_world_size})")
        return dataclasses.replace(self, train_batch_size=tb,
                                   train_micro_batch_size_per_gpu=mb,
                                   gradient_accumulation_steps=gas)

    @property
    def zero_stage(self) -> int:
        return self.zero_optimization.stage

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    @property
    def accum_dtype(self) -> torch.dtype:
        name = self.grad_accum_dtype or "float32"
        return {"fp32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "fp16": torch.float16, "float16": torch.float16}[name]
