"""deepspeed_tpu_torch as a package: what it imports, where it runs, how
its kernels build, what its config refuses."""

import ast
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.models import tiny_test
from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.platform.device import resolve_device
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor the packages the card's machine lacks (the checkpoints write
    their own safetensors layout; orbax is the JAX package's store)."""
    assert len(PORT_FILES) > 10
    assert ROOT / "deepspeed_tpu_torch/runtime/checkpoint/engine.py" \
        in PORT_FILES
    bad = {}
    for path in PORT_FILES:
        hits = {m for m in imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu",
                                       "safetensors", "orbax")}
        if hits:
            bad[str(path.relative_to(ROOT))] = sorted(hits)
    assert bad == {}


def test_entry_points_default_to_cuda():
    """Without a card, init_inference with no device raises; with one, it
    lands on the card. ``device='cpu'`` always works."""
    model = dt.models.build_model(tiny_test(dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert dt.init_inference(model, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.init_inference(model, params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    assert dt.init_inference(model, params, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_builder_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(builder, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(builder, "_loaded", {})
    with pytest.raises(builder.KernelBuildError, match="nvcc not found"):
        builder.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        builder.load("decode_attention")


def test_builder_reports_compiler_output_on_failure(monkeypatch, tmp_path):
    """A failing nvcc surfaces its own output in the error."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler says no' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(builder.KernelBuildError, match="fake compiler says no"):
        builder.build_all()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_keys_on_the_source():
    path = builder.library_path("decode_attention")
    assert path.parent == builder.BUILD_DIR
    assert path.name.startswith("libdecode_attention-")
    assert builder.sources() == ["decode_attention", "flash_attention",
                                 "flash_attention_f32",
                                 "flash_bwd_dkv_f32_sm90",
                                 "flash_bwd_dkv_sm90",
                                 "flash_bwd_dq_f32_sm90",
                                 "flash_bwd_dq_sm90",
                                 "flash_fwd_f32_sm90", "flash_fwd_sm90",
                                 "sparse_attention", "sparse_bwd_dkv_sm90",
                                 "sparse_bwd_dq_sm90", "sparse_fwd_sm90",
                                 "woq_matmul", "xent", "xent_bwd_sm90"]


def test_inference_config_ports_and_refuses():
    cfg = InferenceConfig.from_any({"dtype": "bf16", "max_out_tokens": 9,
                                    "quantize": False, "tensor_parallel": 1})
    assert cfg.compute_dtype == torch.bfloat16 and cfg.max_out_tokens == 9
    assert cfg.flash_decode_resolved(torch.device("cuda"))
    assert not cfg.flash_decode_resolved(torch.device("cpu"))
    assert not InferenceConfig(flash_decode=False).flash_decode_resolved("cuda")
    woq = InferenceConfig.from_any({"quantize": True, "quant_bits": 4,
                                    "quant_group_size": 64})
    assert (woq.quantize, woq.quant_bits, woq.quant_group_size) == (True, 4, 64)
    assert woq.woq_kernel_resolved(torch.device("cuda"))
    assert not woq.woq_kernel_resolved(torch.device("cpu"))
    assert not InferenceConfig(woq_kernel=False).woq_kernel_resolved("cuda")
    with pytest.raises(ValueError, match="quant_bits"):
        InferenceConfig.from_any({"quantize": True, "quant_bits": 2})
    # tensor and expert parallelism serve (item 4's serving half): the
    # reference's spellings parse, the quantized collective is int8 only
    for key, value, field, want in (
            ("tensor_parallel", 2, "tensor_parallel", 2),
            ("tensor_parallel", {"tp_size": 4}, "tensor_parallel", 4),
            ("moe", {"ep_size": 2}, "expert_parallel", 2),
            ("expert_parallel", 4, "expert_parallel", 4),
            ("tp_comm_quant", 8, "tp_comm_quant", 8)):
        assert getattr(InferenceConfig.from_any({key: value}), field) == want
    for key, value in (("tp_comm_quant", 4), ("tensor_parallel", 0)):
        with pytest.raises(ValueError, match=key):
            InferenceConfig.from_any({key: value})
    for key, value, item in (("observability", True, "observability"),
                             ("serving", {"autoscale": {"enabled": True}},
                              r"part 6\(c\) \(the fleet\)")):
        with pytest.raises(NotImplementedError, match=item):
            InferenceConfig.from_any({key: value})
    # the KV tiers (item 6(a)) are ported: their serving keys parse
    tiers = InferenceConfig.from_any({"serving": {
        "page_size": 16, "max_len": 256, "host_pool_bytes": 1 << 20,
        "nvme_pool_bytes": 1 << 22, "demote_ahead_idle_s": 2.0}}).serving
    assert (tiers.host_pool_bytes, tiers.nvme_pool_bytes,
            tiers.demote_ahead_idle_s) == (1 << 20, 1 << 22, 2.0)
    assert InferenceConfig.from_any({"serving": {"slots": 4}}).serving.slots \
        == 4
    # speculation (item 5) is ported: its serving block parses
    spec = InferenceConfig.from_any(
        {"serving": {"speculation": {"ngram": 2, "max_draft": 3}}})
    assert (spec.serving.speculation.ngram,
            spec.serving.speculation.max_draft) == (2, 3)
    with pytest.raises(ValueError, match="unknown inference config keys"):
        InferenceConfig.from_any({"flash_decoed": True})
    with pytest.raises(ValueError, match="decode_chunk"):
        InferenceConfig.from_any({"decode_chunk": -1})


def test_training_entry_point_defaults_to_cuda():
    """Without a card, initialize with no device raises; device='cpu'
    builds the engine on the host."""
    model = dt.build_model(tiny_test(dtype=torch.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.initialize({"train_batch_size": 2}, model)
    eng = dt.initialize({"train_batch_size": 2}, model, device="cpu")
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in eng.master.values())


def test_training_config_ports_and_refuses():
    cfg = Config.from_any({"train_batch_size": 16,
                           "train_micro_batch_size_per_gpu": 4,
                           "zero_optimization": {"stage": 2},
                           "data_types": {"grad_accum_dtype": "bf16"},
                           "monitor": {"enabled": False},
                           "mesh": {"data": 1}}).resolve_batch_sizes(1)
    assert (cfg.gradient_accumulation_steps, cfg.zero_stage,
            cfg.accum_dtype, cfg.compute_dtype) == (4, 2, torch.bfloat16,
                                                    torch.bfloat16)
    assert Config.from_any({"fp16": {"enabled": True}}).compute_dtype \
        == torch.float16
    for conf, item in (
            ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
             "item 6"),
            ({"compression": {"sparse_pruning": {"enabled": True}}},
             "item 8"),
            ({"lora": {"enabled": True}}, "item 8"),
            ({"progressive_layer_drop": {"enabled": True}}, "item 8"),
            ({"data_efficiency": {"random_ltd": {"enabled": True}}},
             "item 8"),
            ({"data_efficiency": {"curriculum_learning": {"enabled": True}}},
             "item 8"),
            ({"gradient_compression": {"enabled": True}}, "item 8"),
            ({"zero_optimization": {"zero_quantized_gradients": True}},
             "item 8"),
            ({"monitor": {"enabled": True}}, "item 7"),
            ({"observability": {"spans": True}}, "item 7"),
            ({"elasticity": {"enabled": True}}, "item 8"),
            ({"mesh": {"expert": 2},
              "zero_optimization": {"mics_shard_size": 2}}, "item 4"),
            ({"mesh": {"model": 2},
              "zero_optimization": {"zero_hpz_partition_size": 2}},
             "item 4"),
            ({"remat": {"enabled": True, "offload": True}}, "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            Config.from_any(conf)
    # MoE (item 3) is ported: its section parses
    moe = Config.from_any({"moe": {"enabled": True, "num_experts": 8,
                                   "top_k": 1, "drop_tokens": False}}).moe
    assert (moe.enabled, moe.num_experts, moe.top_k, moe.drop_tokens,
            moe.capacity_factor) == (True, 8, 1, False, 1.25)
    # multi-rank ZeRO (item 1) is ported: its keys parse
    zero = Config.from_any({"zero_optimization": {
        "stage": 3, "zero_quantized_weights": True,
        "zero_hpz_partition_size": 2, "overlap_comm": False},
        "mesh": {"data": 2}})
    assert (zero.zero_stage, zero.mesh.data,
            zero.zero_optimization.zero_quantized_weights,
            zero.zero_optimization.overlap_comm) == (3, 2, True, False)
    ported = Config.from_any({"checkpoint": {"async_save": True,
                                             "verify": "checksum"},
                              "resilience": {"resume": "auto",
                                             "resume_dir": "ckpts"}})
    assert ported.checkpoint.async_save and ported.resilience.resume == "auto"
    model = dt.build_model(tiny_test(dtype=torch.float32))
    with pytest.raises(ValueError, match="use_node_local_storage"):
        dt.initialize({"checkpoint": {"use_node_local_storage": True}}, model,
                      device="cpu")
    for conf, item in (({"optimizer": {"type": "OneBitAdam"}}, "item 8"),
                       ({"remat": {"enabled": True,
                                   "policy": "offload_dots"}}, "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            dt.initialize(conf, model, device="cpu")
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_any({"gradient_clip": 1.0})
    with pytest.raises(ValueError, match="unknown config keys in lora"):
        Config.from_any({"lora": {"rnak": 4}})
    with pytest.raises(ValueError, match="inconsistent"):
        Config.from_any({"train_batch_size": 6,
                         "train_micro_batch_size_per_gpu": 4,
                         "gradient_accumulation_steps": 2}
                        ).resolve_batch_sizes(1)
    for policy in ("save_names", "save_names_mlp"):
        eng = dt.initialize({"remat": {"enabled": True, "policy": policy}},
                            model, device="cpu")
        assert eng.remat_policy == policy


def test_fused_xent_config_runs_on_the_cpu():
    """``fused_xent=True`` takes the fused head on any device (its plain
    version for CPU tensors) and agrees with the unfused head; the default
    takes it on the card only."""
    fused = dt.build_model(tiny_test(dtype=torch.float32, fused_xent=True))
    unfused = dt.build_model(tiny_test(dtype=torch.float32, fused_xent=False))
    auto = dt.build_model(tiny_test(dtype=torch.float32))
    assert fused._fused_xent_active(False) and auto._fused_xent_active(True)
    assert not auto._fused_xent_active(False)
    params = fused.init(torch.Generator().manual_seed(0))
    batch = {"input_ids": torch.arange(24).reshape(2, 12) % 7}
    with torch.no_grad():
        a, b = fused.loss(params, batch), unfused.loss(params, batch)
    assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_every_roadmap_item_the_port_names_exists():
    """Each "ROADMAP.md queue 1, item N (title)" the port can raise names
    queue 1's item N of ROADMAP.md, under that title."""
    import re

    from deepspeed_tpu_torch.utils import roadmap

    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. Modules to port"):
                 text.index("### 2. TPU kernels")]
    titles = {int(n): t.replace("`", "").lower() for n, t in
              re.findall(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M)}
    named = dict(roadmap.ITEMS)
    for path in PORT_FILES:
        for n, t in re.findall(r"queue 1, item (\d+) \(([^)]+)\)",
                               path.read_text()):
            named.setdefault(int(n), t)
            assert named[int(n)] == t, (path, n, t)
    assert len(named) >= 8
    for n, t in named.items():
        assert n in titles and titles[n].startswith(t.lower()), (n, t)
    assert roadmap.later(2) == "ROADMAP.md queue 1, item 2 (ServingEngine)"
    # MoE (item 3) and speculation (item 5) are ported: no literal call
    # raises them (expert parallelism, item 4, raises through the mesh and
    # inference tables), and no config table names item 5
    raising = {int(n) for path in PORT_FILES for n in re.findall(
        r"later\((\d+)[,)]", path.read_text())}
    assert not raising & {3, 5} and {6, 7, 8} <= raising
    # a split item's parts: each part the port names is a bold "N(p) title"
    # under its item, and part 6(a) (the KV tiers) raises nowhere
    parts = {(int(n), p): t.lower() for n, p, t in re.findall(
        r"\*\*(\d+)\(([a-z])\) ([^*]+)\*\*", queue)}
    named_parts = {(int(n), p) for path in PORT_FILES for n, p in re.findall(
        r"later\((\d+), ['\"]([a-z])['\"]\)", path.read_text())}
    assert named_parts and named_parts <= set(roadmap.PARTS)
    assert (6, "a") in parts and (6, "a") not in roadmap.PARTS
    for key, t in roadmap.PARTS.items():
        assert key in parts and parts[key].startswith(t.lower()), (key, t)
    assert roadmap.later(6, "c") == ("ROADMAP.md queue 1, item 6 (KV tiers, "
                                     "fleet and host native code), part "
                                     "6(c) (the fleet)")
    from deepspeed_tpu_torch.inference.config import _LATER, _SERVING_LATER
    assert 5 not in {item for _, item in (*_LATER.values(),
                                          *_SERVING_LATER.values())}
    assert roadmap.later(3) == "ROADMAP.md queue 1, item 3 (MoE)"
    assert roadmap.later(5) == "ROADMAP.md queue 1, item 5 (speculation)"


def test_engine_refuses_tf32_matmuls_on_the_card(monkeypatch):
    """The fp32 decode head needs full fp32 products on the card."""
    model = dt.models.build_model(tiny_test(dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="allow_tf32"):
            dt.init_inference(model, params, device="cuda")
    # the CPU has no TF32: the same engine builds there
    assert dt.init_inference(model, params, device="cpu").params


def test_public_surface():
    assert {"init_inference", "InferenceEngine", "InferenceConfig",
            "ServingEngine", "ServingConfig", "models", "initialize",
            "build_model", "make_flash_attention", "PreemptionGuard",
            "NonFiniteLossError"} <= set(dt.__all__)
    for name in ("gpt2", "llama2", "opt", "bloom", "bert", "mixtral",
                 "tiny_test", "build_model", "params_from_jax",
                 "params_to_numpy", "train_state_from_jax",
                 "read_fp32_safetensors", "TransformerLM",
                 "MoETransformerLM"):
        assert hasattr(dt.models, name)
