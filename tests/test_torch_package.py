"""deepspeed_tpu_torch as a package: what it imports, where it runs, how
its kernels build, what its config refuses."""

import ast
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.models import tiny_test
from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.platform.device import resolve_device

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
    assert len(PORT_FILES) > 10
    bad = {}
    for path in PORT_FILES:
        hits = {m for m in imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu")}
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
    assert builder.sources() == ["decode_attention"]


def test_inference_config_ports_and_refuses():
    cfg = InferenceConfig.from_any({"dtype": "bf16", "max_out_tokens": 9,
                                    "quantize": False, "tensor_parallel": 1})
    assert cfg.compute_dtype == torch.bfloat16 and cfg.max_out_tokens == 9
    assert cfg.flash_decode_resolved(torch.device("cuda"))
    assert not cfg.flash_decode_resolved(torch.device("cpu"))
    assert not InferenceConfig(flash_decode=False).flash_decode_resolved("cuda")
    for key, value, item in (("quantize", True, "WOQ"),
                             ("tensor_parallel", 2, "tensor"),
                             ("tensor_parallel", {"tp_size": 2}, "tensor"),
                             ("moe", {"ep_size": 2}, "expert"),
                             ("tp_comm_quant", 8, "tensor"),
                             ("observability", True, "observability"),
                             ("serving", {"slots": 4}, "ServingEngine")):
        with pytest.raises(NotImplementedError, match=item):
            InferenceConfig.from_any({key: value})
    with pytest.raises(ValueError, match="unknown inference config keys"):
        InferenceConfig.from_any({"flash_decoed": True})
    with pytest.raises(ValueError, match="decode_chunk"):
        InferenceConfig.from_any({"decode_chunk": -1})


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
            "models"} <= set(dt.__all__)
    for name in ("gpt2", "llama2", "opt", "bloom", "tiny_test",
                 "build_model", "params_from_jax", "TransformerLM"):
        assert hasattr(dt.models, name)
