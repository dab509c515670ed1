"""Standalone checkpoint → fp32 converter (``dstpu_torch_to_fp32`` CLI;
counterpart of ``deepspeed_tpu/runtime/checkpoint/to_fp32.py``).

Reads only the fp32 master of a tag (``state/master.safetensors``; the
moments are master-sized, so reading them would triple the bytes) and
writes ``model_fp32.safetensors`` under the JAX package's keys (the tree
paths joined with ``/``: ``tok_embed``, ``layers/wq``), with
``native_config.json`` from ``meta.json``'s ``model_config``. No engine,
no model and no card are needed:

    dstpu_torch_to_fp32 /ckpts/run latest out/fp32

``--format hf`` (a Hugging Face checkpoint through the exporter) is not
ported yet; ``auto`` writes safetensors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from ...utils.roadmap import later
from .tensorfile import load_tensors, save_tensors


def _load_master(ckpt_path: Path):
    """(master as fp32 CPU tensors by the port's names, meta dict) from a
    tag directory."""
    meta_file = ckpt_path / "meta.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    mesh = meta.get("mesh") or {}
    if int(mesh.get("model", 1)) > 1 or int(mesh.get("expert", 1)) > 1:
        raise NotImplementedError(
            f"{ckpt_path} holds a tensor / expert-parallel world's cuts "
            f"(mesh {mesh}); gathering them into whole leaves offline is "
            f"not ported yet: {later(4)} (engine.fp32_params() gathers "
            "them in the world that trained them)")
    master = ckpt_path / "state" / "master.safetensors"
    if not master.exists():
        raise FileNotFoundError(
            f"{master} is missing: not a deepspeed_tpu_torch checkpoint (a "
            "JAX package tag converts with its own dstpu_to_fp32)")
    return {k: v.float() for k, v in load_tensors(master).items()}, meta


def model_config_from_meta(meta: dict):
    """Rebuild the TransformerConfig stored by ``save_checkpoint`` (None if
    the checkpointed model had no dataclass config)."""
    mc = meta.get("model_config")
    if not mc:
        return None
    import torch

    from ...models.transformer import TransformerConfig

    mc = dict(mc)
    dtype = mc.get("dtype")
    if isinstance(dtype, str):
        mc["dtype"] = getattr(torch, dtype, torch.bfloat16)
    return TransformerConfig(**mc)


def convert(ckpt_dir: str, tag: str | None = None, out_dir: str = "fp32_out",
            fmt: str = "auto") -> str:
    """Read a tag's fp32 master and write it out. ``fmt``: "safetensors"
    or "auto" (the flat tree); "hf" is not ported yet."""
    if fmt == "hf":
        raise NotImplementedError(
            f"--format hf (the Hugging Face exporter, models/exporter.py) is "
            f"not ported yet: {later(8)}; use --format safetensors")
    if fmt not in ("auto", "safetensors"):
        raise ValueError(f"unknown format {fmt!r}: auto, hf or safetensors")
    base = Path(ckpt_dir).absolute()
    if tag in (None, "latest"):
        latest = base / "latest"
        if not latest.exists():
            raise FileNotFoundError(f"no 'latest' tag file in {base}")
        tag = latest.read_text().strip()
    master, meta = _load_master(base / tag)
    os.makedirs(out_dir, exist_ok=True)
    # the JAX package's keys: layers.wq -> layers/wq
    save_tensors(os.path.join(out_dir, "model_fp32.safetensors"),
                 {k.replace(".", "/"): v for k, v in master.items()})
    if meta.get("model_config"):
        (Path(out_dir) / "native_config.json").write_text(
            json.dumps(meta["model_config"], indent=2))
    return out_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="dstpu_torch_to_fp32",
        description="deepspeed_tpu_torch checkpoint -> consolidated fp32 "
                    "weights (model_fp32.safetensors)")
    p.add_argument("ckpt_dir", help="directory holding tags + 'latest'")
    p.add_argument("tag", nargs="?", default=None)
    p.add_argument("out_dir", nargs="?", default="fp32_out")
    p.add_argument("--format", choices=("auto", "hf", "safetensors"),
                   default="auto")
    args = p.parse_args(argv)
    out = convert(args.ckpt_dir, args.tag, args.out_dir, args.format)
    print(f"wrote consolidated fp32 weights to {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
