"""Carry a JAX ``TransformerLM`` param tree across into the port.

The JAX tree (``deepspeed_tpu/models/transformer.py:392`` ``init``) is a
nested dict: top-level leaves plus ``layers``, whose leaves carry a leading
``(L, ...)`` scan dim (``:514`` ``stacked_fn``). The port's state dict is
the same tree flattened with dots, in the same ``(in, out)`` layouts, so
the conversion is a rename plus a dtype-preserving copy. The inference
engine's fused serving layout (``wqkv`` / ``bqkv``, ``inference/
engine.py:200-208``) is split back into ``wq``/``wk``/``wv``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .transformer import LAYER_PREFIX, Params, TransformerConfig, param_shapes


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def split_fused_qkv(layers: dict, cfg: TransformerConfig) -> dict:
    """Per-layer leaves with the fused ``wqkv`` / ``bqkv`` split (in
    place) into ``wq``/``wk``/``wv`` and ``bq``/``bk``/``bv``."""
    qd = cfg.n_head * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim
    for fused, names in (("wqkv", ("wq", "wk", "wv")),
                         ("bqkv", ("bq", "bk", "bv"))):
        if fused in layers:
            t = layers.pop(fused)
            parts = (t[..., :qd], t[..., qd:qd + kvd], t[..., qd + kvd:])
            layers.update(dict(zip(names, parts)))
    return layers


def params_from_jax(tree: Mapping, cfg: TransformerConfig, *,
                    device="cpu") -> Params:
    """JAX param tree (numpy arrays, or anything ``np.asarray`` reads) →
    the port's state dict on ``device``. Raises on a missing, unexpected or
    misshaped leaf."""
    flat = {}
    for name, leaf in tree.items():
        if name == "layers":
            layers = split_fused_qkv(
                {k: np.asarray(v) for k, v in leaf.items()}, cfg)
            flat.update({LAYER_PREFIX + k: v for k, v in layers.items()})
        else:
            flat[name] = leaf
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for name, leaf in flat.items():
        t = _to_torch(leaf)
        if tuple(t.shape) != want[name]:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(t.shape)}, the config wants "
                             f"{want[name]}")
        out[name] = t.to(device)
    return out
