"""Carry a JAX ``TransformerLM`` param tree across into the port.

The JAX tree (``deepspeed_tpu/models/transformer.py:392`` ``init``) is a
nested dict: top-level leaves plus ``layers``, whose leaves carry a leading
``(L, ...)`` scan dim (``:514`` ``stacked_fn``). The port's state dict is
the same tree flattened with dots, in the same ``(in, out)`` layouts, so
the conversion is a rename plus a dtype-preserving copy. The inference
engine's fused serving layout (``wqkv`` / ``bqkv``, ``inference/
engine.py:200-208``) is split back into ``wq``/``wk``/``wv``.

A JAX-quantized tree (what ``InferenceEngine(..., {"quantize": True})
.params`` holds) converts too: each ``QuantizedTensor`` leaf — anything
with ``q``, ``scale``, ``group_size`` and ``bits`` — becomes the port's
``QuantizedTensor`` with the same bytes, and a fused quantized ``wqkv``
splits along N in both ``q`` and ``scale``.

A JAX training engine's fp32 master tree (``engine.fp32_params()``) has
the model's own tree layout and converts the same way, into the port
engine's ``params=``; :func:`params_to_numpy` goes back, so that master
params after N steps compare leaf by leaf.
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


def _columns(t, start: int, stop=None):
    if hasattr(t, "columns"):                   # a QuantizedTensor
        return t.columns(start, t.shape[-1] if stop is None else stop)
    return t[..., start:stop]


def split_fused_qkv(layers: dict, cfg: TransformerConfig) -> dict:
    """Per-layer leaves with the fused ``wqkv`` / ``bqkv`` split (in
    place) into ``wq``/``wk``/``wv`` and ``bq``/``bk``/``bv``."""
    qd = cfg.n_head * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim
    for fused, names in (("wqkv", ("wq", "wk", "wv")),
                         ("bqkv", ("bq", "bk", "bv"))):
        if fused in layers:
            t = layers.pop(fused)
            parts = (_columns(t, 0, qd), _columns(t, qd, qd + kvd),
                     _columns(t, qd + kvd))
            layers.update(dict(zip(names, parts)))
    return layers


def _leaf(a):
    """A tensor, or the port's QuantizedTensor for a quantized JAX leaf."""
    if all(hasattr(a, k) for k in ("q", "scale", "group_size", "bits")):
        from ..inference.quantization import QuantizedTensor  # imports us

        return QuantizedTensor(_to_torch(a.q), _to_torch(a.scale),
                               int(a.group_size), int(a.bits))
    return _to_torch(a)


def params_from_jax(tree: Mapping, cfg: TransformerConfig, *,
                    device="cpu") -> Params:
    """JAX param tree (numpy arrays, or anything ``np.asarray`` reads;
    quantized leaves allowed) → the port's state dict on ``device``.
    Raises on a missing, unexpected or misshaped leaf."""
    flat = {}
    for name, leaf in tree.items():
        if name == "layers":
            layers = split_fused_qkv(
                {k: _leaf(v) for k, v in leaf.items()}, cfg)
            flat.update({LAYER_PREFIX + k: v for k, v in layers.items()})
        else:
            flat[name] = _leaf(leaf)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for name, t in flat.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(t.shape)}, the config wants "
                             f"{want[name]}")
        out[name] = t.to(device)
    return out


def params_to_numpy(params: Params) -> dict:
    """The port's state dict → the JAX tree layout (``layers`` nested) of
    fp32 numpy arrays."""
    tree: dict = {}
    for name, t in params.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if name.startswith(LAYER_PREFIX):
            tree.setdefault("layers", {})[name[len(LAYER_PREFIX):]] = a
        else:
            tree[name] = a
    return tree
