"""Carry a JAX ``TransformerLM`` param tree across into the port.

The JAX tree (``deepspeed_tpu/models/transformer.py:392`` ``init``) is a
nested dict: top-level leaves plus ``layers``, whose leaves carry a leading
``(L, ...)`` scan dim (``:514`` ``stacked_fn``); an MoE tree's router and
``(L, E, d, f)`` expert banks (``models/moe.py:230``) are layer leaves
too, checked against ``param_shapes`` like the rest. The port's state dict is
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

A rank of a tensor- or expert-parallel world holds its cut of each leaf
(``TPLayout.cut``, ``models/transformer.py``): :func:`rank_shard` cuts a
whole state dict, or a JAX param tree (an inference engine's, or a
training engine's fp32 master), dense or quantized, into rank r's shards,
and :func:`cut_leaf` one leaf; :func:`gather_rank_shards` puts every
rank's shards of a training state back into JAX's whole leaves,
:func:`gather_leaf` one leaf (the training engine's ``whole_of`` goes
through it), and :func:`place_leaf` writes one rank's cut of a leaf.

The whole training state crosses too: :func:`train_state_from_jax` puts a
JAX ``TrainState`` (as numpy: master, moments, counts, loss scale) into a
port engine, so a JAX run stopped at step k continues in the port; and
:func:`read_fp32_safetensors` reads either package's converter output
(``model_fp32.safetensors``) for ``initialize(params=)``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .transformer import (LAYER_PREFIX, Params, TPLayout, TransformerConfig,
                          param_shapes)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _columns(t, start: int, stop=None):
    if hasattr(t, "columns"):                   # a QuantizedTensor
        return t.columns(start, t.shape[-1] if stop is None else stop)
    return t[..., start:stop]


def split_fused_qkv(layers: dict, cfg: TransformerConfig,
                    layout: TPLayout = None) -> dict:
    """Per-layer leaves with the fused ``wqkv`` / ``bqkv`` split (in
    place) into ``wq``/``wk``/``wv`` and ``bq``/``bk``/``bv``; ``layout``:
    a rank's cut ``[wq_r | wk_r | wv_r]``, at its heads' widths."""
    heads, kv = (layout.heads, layout.kv_heads) if layout is not None \
        else (cfg.n_head, cfg.kv_heads)
    qd = heads * cfg.head_dim
    kvd = kv * cfg.head_dim
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


def cut_leaf(t, cut: dict):
    """The pieces of a leaf that ``cut`` (``{dim: [(start, stop), ...]}``,
    :meth:`TPLayout.cut`) names, each dim's pieces concatenated in order; a
    dense tensor or a ``QuantizedTensor`` (its ``q`` and scales cut alike:
    leading dims by :meth:`select`, the grouped dim by :meth:`rows`, the
    columns by :meth:`columns`). ``{}`` returns the leaf itself."""
    quantized = hasattr(t, "columns")
    for dim, ranges in sorted(cut.items()):
        if not quantized:
            parts = [t.narrow(dim, a, b - a) for a, b in ranges]
            t = torch.cat(parts, dim) if len(parts) > 1 \
                else parts[0].contiguous()
            continue
        last = len(t.shape) - 1
        if dim == last:
            parts = [t.columns(a, b) for a, b in ranges]
            t = type(t).cat_columns(parts) if len(parts) > 1 else parts[0]
        elif len(ranges) != 1:
            raise ValueError(f"cut_leaf: dim {dim} of a quantized leaf is "
                             "cut in one piece")
        elif dim == last - 1:
            t = t.rows(*ranges[0])
        else:
            t = t.select(dim, *ranges[0])
    return t


def place_leaf(whole: torch.Tensor, piece: torch.Tensor, cut: dict) -> None:
    """Write ``piece``, the pieces of a leaf that ``cut`` names as
    :func:`cut_leaf` takes them, into ``whole`` in place."""
    if not cut:
        whole.copy_(piece)
        return
    dim = min(cut)
    rest = {d: r for d, r in cut.items() if d != dim}
    off = 0
    for a, b in cut[dim]:
        place_leaf(whole.narrow(dim, a, b - a), piece.narrow(dim, off, b - a),
                   rest)
        off += b - a


def gather_leaf(pieces: Mapping, cfg: TransformerConfig, name: str,
                tp: int, ep: int = 1) -> torch.Tensor:
    """The whole leaf ``name`` from the ranks' cuts of it (``pieces[(m,
    e)]``: the cut of the rank at ``model`` index m and ``expert`` index e
    of a tp × ep layout, whole over ZeRO; a leaf not cut over an axis needs
    index 0 of it only). A KV head several ranks hold is read from each."""
    first = torch.as_tensor(next(iter(pieces.values())))
    whole = torch.empty(param_shapes(cfg)[name], dtype=first.dtype,
                        device=first.device)
    for (m, e), piece in pieces.items():
        place_leaf(whole, torch.as_tensor(piece),
                   TPLayout.at(cfg, tp, ep, m, e).cut(cfg, name))
    return whole


def gather_rank_shards(shards: Mapping, cfg: TransformerConfig, tp: int,
                       ep: int = 1) -> Params:
    """Every rank's tensor- / expert-parallel shards of a training state
    (``shards[(m, e)]``: the state dict of the rank at ``model`` index m
    and ``expert`` index e, each leaf whole over ZeRO) → the whole leaves,
    as JAX holds them (:func:`gather_leaf` of each)."""
    return {name: gather_leaf({k: sd[name] for k, sd in shards.items()},
                              cfg, name, tp, ep)
            for name in param_shapes(cfg)}


def rank_shard(params, cfg: TransformerConfig, layout: TPLayout) -> Params:
    """Rank ``layout``'s shards of every leaf: of the port's whole state
    dict (the fused ``wqkv`` / ``bqkv`` of an inference engine cut
    head-aligned), or of a JAX param tree (numpy, quantized leaves allowed;
    converted by :func:`params_from_jax` first)."""
    if "layers" in params:
        params = params_from_jax(params, cfg)
    return {k: cut_leaf(v, layout.cut(cfg, k)) for k, v in params.items()}


def _flat(tree: Mapping) -> dict:
    """A JAX param-shaped tree (``layers`` nested) → port names, as torch
    tensors; no shape check (moment placeholders are (0,))."""
    flat = {}
    for name, leaf in tree.items():
        if name == "layers":
            flat.update({LAYER_PREFIX + k: _to_torch(v)
                         for k, v in leaf.items()})
        else:
            flat[name] = _to_torch(leaf)
    return flat


def _field(obj, name: str):
    """A NamedTuple field or a dict key (orbax restores either)."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def train_state_from_jax(state, engine, *, global_steps=None) -> None:
    """Put a JAX ``TrainState`` (numpy leaves, or anything ``np.asarray``
    reads: ``step``, ``master_params``, ``opt_state.mu / nu / count``,
    ``loss_scale``, ``skipped_steps``) into a port ``Engine``, in place on
    its device; under ZeRO each rank keeps its own shard of each whole
    leaf. ``global_steps`` defaults to ``step``. Raises on a missing,
    unexpected or misshaped leaf (another model or optimizer)."""
    from ..runtime.loss_scaler import LossScaleState   # runtime imports us

    opt = _field(state, "opt_state")
    groups = {"master_params": (_field(state, "master_params"),
                                engine.master),
              "mu": (_field(opt, "mu"), engine.opt_state.mu),
              "nu": (_field(opt, "nu"), engine.opt_state.nu)}
    for what, (tree, dst) in groups.items():
        src = _flat(tree)
        if set(src) != set(dst):
            raise ValueError(f"train_state_from_jax: {what} missing "
                             f"{sorted(set(dst) - set(src))}, unexpected "
                             f"{sorted(set(src) - set(dst))}")
        part = {k: engine.shard_of(k, v) for k, v in src.items()}
        for k, t in dst.items():
            if tuple(part[k].shape) != tuple(t.shape):
                raise ValueError(f"train_state_from_jax: {what}/{k} has shape "
                                 f"{tuple(src[k].shape)}, the engine holds "
                                 f"{tuple(t.shape)}")
        with torch.no_grad():
            for k, t in dst.items():
                t.copy_(part[k])
    ls = _field(state, "loss_scale")
    engine.step = int(np.asarray(_field(state, "step")))
    engine.opt_state.count = int(np.asarray(_field(opt, "count")))
    engine.skipped_steps = int(np.asarray(_field(state, "skipped_steps")))
    engine.global_steps = engine.step if global_steps is None \
        else int(global_steps)
    engine.loss_scale = LossScaleState(
        float(np.asarray(_field(ls, "scale"))),
        int(np.asarray(_field(ls, "good_steps"))),
        int(np.asarray(_field(ls, "hysteresis"))))
    engine._skipped_total_prev = float(engine.skipped_steps)
    engine._bad_step_streak = 0


def read_fp32_safetensors(path, cfg: TransformerConfig) -> Params:
    """``model_fp32.safetensors`` from either package's converter (keys
    ``tok_embed``, ``layers/wq``, ...) → the port's fp32 state dict on the
    CPU, for ``initialize(params=)``. Raises on a missing, unexpected,
    misshaped or non-fp32 leaf."""
    from ..runtime.checkpoint.tensorfile import load_tensors  # imports us

    flat = {k.replace("/", "."): v for k, v in load_tensors(path).items()}
    want = param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"read_fp32_safetensors: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(want))}")
    for k, t in flat.items():
        if t.dtype != torch.float32 or tuple(t.shape) != want[k]:
            raise ValueError(f"read_fp32_safetensors: {k} is {t.dtype} "
                             f"{tuple(t.shape)}, want float32 {want[k]}")
    return flat


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
