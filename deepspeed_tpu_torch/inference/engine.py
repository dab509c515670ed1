"""InferenceEngine: generation on one card or a tensor- / expert-parallel
world (counterpart of ``deepspeed_tpu/inference/engine.py``).

The engine casts the state dict to the compute dtype on its device (the
leaves the model names in ``fp32_param_names()``, an MoE router, stay as
they are), fuses the attention projections into one ``[wq | wk | wv]``
weight for the decode step, quantizes the matmul weights when the config
asks for WOQ, and serves ``generate`` through ``inference/decode.py``. An
MoE model serves on a copy flagged ``moe_eval_mode``: its prefill routes
with the eval capacity factor. The JAX engine
compiles one program per shape; this one runs eagerly, so there is no
program cache. The serving engine (``serving/engine.py``) captures its
slot decode step as one CUDA graph; ``generate()`` runs eagerly.

``tensor_parallel`` / ``expert_parallel``: the engine builds the mesh
``MeshSpec(data=1, expert=ep, model=tp)`` over the ``torch.distributed``
world (``init_distributed``), which must hold exactly ``tp x ep`` ranks,
and keeps this rank's cut of every leaf (``TPLayout.cut``), leaf by leaf:
each is cast, quantized whole (so its bytes are JAX's) and cut, and the
whole one dropped before the next. With no process group the mesh is one
rank and nothing is cut. ``forward()`` of a sharded engine is the training
forward on the rank's cut (``TransformerLM.apply``: Megatron's collectives
over the ``model`` line, the serving MoE combine), its logits all-gathered
along the vocabulary.
"""

from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Optional

import torch

from ..models.convert import cut_leaf, split_fused_qkv
from ..models.transformer import LAYER_PREFIX, Params, TPLayout, layer_params
from ..platform.device import resolve_device
from ..platform.mesh import MeshSpec, build_mesh
from ..utils.logging import log_dist, warning_once
from ..utils.roadmap import later
from .config import InferenceConfig
from .decode import decode_tokens, generate_tokens, prefill_tokens
from .quantization import (QuantizedTensor, dequantize_params,
                           quantize_leaf, quantized_bytes)
from .sampling import per_request_generators, sample_logits

_QKV = ("wq", "wk", "wv")
_BQKV = ("bq", "bk", "bv")


def model_with_dtype(model, dtype):
    """The same model class over a config whose compute dtype is ``dtype``."""
    if model.cfg.dtype == dtype:
        return model
    return type(model)(dataclasses.replace(model.cfg, dtype=dtype),
                       attention_fn=model.attention_fn)


class InferenceEngine:
    """Owns the compute-dtype state dict and serves generate/forward."""

    def __init__(self, model, params: Params,
                 config: InferenceConfig | dict | None = None, device=None):
        self.config = cfg = InferenceConfig.from_any(config)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "InferenceEngine: torch.backends.cuda.matmul.allow_tf32 is "
                "True; the fp32 logits of the decode head would be TF32. "
                "Set it to False (PyTorch's default).")
        self.compute_dtype = cfg.compute_dtype
        self.model = model_with_dtype(model, self.compute_dtype)
        if self.model.cfg.num_experts > 1:
            # the prefill takes the training dispatch: route it with the
            # eval capacity factor; flag a copy, not the caller's model
            if self.model is model:
                self.model = copy.copy(model)
            self.model.moe_eval_mode = True
        self.flash_decode = cfg.flash_decode_resolved(self.device)
        self.mesh = self._serving_mesh(cfg, self.model.cfg.num_experts)
        self.layout = TPLayout.of(self.model.cfg, self.mesh)
        # the decode path reads the layout (and the flags below) off the
        # model; a copy, so the caller's model is not stamped
        if self.model is model:
            self.model = copy.copy(model)
        self.model.tp_layout = self.layout
        prequantized = any(isinstance(v, QuantizedTensor)
                           for v in params.values())
        if prequantized and not cfg.quantize:
            raise ValueError("InferenceEngine: the params hold quantized "
                             "leaves; pass {'quantize': True} to serve them")
        self._fused = (self.model.cfg.objective == "clm"
                       and all(LAYER_PREFIX + n in params for n in _QKV))
        # leaf by leaf: cast, quantize the whole leaf (after the qkv fusion,
        # as the JAX engine: a fused wqkv has its parts' bytes, the scales
        # are per column), then this rank's cut; the whole leaf is dropped
        # before the next
        self.params = {}
        src = self._fuse_qkv(params) if self._fused else dict(params)
        for k in list(src):
            self.params[k] = cut_leaf(self._prepared(k, src.pop(k)),
                                      self.layout.cut(self.model.cfg, k))
        # the prefill's quantized → dense function (None: dense weights)
        self.materialize = None
        if cfg.dequant_per_step:
            warning_once(
                "inference config: dequant_per_step is obsolete — decode "
                "keeps weights quantized and dequantizes at each point of "
                "use; the knob is accepted and changes nothing.")
        if cfg.quantize:
            self.materialize = partial(dequantize_params,
                                       dtype=self.compute_dtype)
            self.model.woq_kernel = cfg.woq_kernel_resolved(self.device)
            log_dist(f"inference: int{cfg.quant_bits} WOQ, "
                     f"{quantized_bytes(self.params) / 2**20:.0f} MiB "
                     f"weights a rank, tp={self.layout.tp}, "
                     f"kernel={self.model.woq_kernel}", ranks=[0])
        if cfg.tp_comm_quant:
            # stamped like woq_kernel; the decode step applies it at tp > 1
            self.model.tp_quant = cfg.tp_comm_quant
            log_dist(f"inference: int{cfg.tp_comm_quant} quantized TP "
                     f"decode collective (tp={self.layout.tp}; wo / w_out "
                     "reductions two-sided int8, logits stay fp)", ranks=[0])
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        log_dist(f"inference: {self.model.cfg.param_count() / 1e6:.1f} M "
                 f"params, {self.compute_dtype} on {self.device}, "
                 f"flash_decode={self.flash_decode}, mesh "
                 f"tp={self.layout.tp} ep={self.layout.ep}", ranks=[0])

    @staticmethod
    def _serving_mesh(cfg: InferenceConfig, num_experts: int):
        """``MeshSpec(data=1, expert=ep, model=tp)`` over the world that
        ``init_distributed`` joined (no group: one rank, which takes tp =
        ep = 1). The JAX engine's ``data`` axis (replicas of the sharded
        model inside one engine) is not ported: the world must be tp x
        ep."""
        import torch.distributed as dist

        tp, ep = int(cfg.tensor_parallel), int(cfg.expert_parallel)
        if num_experts % ep:
            raise ValueError(
                f"expert_parallel={ep} must divide num_experts={num_experts}"
                " (dense models serve with expert_parallel=1)")
        active = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if active else 1
        if not active and tp * ep > 1:
            raise ValueError(
                f"tensor_parallel={tp} x expert_parallel={ep} serve over a "
                f"torch.distributed world of {tp * ep} ranks: call "
                "init_distributed() in each rank's process first")
        if world != tp * ep:
            raise NotImplementedError(
                f"inference over a world of {world} ranks with "
                f"tensor_parallel={tp} x expert_parallel={ep}: the engine's "
                f"data axis (replicas) above 1 is not ported: {later(4)}")
        return build_mesh(MeshSpec(data=1, expert=ep, model=tp))

    def _prepared(self, name: str, v):
        """One whole leaf on the engine's device: floating leaves in the
        compute dtype (but the model's ``fp32_param_names()``), the matmul
        weights quantized when the config asks for WOQ."""
        cfg = self.config
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(v, QuantizedTensor):
            return v.to(self.device)
        if v.is_floating_point() and leaf not in \
                set(self.model.fp32_param_names()):
            v = v.to(self.device, self.compute_dtype)
        else:
            v = v.to(self.device)
        if cfg.quantize:
            v = quantize_leaf(name, v, cfg.quant_group_size, cfg.quant_bits)
        return v

    # ------------------------------------------------------------ qkv fuse
    @staticmethod
    def _fuse_qkv(params: Params) -> Params:
        out = dict(params)
        for fused, names in (("wqkv", _QKV), ("bqkv", _BQKV)):
            keys = [LAYER_PREFIX + n for n in names]
            if all(k in out for k in keys):
                parts = [out.pop(k) for k in keys]
                out[LAYER_PREFIX + fused] = (
                    QuantizedTensor.cat_columns(parts)
                    if isinstance(parts[0], QuantizedTensor)
                    else torch.cat(parts, dim=-1))
        return out

    def _unfused(self, params: Params) -> Params:
        """Split the fused qkv back into per-projection views (``forward``
        reads the training names): the rank's ``[wq_r | wk_r | wv_r]`` at
        its own heads' widths."""
        if not self._fused:
            return params
        layers = split_fused_qkv(layer_params(params), self.model.cfg,
                                 self.layout)
        out = {k: v for k, v in params.items()
               if not k.startswith(LAYER_PREFIX)}
        out.update({LAYER_PREFIX + k: v for k, v in layers.items()})
        return out

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    # -------------------------------------------------------------- forward
    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full forward (no cache): (B, S) → (B, S, V) logits on every
        rank, on dense (dequantized) weights for a quantized engine; a
        tensor- / expert-parallel rank runs the training forward on its
        cut, which needs the process group it was cut over."""
        if self.layout.sharded and not self.layout.mesh.active:
            raise ValueError(
                "forward(): this engine's layout is cut over "
                f"tensor_parallel={self.layout.tp} x expert_parallel="
                f"{self.layout.ep} ranks but was not built over their "
                "process group (init_distributed, then init_inference)")
        params = self.params if self.materialize is None \
            else self.materialize(self.params)
        return self.model.apply(self._unfused(params), self._ids(input_ids))

    __call__ = forward

    # ------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None, *,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 greedy: bool = False, rng: Optional[torch.Generator] = None,
                 request_seeds=None, cache_len: Optional[int] = None):
        """(B, S) prompt ids → (B, max_new_tokens) int64 continuations on
        the engine's device.

        Sampled calls draw from the engine's persistent generator (seeded
        from ``config.seed``) unless ``rng`` is given. ``request_seeds`` —
        one int per row — gives every row its own generator instead, so a
        request samples the same tokens alone or in any batch.
        ``cache_len`` overrides the tight ``S + max_new`` KV allocation."""
        objective = self.model.cfg.objective
        if objective != "clm":
            raise ValueError(
                f"generate() needs a causal LM head; this model's objective "
                f"is {objective!r} — use forward() instead")
        ids = self._ids(input_ids)
        max_new = int(max_new_tokens or self.config.max_out_tokens)
        if request_seeds is not None:
            if rng is not None:
                raise ValueError("pass either rng or request_seeds, not both")
            if len(request_seeds) != ids.shape[0]:
                raise ValueError(
                    f"request_seeds has {len(request_seeds)} entries for a "
                    f"batch of {ids.shape[0]}")
            rng = per_request_generators(request_seeds, self.device)
        rng = rng if rng is not None else self._gen
        sampler = partial(sample_logits, temperature=temperature, top_k=top_k,
                          top_p=top_p, greedy=greedy)
        cache_len = int(cache_len) if cache_len is not None else None
        if self.config.decode_chunk > 0:
            return self._chunked_generate(ids, rng, max_new, sampler,
                                          cache_len)
        return generate_tokens(
            self.model, self.params, ids, rng, max_new=max_new,
            sampler=sampler, eos_token_id=self.config.eos_token_id,
            cache_dtype=self.compute_dtype, flash_decode=self.flash_decode,
            cache_len=cache_len, materialize=self.materialize)

    def _chunked_generate(self, ids, rng, max_new: int, sampler, cache_len):
        """Decode in ``decode_chunk``-step chunks with one host read of the
        (B,) done flags between chunks: once every row hit eos the rest is
        eos-filled instead of decoded. Tokens equal the unchunked path."""
        chunk = int(self.config.decode_chunk)
        eos = self.config.eos_token_id
        kw = dict(sampler=sampler, eos_token_id=eos,
                  flash_decode=self.flash_decode)
        carry = prefill_tokens(self.model, self.params, ids, rng,
                               max_new=max_new, cache_dtype=self.compute_dtype,
                               cache_len=cache_len,
                               materialize=self.materialize, **kw)
        parts = [carry.tok[:, None]]
        remaining = max_new - 1
        while remaining > 0:
            steps = min(chunk, remaining)
            seg, carry = decode_tokens(self.model, self.params, carry,
                                       steps=steps, return_carry=True, **kw)
            parts.append(seg[:, 1:])     # seg[:, 0] is the previous carry
            remaining -= steps
            if remaining > 0 and eos is not None and bool(carry.done.all()):
                parts.append(torch.full((ids.shape[0], remaining), eos,
                                        dtype=torch.long, device=self.device))
                break
        return torch.cat(parts, dim=1)


def init_inference(model, params: Optional[Params] = None,
                   config: InferenceConfig | dict | None = None,
                   device=None) -> InferenceEngine:
    """Public entry point. ``device`` defaults to ``cuda`` and raises
    without a card; pass ``device="cpu"`` to run on the host. Without
    ``params`` the model's ``init`` draws them from seed 0 on the device."""
    dev = resolve_device(device)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    return InferenceEngine(model, params, config, device=dev)
