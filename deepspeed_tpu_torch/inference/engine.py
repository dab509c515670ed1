"""InferenceEngine: single-card generation (counterpart of
``deepspeed_tpu/inference/engine.py``).

The engine casts the state dict to the compute dtype on its device, fuses
the attention projections into one ``[wq | wk | wv]`` weight for the
decode step, and serves ``generate`` through ``inference/decode.py``. The
JAX engine compiles one program per shape; this one runs eagerly, so there
is no program cache (CUDA graphs are later work).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch

from ..models.convert import split_fused_qkv
from ..models.transformer import LAYER_PREFIX, Params, layer_params
from ..platform.device import resolve_device
from ..utils.logging import log_dist
from .config import InferenceConfig
from .decode import decode_tokens, generate_tokens, prefill_tokens
from .sampling import per_request_generators, sample_logits

_QKV = ("wq", "wk", "wv")
_BQKV = ("bq", "bk", "bv")


def model_with_dtype(model, dtype):
    """The same model class over a config whose compute dtype is ``dtype``."""
    if model.cfg.dtype == dtype:
        return model
    return type(model)(dataclasses.replace(model.cfg, dtype=dtype))


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
        self.flash_decode = cfg.flash_decode_resolved(self.device)
        cast = {k: v.to(self.device, self.compute_dtype)
                if v.is_floating_point() else v.to(self.device)
                for k, v in params.items()}
        self._fused = (self.model.cfg.objective == "clm"
                       and all(LAYER_PREFIX + n in cast for n in _QKV))
        self.params = self._fuse_qkv(cast) if self._fused else cast
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        log_dist(f"inference: {self.model.cfg.param_count() / 1e6:.1f} M "
                 f"params, {self.compute_dtype} on {self.device}, "
                 f"flash_decode={self.flash_decode}", ranks=[0])

    # ------------------------------------------------------------ qkv fuse
    @staticmethod
    def _fuse_qkv(params: Params) -> Params:
        out = dict(params)
        for fused, names in (("wqkv", _QKV), ("bqkv", _BQKV)):
            keys = [LAYER_PREFIX + n for n in names]
            if all(k in out for k in keys):
                out[LAYER_PREFIX + fused] = torch.cat(
                    [out.pop(k) for k in keys], dim=-1)
        return out

    def _unfused(self, params: Params) -> Params:
        """Split the fused qkv back into per-projection views (``forward``
        reads the training names)."""
        if not self._fused:
            return params
        layers = split_fused_qkv(layer_params(params), self.model.cfg)
        out = {k: v for k, v in params.items()
               if not k.startswith(LAYER_PREFIX)}
        out.update({LAYER_PREFIX + k: v for k, v in layers.items()})
        return out

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    # -------------------------------------------------------------- forward
    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full forward (no cache): (B, S) → (B, S, V) logits."""
        return self.model.apply(self._unfused(self.params),
                                self._ids(input_ids))

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
            cache_len=cache_len)

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
                               cache_len=cache_len, **kw)
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
