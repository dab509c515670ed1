"""Decoder-only transformer LM (GPT-2, OPT, Bloom and Llama families).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The parameters are
one flat state dict of tensors: top-level names (``tok_embed``,
``lnf_scale``, ...) and the per-layer weights stacked along a leading
``n_layer`` dim under ``layers.<name>`` (``layers.wq`` is ``(L, d, H*hd)``),
the JAX package's tree flattened with dots. Weights keep the JAX layout
``(in, out)`` for ``y @ W``, so a converted tree is used as it is.

``TransformerLM.init`` draws that state dict from an explicit
``torch.Generator``; ``apply`` is a function of it; ``forward`` runs on the
module's own parameters after ``load_params``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

Params = dict[str, torch.Tensor]
LAYER_PREFIX = "layers."
_BIASES = ("bq", "bk", "bv", "bo", "b_in", "b_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None       # < n_head => GQA/MQA
    d_model: int = 768
    d_ff: Optional[int] = None            # default 4*d_model
    max_seq: int = 1024
    pos_embedding: str = "learned"        # "learned" | "rope" | "alibi"
    norm: str = "layernorm"               # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "gelu"              # "gelu" (tanh) | "silu_glu" | "relu" | ...
    use_bias: bool = True
    tie_embeddings: bool = True
    causal: bool = True
    objective: str = "clm"                # "clm" | "mlm" | "feature"
    rope_theta: float = 10000.0
    rotary_dim: Optional[int] = None      # partial rotary: first N dims/head
    parallel_residual: bool = False       # x + attn(n1(x)) + mlp(n2(x))
    parallel_shared_ln: bool = False      # n2 = n1 (GPT-J / Falcon-7B)
    embed_norm: bool = False              # Bloom word_embeddings_layernorm
    lm_head_bias: bool = False
    tiled_head: int = 1
    post_ln: bool = False
    mlm_transform: bool = False
    fused_xent: Optional[bool] = None
    dropout: float = 0.0
    dtype: Any = torch.bfloat16           # compute dtype
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: Optional[float] = None
    moe_min_capacity: int = 4
    moe_drop_tokens: bool = True
    moe_aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def is_glu(self) -> bool:
        return self.activation.endswith("glu")

    def param_count(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())


# Switches the dense decoder port does not carry yet, with the ROADMAP.md
# item (queue 1) that will port each.
_LATER = (
    (lambda c: c.num_experts > 1, "num_experts > 1",
     "item 5 (MoE: models/moe.py)"),
    (lambda c: c.post_ln, "post_ln", "item 3 (training slice: encoders)"),
    (lambda c: c.mlm_transform, "mlm_transform",
     "item 3 (training slice: encoders)"),
    (lambda c: c.tiled_head > 1, "tiled_head > 1",
     "item 3 (training slice: ops/tiled.py)"),
)


def check_supported(cfg: TransformerConfig) -> None:
    for unported, what, item in _LATER:
        if unported(cfg):
            raise NotImplementedError(
                f"deepspeed_tpu_torch does not port {what} yet: ROADMAP.md "
                f"queue 1, {item}")


def param_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    """Name → shape of every parameter (``transformer.py:392-455``)."""
    d, f, L, V = cfg.d_model, cfg.ffn_dim, cfg.n_layer, cfg.vocab_size
    h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    two_ln = not (cfg.parallel_residual and cfg.parallel_shared_ln)
    layers = {"ln1_scale": (L, d), "wq": (L, d, h * hd),
              "wk": (L, d, kv * hd), "wv": (L, d, kv * hd),
              "wo": (L, h * hd, d)}
    if two_ln:
        layers["ln2_scale"] = (L, d)
    layers["w_in"] = (L, d, f)
    layers["w_out"] = (L, f, d)
    if cfg.is_glu:
        layers["w_gate"] = (L, d, f)
    if cfg.use_bias:
        layers.update({"ln1_bias": (L, d), "bq": (L, h * hd),
                       "bk": (L, kv * hd), "bv": (L, kv * hd), "bo": (L, d),
                       "b_in": (L, f), "b_out": (L, d)})
        if two_ln:
            layers["ln2_bias"] = (L, d)
    shapes = {"tok_embed": (V, d), "lnf_scale": (d,)}
    if cfg.pos_embedding == "learned":
        shapes["pos_embed"] = (cfg.max_seq, d)
    if cfg.use_bias:
        shapes["lnf_bias"] = (d,)
    if cfg.embed_norm:
        shapes["embed_ln_scale"] = (d,)
        if cfg.use_bias:
            shapes["embed_ln_bias"] = (d,)
    if cfg.lm_head_bias:
        shapes["lm_head_bias"] = (V,)
    if not cfg.tie_embeddings and cfg.objective != "feature":
        shapes["lm_head"] = (d, V)
    shapes.update({LAYER_PREFIX + k: s for k, s in layers.items()})
    return shapes


def layer_params(params: Params) -> Params:
    """The stacked per-layer leaves, keyed without the ``layers.`` prefix."""
    n = len(LAYER_PREFIX)
    return {k[n:]: v for k, v in params.items() if k.startswith(LAYER_PREFIX)}


# ------------------------------------------------------------------ helpers
def _norm(x, scale, bias, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rope_tables(positions, theta: float, rd: int):
    """(cos, sin) of the rotary angles, each ``(B, S, 1, rd/2)`` fp32."""
    freqs = 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                          device=positions.device) / rd))
    angles = positions[..., None].float() * freqs
    return angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]


def _apply_rope(q, k, cos, sin, rd: int):
    hd = q.shape[-1]

    def rot(x):
        xr, xp = x[..., :rd], x[..., rd:]
        x1, x2 = xr[..., ::2], xr[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr.shape)
        return torch.cat([out, xp], dim=-1) if rd < hd else out

    return rot(q.float()).to(q.dtype), rot(k.float()).to(k.dtype)


def _rope(q, k, positions, theta: float, rotary_dim: int | None = None):
    """Rotary embeddings on (B, S, H, hd) q/k in the INTERLEAVED-pair basis
    (pairs ``x[..., ::2]`` / ``x[..., 1::2]``, not the half-split one);
    ``rotary_dim`` < hd rotates only the leading dims of each head."""
    rd = rotary_dim or q.shape[-1]
    cos, sin = rope_tables(positions, theta, rd)
    return _apply_rope(q, k, cos, sin, rd)


def _activation(u, name: str):
    if name == "gelu":
        return F.gelu(u, approximate="tanh")       # jax.nn.gelu's default
    if name == "gelu_exact":
        return F.gelu(u)
    if name == "relu":
        return F.relu(u)
    if name in ("silu", "swish"):
        return F.silu(u)
    if name == "quick_gelu":
        return u * torch.sigmoid(1.702 * u)
    raise ValueError(f"unknown activation {name!r}")


def alibi_slopes(n_head: int, device=None) -> torch.Tensor:
    """Standard ALiBi per-head slopes (Bloom; geometric in 2^(-8/n))."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_head).is_integer():
        slopes = pow2_slopes(n_head)
    else:
        closest = 2 ** math.floor(math.log2(n_head))
        slopes = pow2_slopes(closest)
        slopes += pow2_slopes(2 * closest)[0::2][:n_head - closest]
    t = torch.tensor(slopes, dtype=torch.float32)
    # non_blocking: a blocking host-to-card copy would synchronize the
    # stream, once per decode step for an ALiBi model
    return t if device is None else t.to(device, non_blocking=True)


def alibi_bias(slopes, S: int) -> torch.Tensor:
    """Dense (H, S, S) ALiBi bias: slope·(key_pos − query_pos)."""
    pos = torch.arange(S, device=slopes.device)
    rel = (pos[None, :] - pos[:, None]).float()
    return slopes.float()[:, None, None] * rel[None]


def causal_attention(q, k, v, *, mask=None, causal: bool = True, bias=None):
    """Plain attention, fp32 softmax. q: (B,S,H,hd), k/v: (B,S,KV,hd);
    ``bias`` is (S,S), (H,S,S) or (B|1,H|1,S,S); ``mask`` (B,S) on keys."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias.reshape((1,) * (4 - bias.ndim)
                                       + tuple(bias.shape)).float()
    big_neg = torch.finfo(torch.float32).min
    if causal:
        tri = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~tri, big_neg)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :].bool(), big_neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


# -------------------------------------------------------------------- model
class TransformerLM(nn.Module):
    """init / apply over a :class:`TransformerConfig`."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        check_supported(config)
        self.cfg = config
        self.layers = nn.Module()

    # ----------------------------------------------------------------- init
    def param_shapes(self) -> dict[str, tuple]:
        return param_shapes(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None, *,
             device="cpu", dtype=torch.float32) -> Params:
        """Draw a state dict with the JAX init's shapes and scales (normal
        weights scaled by 1/sqrt(fan_in), the output projections by
        1/sqrt(2·L·fan_in), embeddings and the untied head by 0.02; norm
        scales 1, biases 0). Each weight is drawn in fp32 on ``device``
        from ``generator`` (default: seed 0) and stored as ``dtype``."""
        cfg = self.cfg
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        L, d, f = cfg.n_layer, cfg.d_model, cfg.ffn_dim
        special = {"tok_embed": 0.02, "pos_embed": 0.02, "lm_head": 0.02,
                   LAYER_PREFIX + "wo": 1.0 / math.sqrt(2 * L * d),
                   LAYER_PREFIX + "w_out": 1.0 / math.sqrt(2 * L * f)}
        params = {}
        for name, shape in self.param_shapes().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_scale"):
                t = torch.ones(shape, device=device)
            elif leaf.endswith("_bias") or leaf in _BIASES:
                t = torch.zeros(shape, device=device)
            else:
                scale = special.get(name, 1.0 / math.sqrt(shape[-2]))
                t = torch.randn(shape, generator=generator, device=device)
                t.mul_(scale)
            params[name] = t.to(dtype)
        return params

    def load_params(self, params: Params) -> "TransformerLM":
        """Register ``params`` as this module's (frozen) parameters, under
        the same dotted names, so ``forward`` and ``state_dict`` see them."""
        for name, t in params.items():
            owner = self.layers if name.startswith(LAYER_PREFIX) else self
            leaf = name.rsplit(".", 1)[-1]
            owner.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
        return self

    # ---------------------------------------------------------------- apply
    def _maybe_bias(self, y, p, name):
        return y + p[name].to(y.dtype) if self.cfg.use_bias and name in p \
            else y

    def _attention_block(self, x, p, positions, attn_mask):
        cfg = self.cfg
        B, S, _ = x.shape
        h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
        y = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg.norm, cfg.norm_eps)
        q = self._maybe_bias(y @ p["wq"].to(y.dtype), p, "bq").reshape(B, S, h, hd)
        k = self._maybe_bias(y @ p["wk"].to(y.dtype), p, "bk").reshape(B, S, kv, hd)
        v = self._maybe_bias(y @ p["wv"].to(y.dtype), p, "bv").reshape(B, S, kv, hd)
        if cfg.pos_embedding == "rope":
            q, k = _rope(q, k, positions, cfg.rope_theta, cfg.rotary_dim)
        bias = None
        if cfg.pos_embedding == "alibi":
            bias = alibi_bias(alibi_slopes(h, x.device), S)
        o = causal_attention(q, k, v, mask=attn_mask, causal=cfg.causal,
                             bias=bias)
        return self._maybe_bias(o.reshape(B, S, h * hd) @ p["wo"].to(x.dtype),
                                p, "bo")

    def _proj(self, y, p, name):
        """``y @ p[name]`` whether the weight is dense or int8/int4
        (inference WOQ: the engine keeps weights quantized and the decode
        step consumes them at the point of use — through the CUDA GEMM
        when ``self.woq_kernel`` is set, else a per-use dequant)."""
        # imported here: inference/ imports this module
        from ..inference.quantization import matmul_any

        return matmul_any(y, p[name], getattr(self, "woq_kernel", False))

    def _mlp_block(self, y, p):
        cfg = self.cfg
        u = self._maybe_bias(self._proj(y, p, "w_in"), p, "b_in")
        if cfg.is_glu:
            u = F.silu(self._proj(y, p, "w_gate")) * u
        else:
            u = _activation(u, cfg.activation)
        return self._maybe_bias(self._proj(u, p, "w_out"), p, "b_out")

    def _layer(self, x, p, positions, attn_mask):
        cfg = self.cfg
        o = self._attention_block(x, p, positions, attn_mask)
        if cfg.parallel_residual:
            ln = "ln1" if cfg.parallel_shared_ln else "ln2"
            y = _norm(x, p[f"{ln}_scale"], p.get(f"{ln}_bias"), cfg.norm,
                      cfg.norm_eps)
            return x + o + self._mlp_block(y, p)
        x = x + o
        y = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg.norm, cfg.norm_eps)
        return x + self._mlp_block(y, p)

    def _embed(self, params, input_ids):
        """(B, S) ids → ((B, S, d) embeddings, (B, S) positions)."""
        cfg = self.cfg
        B, S = input_ids.shape
        x = F.embedding(input_ids, params["tok_embed"]).to(cfg.dtype)
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
        if cfg.embed_norm:
            x = _norm(x, params["embed_ln_scale"], params.get("embed_ln_bias"),
                      cfg.norm, cfg.norm_eps)
        return x, positions

    def _head_norm(self, params, x):
        return _norm(x, params["lnf_scale"], params.get("lnf_bias"),
                     self.cfg.norm, self.cfg.norm_eps)

    def _head(self, params, x):
        """Final norm + unembedding: (B, S, d) → (B, S, V) logits."""
        cfg = self.cfg
        x = self._head_norm(params, x)
        w = (params["tok_embed"].to(x.dtype).T if cfg.tie_embeddings
             else params["lm_head"].to(x.dtype))
        logits = x @ w
        if cfg.lm_head_bias:
            logits = logits + params["lm_head_bias"].to(logits.dtype)
        return logits

    def apply(self, params: Params, input_ids, *, attn_mask=None):
        """(B, S) ids → (B, S, V) logits in the compute dtype, or (B, S, d)
        final-norm hidden states for ``objective='feature'``."""
        x, positions = self._embed(params, input_ids)
        layers = layer_params(params)
        for i in range(self.cfg.n_layer):
            x = self._layer(x, {k: v[i] for k, v in layers.items()},
                            positions, attn_mask)
        if self.cfg.objective == "feature":
            return self._head_norm(params, x)
        return self._head(params, x)

    def forward(self, input_ids, attn_mask=None):
        return self.apply(dict(self.named_parameters()), input_ids,
                          attn_mask=attn_mask)
