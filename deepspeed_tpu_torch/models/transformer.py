"""Transformer LM: decoders (GPT-2, OPT, Bloom and Llama families) and
post-LN encoders with an MLM head (BERT).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The parameters are
one flat state dict of tensors: top-level names (``tok_embed``,
``lnf_scale``, ...) and the per-layer weights stacked along a leading
``n_layer`` dim under ``layers.<name>`` (``layers.wq`` is ``(L, d, H*hd)``),
the JAX package's tree flattened with dots. Weights keep the JAX layout
``(in, out)`` for ``y @ W``, so a converted tree is used as it is.

``TransformerLM.init`` draws that state dict from an explicit
``torch.Generator``; ``apply`` is a function of it (each layer optionally
under ``torch.utils.checkpoint``); ``loss`` is the training objective, through
the fused softmax-xent kernels (``ops/xent.py``) where the JAX package
takes its own and through the unfused head otherwise; ``forward`` runs on
the module's own parameters after ``load_params``. Attention goes through
``attention_fn``: the dense ``causal_attention`` by default, or
``ops.flash_attention.make_flash_attention()`` for the CUDA kernels.

Tensor and expert parallelism (``tp_layout``, a :class:`TPLayout` the
engines stamp on the model) spell out what GSPMD does for
``param_specs`` in the JAX package, Megatron's way: each rank holds its
cut of every leaf; q / k / v, ``w_in`` and ``w_gate`` are column-parallel
behind Megatron's *f* (``comm/autograd.py`` ``copy_to``), ``wo`` and
``w_out`` row-parallel with Megatron's *g* (``reduce_from``) and their row
biases added once after it; the embedding is looked up vocab-parallel and
the head's loss is a vocab-parallel NLL over the rank's logits columns, or
``fused_token_nll_tp`` on the fused path. With no layout nothing is cut
and no collective runs; with one every branch runs at every degree, 1
included, each collective over a line of one a copy.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm
from ..comm.autograd import copy_to, max_from, reduce_from
from ..ops.tiled import tiled_matmul
from ..ops.xent import (fused_token_nll, fused_token_nll_tp,
                        fused_xent_eligible)
from ..platform.mesh import AXIS_ORDER, Mesh
from ..utils.roadmap import later

Params = dict[str, torch.Tensor]
LAYER_PREFIX = "layers."
_BIASES = ("bq", "bk", "bv", "bo", "b_in", "b_out", "mlm_dense_b")


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

    def flops_per_token(self) -> float:
        """Forward + backward model FLOPs per token (``transformer.py:116``
        of the JAX package, Megatron's convention): 6 × the non-embedding
        parameters a token uses (for MoE the ``moe_top_k`` routed experts,
        not the whole bank), the attention term 12·L·d·S and the
        unembedding 6·d·V."""
        n_params = self.param_count(non_embedding=True, active_only=True)
        attn = 12 * self.n_layer * self.d_model * self.max_seq
        head = 0 if self.objective == "feature" \
            else 6 * self.d_model * self.vocab_size
        return 6 * n_params + attn + head

    def _ffn_params_per_layer(self, active_only: bool = False) -> int:
        d, f, E = self.d_model, self.ffn_dim, self.num_experts
        per_expert = d * f * (3 if self.is_glu else 2)
        if E == 1:
            return per_expert
        mult = min(self.moe_top_k, E) if active_only else E
        return d * E + mult * per_expert          # the router and the bank

    def param_count(self, non_embedding: bool = False,
                    active_only: bool = False) -> int:
        """The JAX package's count (``transformer.py:143``): the attention
        and FFN matrices of every layer (an MoE layer's router and all its
        experts, or with ``active_only`` its ``moe_top_k`` routed ones) plus
        the embedding table (twice when untied); norms and biases are not
        counted."""
        d, L = self.d_model, self.n_layer
        h, kv, hd = self.n_head, self.kv_heads, self.head_dim
        per_layer = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        per_layer += self._ffn_params_per_layer(active_only=active_only)
        emb = self.vocab_size * d
        total = L * per_layer + (0 if non_embedding else emb)
        if not self.tie_embeddings and not non_embedding \
                and self.objective != "feature":
            total += emb
        return total


# Switches of the config the port does not carry yet, as (predicate, what,
# the ROADMAP.md queue 1 item that will port it); none today.
_LATER: tuple = ()


def check_supported(cfg: TransformerConfig) -> None:
    for unported, what, item in _LATER:
        if unported(cfg):
            raise NotImplementedError(
                f"deepspeed_tpu_torch does not port {what} yet: {later(item)}")


def param_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    """Name → shape of every parameter (``transformer.py:392-455``); an MoE
    trunk (``num_experts > 1``) has the expert bank of ``models/moe.py``
    in place of the dense FFN."""
    d, f, L, V = cfg.d_model, cfg.ffn_dim, cfg.n_layer, cfg.vocab_size
    h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    two_ln = not (cfg.parallel_residual and cfg.parallel_shared_ln)
    dense_ffn = cfg.num_experts == 1
    layers = {"ln1_scale": (L, d), "wq": (L, d, h * hd),
              "wk": (L, d, kv * hd), "wv": (L, d, kv * hd),
              "wo": (L, h * hd, d)}
    if two_ln:
        layers["ln2_scale"] = (L, d)
    if dense_ffn:
        layers["w_in"] = (L, d, f)
        layers["w_out"] = (L, f, d)
        if cfg.is_glu:
            layers["w_gate"] = (L, d, f)
    if cfg.use_bias:
        layers.update({"ln1_bias": (L, d), "bq": (L, h * hd),
                       "bk": (L, kv * hd), "bv": (L, kv * hd), "bo": (L, d)})
        if two_ln:
            layers["ln2_bias"] = (L, d)
        if dense_ffn:
            layers.update(b_in=(L, f), b_out=(L, d))
    if not dense_ffn:
        from .moe import expert_shapes    # moe imports this module

        layers.update(expert_shapes(cfg))
    shapes = {"tok_embed": (V, d)}
    if not cfg.post_ln:           # a post-LN trunk ends normalized
        shapes["lnf_scale"] = (d,)
    if cfg.pos_embedding == "learned":
        shapes["pos_embed"] = (cfg.max_seq, d)
    if cfg.use_bias and not cfg.post_ln:
        shapes["lnf_bias"] = (d,)
    if cfg.mlm_transform:
        shapes.update(mlm_dense_w=(d, d), mlm_dense_b=(d,),
                      mlm_ln_scale=(d,), mlm_ln_bias=(d,))
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


def param_specs(cfg: TransformerConfig) -> dict[str, tuple]:
    """Name → the model's own sharding of each parameter, one tuple of mesh
    axis names per dim (``transformer.py:458-512``, ``P(None, "model")`` as
    ``((), ("model",))``): the tensor-parallel split the ZeRO partitioner
    composes with."""
    M, R = ("model",), ()
    two_ln = not (cfg.parallel_residual and cfg.parallel_shared_ln)
    dense_ffn = cfg.num_experts == 1
    layers = {"ln1_scale": (R, R), "wq": (R, R, M), "wk": (R, R, M),
              "wv": (R, R, M), "wo": (R, M, R)}
    if two_ln:
        layers["ln2_scale"] = (R, R)
    if dense_ffn:
        layers.update(w_in=(R, R, M), w_out=(R, M, R))
        if cfg.is_glu:
            layers["w_gate"] = (R, R, M)
    if cfg.use_bias:
        layers.update(ln1_bias=(R, R), bq=(R, M), bk=(R, M), bv=(R, M),
                      bo=(R, R))
        if two_ln:
            layers["ln2_bias"] = (R, R)
        if dense_ffn:
            layers.update(b_in=(R, M), b_out=(R, R))
    if not dense_ffn:
        from .moe import expert_specs     # moe imports this module

        layers.update(expert_specs(cfg))
    specs = {"tok_embed": (M, R)}
    if not cfg.post_ln:
        specs["lnf_scale"] = (R,)
    if cfg.pos_embedding == "learned":
        specs["pos_embed"] = (R, R)
    if cfg.use_bias and not cfg.post_ln:
        specs["lnf_bias"] = (R,)
    if cfg.mlm_transform:
        specs.update(mlm_dense_w=(R, R), mlm_dense_b=(R,), mlm_ln_scale=(R,),
                     mlm_ln_bias=(R,))
    if cfg.embed_norm:
        specs["embed_ln_scale"] = (R,)
        if cfg.use_bias:
            specs["embed_ln_bias"] = (R,)
    if not cfg.tie_embeddings and cfg.objective != "feature":
        specs["lm_head"] = (R, M)
    if cfg.lm_head_bias:
        specs["lm_head_bias"] = (M,)
    specs.update({LAYER_PREFIX + k: s for k, s in layers.items()})
    return specs


def layer_params(params: Params) -> Params:
    """The stacked per-layer leaves, keyed without the ``layers.`` prefix."""
    n = len(LAYER_PREFIX)
    return {k[n:]: v for k, v in params.items() if k.startswith(LAYER_PREFIX)}


# ------------------------------------------------------- tensor parallelism
# the serving layout's fused projections, sharded as their parts
_FUSED_SPECS = {"wqkv": ((), (), ("model",)), "bqkv": ((), ("model",))}


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """This rank's cut of a model over the mesh's ``model`` axis (``tp``
    ranks, this one ``m``) and ``expert`` axis (``ep``, this one ``e``),
    Megatron's spelling of what ``param_specs`` asks of GSPMD.

    Query heads ``[q0, q0 + heads)`` and with them the rows of ``wo``;
    KV heads ``[kv0, kv0 + kv_heads)``: ``n_kv_head / tp`` a rank, or,
    where ``tp`` is a multiple of ``n_kv_head``, the one KV head this
    rank's query heads read. FFN columns ``[f0, f0 + ffn)``; vocabulary
    rows ``[v0, v1)``, the whole vocabulary on every rank where ``tp``
    does not divide it (``vocab_split`` False: no collective); experts
    ``[e0, e0 + experts)``. ``mesh`` runs the collectives (inactive: they
    return their input). ``rows_split``: the ranks of an ``expert`` line
    hold different rows (training, where ``expert`` is a batch axis: the
    MoE dispatch goes through an all-to-all) rather than the same ones
    (serving: each rank runs its experts on every row, one all-reduce
    combines)."""

    mesh: Any
    tp: int
    ep: int
    m: int
    e: int
    heads: int
    q0: int
    kv_heads: int
    kv0: int
    head_dim: int
    ffn: int
    f0: int
    v0: int
    v1: int
    vocab_split: bool
    experts: int
    e0: int
    rows_split: bool = False
    # each KV head held by tp / n_kv_head ranks (tp a multiple of n_kv_head
    # above it): their grads are the sum over the ranks that hold the head
    kv_shared: bool = False

    @classmethod
    def of(cls, cfg: TransformerConfig, mesh=None,
           rows_split: bool = False) -> "TPLayout":
        """The layout of ``mesh``'s rank (None: one rank, no group)."""
        if mesh is None:
            mesh = Mesh({a: 1 for a in AXIS_ORDER})
        return cls.at(cfg, mesh.size("model"), mesh.size("expert"),
                      mesh.index("model"), mesh.index("expert"), mesh,
                      rows_split)

    @classmethod
    def at(cls, cfg: TransformerConfig, tp: int, ep: int, m: int, e: int,
           mesh=None, rows_split: bool = False) -> "TPLayout":
        """The layout of the rank at ``model`` index ``m`` of ``tp`` and
        ``expert`` index ``e`` of ``ep``."""
        h, kv, f, V = cfg.n_head, cfg.kv_heads, cfg.ffn_dim, cfg.vocab_size
        E = cfg.num_experts
        if h % tp:
            raise ValueError(f"tensor_parallel={tp} must divide n_head={h}")
        if kv % tp and tp % kv:
            raise ValueError(f"tensor_parallel={tp} and n_kv_head={kv}: "
                             "one must divide the other")
        if f % tp:
            raise ValueError(f"tensor_parallel={tp} must divide the FFN "
                             f"width {f}")
        if E % ep:
            raise ValueError(f"expert_parallel={ep} must divide "
                             f"num_experts={E} (dense models serve with "
                             "expert_parallel=1)")
        heads = h // tp
        q0 = m * heads
        if kv % tp == 0:
            kv_heads, kv0 = kv // tp, m * (kv // tp)
        else:        # each KV head is read by the query heads of tp / kv ranks
            kv_heads, kv0 = 1, q0 // (h // kv)
        split = V % tp == 0
        v0, v1 = (m * V // tp, (m + 1) * V // tp) if split else (0, V)
        return cls(mesh=mesh, tp=tp, ep=ep, m=m, e=e, heads=heads, q0=q0,
                   kv_heads=kv_heads, kv0=kv0, head_dim=cfg.head_dim,
                   ffn=f // tp, f0=m * (f // tp), v0=v0, v1=v1,
                   vocab_split=split, experts=E // ep, e0=e * (E // ep),
                   rows_split=rows_split, kv_shared=kv % tp != 0)

    @property
    def sharded(self) -> bool:
        """Does any leaf of this rank differ from the whole one?"""
        return self.tp > 1 or self.ep > 1

    def _model_ranges(self, cfg, leaf: str) -> list:
        """The ``[start, stop)`` ranges of a ``model``-split dim of
        ``leaf``."""
        hd = self.head_dim
        q = (self.q0 * hd, (self.q0 + self.heads) * hd)
        kv = (self.kv0 * hd, (self.kv0 + self.kv_heads) * hd)
        if leaf in ("wq", "bq", "wo"):
            return [q]
        if leaf in ("wk", "wv", "bk", "bv"):
            return [kv]
        if leaf in ("wqkv", "bqkv"):
            qd, kvd = cfg.n_head * hd, cfg.kv_heads * hd
            return [q, (qd + kv[0], qd + kv[1]),
                    (qd + kvd + kv[0], qd + kvd + kv[1])]
        if leaf in ("tok_embed", "lm_head", "lm_head_bias"):
            return [(self.v0, self.v1)]
        return [(self.f0, self.f0 + self.ffn)]

    def _cuts(self, cfg, name: str) -> dict:
        """``{dim: (axis, [(start, stop), ...])}``: each split dim of the
        leaf ``name``, the axis it is cut over and this rank's pieces of it
        (``param_specs`` names the split dims)."""
        leaf = name[len(LAYER_PREFIX):] if name.startswith(LAYER_PREFIX) \
            else name
        spec = _FUSED_SPECS.get(leaf) or param_specs(cfg)[name]
        whole_vocab = leaf in ("tok_embed", "lm_head", "lm_head_bias") \
            and not self.vocab_split
        out = {}
        for dim, axes in enumerate(spec):
            if "model" in axes and self.tp > 1 and not whole_vocab:
                out[dim] = ("model", self._model_ranges(cfg, leaf))
            elif "expert" in axes and self.ep > 1:
                out[dim] = ("expert", [(self.e0, self.e0 + self.experts)])
        return out

    def cut(self, cfg, name: str) -> dict:
        """``{dim: [(start, stop), ...]}``: the pieces of each split dim of
        the leaf ``name`` this rank holds, concatenated in order (``{}``:
        the whole leaf). The fused qkv is cut head-aligned, each rank
        ``[wq_r | wk_r | wv_r]``."""
        return {d: r for d, (_, r) in self._cuts(cfg, name).items()}

    def cut_axes(self, cfg, name: str) -> dict:
        """``{dim: axis}``: the dims of leaf ``name`` this rank holds a
        cut of, and the axis (``"model"`` or ``"expert"``) each is cut
        over."""
        return {d: a for d, (a, _) in self._cuts(cfg, name).items()}

    def local_shape(self, cfg, name: str, shape: tuple) -> tuple:
        """The shape of this rank's cut of a ``shape``-shaped leaf."""
        out = list(shape)
        for dim, ranges in self.cut(cfg, name).items():
            out[dim] = sum(b - a for a, b in ranges)
        return tuple(out)


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


def token_nll(logits, targets):
    """Per-token NLL, fp32, with ``_token_nll_impl``'s rounding
    (``transformer.py:274``): max and subtract in the logits' dtype, then
    fp32 exp, sum and log; the target logit gathered and upcast."""
    m = logits.amax(dim=-1, keepdim=True)
    se = torch.exp((logits - m).float()).sum(dim=-1)
    lse = torch.log(se) + m[..., 0].float()
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - tgt.float()


def vocab_parallel_nll(logits, targets, lay: "TPLayout"):
    """:func:`token_nll` over a vocabulary-split rank's columns ``[v0,
    v1)`` of the logits (JAX ``_token_nll`` under GSPMD): the max and the
    sum of exps exchanged over the ``model`` line, the target logit taken
    on the rank that holds it and summed; ``targets`` are global ids. The
    same rounding points as :func:`token_nll`."""
    mesh = lay.mesh
    m = max_from(logits.amax(dim=-1, keepdim=True), "model", mesh=mesh)
    se = reduce_from(torch.exp((logits - m).float()).sum(dim=-1), "model",
                     mesh=mesh)
    # every rank adds the max: its grad enters max_from's sum once; in
    # fp32, where m / tp summed over the line is m exactly (tp a power of
    # two), so the add rounds as token_nll's does
    shift = reduce_from(m[..., 0].float() / lay.tp, "model", mesh=mesh)
    lse = torch.log(se) + shift
    local = targets.long() - lay.v0
    hit = (local >= 0) & (local < logits.shape[-1])
    tgt = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None])
    tgt = reduce_from(torch.where(hit, tgt[..., 0], 0), "model", mesh=mesh)
    return lse - tgt.float()


def vocab_lookup(table, ids, lay: "TPLayout"):
    """Megatron's vocab-parallel embedding (JAX ``vocab_parallel_lookup``,
    ``transformer.py:213-244``): the rank's rows ``[v0, v1)`` of the
    table, foreign ids masked to zero, summed over the ``model`` line."""
    local = ids - lay.v0
    hit = (local >= 0) & (local < lay.v1 - lay.v0)
    rows = F.embedding(torch.where(hit, local, 0), table)
    rows = rows.masked_fill(~hit[..., None], 0)
    return reduce_from(rows, "model", mesh=lay.mesh)


# remat policies (``runtime/engine.py:70-99`` of the JAX package). ``full`` /
# ``save_nothing`` keep a layer's inputs only; ``dots_saveable`` also keeps
# every matmul output; ``save_names`` keeps the residual stream entering the
# layer and the projected attention output; ``save_names_mlp`` adds the MLP's
# pre-activation (the gated product for a GLU).
_MATMULS = ("mm", "addmm", "bmm", "baddbmm")
REMAT_POLICIES = ("full", "save_nothing", "dots_saveable", "save_names",
                  "save_names_mlp")


def _checkpointed(fn, save_matmuls: bool = False):
    """``fn`` under a non-reentrant ``torch.utils.checkpoint``: its tensor
    inputs are kept and everything inside is recomputed in the backward,
    the flash forward kernel included; with ``save_matmuls`` selective
    checkpointing also keeps every matmul output (JAX's
    ``checkpoint_policies.dots_saveable``)."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if save_matmuls:
        ops = {getattr(torch.ops.aten, n).default for n in _MATMULS}

        def pick(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in ops
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = partial(create_selective_checkpoint_contexts, pick)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


# -------------------------------------------------------------------- model
class TransformerLM(nn.Module):
    """init / apply over a :class:`TransformerConfig`."""

    # an MoE trunk (models/moe.py) routes tokens to an expert bank; this
    # dense class has no bank to route to
    routes_experts = False

    def __init__(self, config: TransformerConfig, attention_fn=None):
        super().__init__()
        check_supported(config)
        if (config.num_experts > 1) != self.routes_experts:
            raise ValueError(
                f"{type(self).__name__} cannot run num_experts="
                f"{config.num_experts}: MoE configs take MoETransformerLM "
                "(build_model picks the class)")
        if attention_fn is not None and not config.causal \
                and getattr(attention_fn, "causal", True):
            raise ValueError(
                "encoder (causal=False) configs require the default "
                "attention or one built for them (make_flash_attention("
                "causal=False)): a causal attention_fn would silently break "
                "bidirectionality")
        if attention_fn is not None and config.pos_embedding == "alibi" \
                and not (getattr(attention_fn, "accepts_bias", False)
                         or getattr(attention_fn, "accepts_alibi_slopes",
                                    False)):
            raise ValueError(
                "alibi needs an additive score bias; this attention_fn "
                "accepts neither a bias nor alibi slopes")
        self.cfg = config
        self.attention_fn = attention_fn          # None: causal_attention
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
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        special = self._init_scales()
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

    def _init_scales(self) -> dict:
        """The weights whose init scale is not 1/sqrt(fan_in)."""
        L, d, f = self.cfg.n_layer, self.cfg.d_model, self.cfg.ffn_dim
        return {"tok_embed": 0.02, "pos_embed": 0.02, "lm_head": 0.02,
                LAYER_PREFIX + "wo": 1.0 / math.sqrt(2 * L * d),
                LAYER_PREFIX + "w_out": 1.0 / math.sqrt(2 * L * f)}

    def fp32_param_names(self) -> tuple:
        """Leaf names the engines keep in fp32 under a bf16 / fp16 compute
        cast: none in a dense trunk (``MoETransformerLM``: the router)."""
        return ()

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

    def _layout(self) -> Optional[TPLayout]:
        """The engine's ``tp_layout``: None with no process group."""
        return getattr(self, "tp_layout", None)

    def _tp_in(self, y):
        """Megatron's *f* before the column-parallel projections."""
        lay = self._layout()
        return y if lay is None else copy_to(y, "model", mesh=lay.mesh)

    def _tp_out(self, y):
        """Megatron's *g* after the row-parallel ones (before their
        biases)."""
        lay = self._layout()
        return y if lay is None else reduce_from(y, "model", mesh=lay.mesh)

    def _attention_block(self, x, p, positions, attn_mask):
        cfg = self.cfg
        B, S, _ = x.shape
        lay = self._layout()
        h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
        if lay is not None:              # the rank's heads
            h, kv = lay.heads, lay.kv_heads
        y = x if cfg.post_ln else _norm(x, p["ln1_scale"], p.get("ln1_bias"),
                                        cfg.norm, cfg.norm_eps)
        y = self._tp_in(y)
        q = self._maybe_bias(y @ p["wq"].to(y.dtype), p, "bq").reshape(B, S, h, hd)
        k = self._maybe_bias(y @ p["wk"].to(y.dtype), p, "bk").reshape(B, S, kv, hd)
        v = self._maybe_bias(y @ p["wv"].to(y.dtype), p, "bv").reshape(B, S, kv, hd)
        if cfg.pos_embedding == "rope":
            q, k = _rope(q, k, positions, cfg.rope_theta, cfg.rotary_dim)
        attn = self.attention_fn or partial(causal_attention, causal=cfg.causal)
        attn_kw = {}
        if cfg.pos_embedding == "alibi":
            # functions that take slopes build the ramp themselves (the
            # flash kernels in-kernel); the dense path gets the (H, S, S) bias
            slopes = alibi_slopes(cfg.n_head, x.device)
            if lay is not None:      # the rank's heads of the global ramp
                slopes = slopes[lay.q0:lay.q0 + h]
            if getattr(attn, "accepts_alibi_slopes", False):
                attn_kw["alibi_slopes"] = slopes
            else:
                attn_kw["bias"] = alibi_bias(slopes, S)
        o = attn(q, k, v, mask=attn_mask, **attn_kw)
        return self._maybe_bias(
            self._tp_out(o.reshape(B, S, h * hd) @ p["wo"].to(x.dtype)), p,
            "bo")

    def _proj(self, y, p, name):
        """``y @ p[name]`` whether the weight is dense or int8/int4
        (inference WOQ: the engine keeps weights quantized and the decode
        step consumes them at the point of use — through the CUDA GEMM
        when ``self.woq_kernel`` is set, else a per-use dequant)."""
        # imported here: inference/ imports this module
        from ..inference.quantization import matmul_any

        return matmul_any(y, p[name], getattr(self, "woq_kernel", False))

    def _mlp_pre(self, y, p):
        """The MLP up to the activation JAX tags ``mlp_h``: the
        pre-activation, or the gated product for a GLU."""
        y = self._tp_in(y)
        u = self._maybe_bias(self._proj(y, p, "w_in"), p, "b_in")
        if self.cfg.is_glu:
            u = F.silu(self._proj(y, p, "w_gate")) * u
        return u

    def _mlp_post(self, u, p):
        if not self.cfg.is_glu:
            u = _activation(u, self.cfg.activation)
        return self._maybe_bias(self._tp_out(self._proj(u, p, "w_out")), p,
                                "b_out")

    def _mlp_block(self, y, p):
        """The FFN half: (out, aux loss). A dense block has no aux loss
        (None); an MoE block returns its load-balancing loss."""
        return self._mlp_post(self._mlp_pre(y, p), p), None

    def _ln(self, x, p, name):
        return _norm(x, p[f"{name}_scale"], p.get(f"{name}_bias"),
                     self.cfg.norm, self.cfg.norm_eps)

    def _residual(self, x, o, p):
        """The stream after attention: post-LN normalizes it here."""
        return self._ln(x + o, p, "ln1") if self.cfg.post_ln else x + o

    def _mlp_input(self, x, res, p):
        cfg = self.cfg
        if cfg.post_ln:
            return res
        if cfg.parallel_residual:
            return self._ln(x, p, "ln1" if cfg.parallel_shared_ln else "ln2")
        return self._ln(res, p, "ln2")

    def _finish(self, res, m, p):
        return self._ln(res + m, p, "ln2") if self.cfg.post_ln else res + m

    def _after_attention(self, x, o, p):
        res = self._residual(x, o, p)
        m, aux = self._mlp_block(self._mlp_input(x, res, p), p)
        return self._finish(res, m, p), aux

    def _layer(self, x, p, positions, attn_mask):
        """Pre-LN ``x + attn(n1(x))`` then ``+ mlp(n2(.))``; the parallel
        block ``x + attn(n1(x)) + mlp(n(x))``; the post-LN (BERT) block with
        its norms after each residual. Returns (x, the MLP's aux loss)."""
        o = self._attention_block(x, p, positions, attn_mask)
        return self._after_attention(x, o, p)

    def _remat_layer(self, policy: Optional[str]):
        """``_layer`` under a remat policy (:data:`REMAT_POLICIES`).
        PyTorch has no named activations, so ``save_names`` and
        ``save_names_mlp`` cut the layer into checkpointed segments whose
        inputs are exactly the saved names: ``x -> attn_out``, then ``(x,
        attn_out) -> out``, with a third cut at ``mlp_h``. An MoE block
        tags nothing inside its expert bank (as the JAX one), so there
        ``save_names_mlp`` is ``save_names``."""
        if policy in (None, "none"):
            return self._layer
        if policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat policy {policy!r} is not ported yet: {later(6, 'b')}")
        if not policy.startswith("save_names"):
            return _checkpointed(self._layer, policy == "dots_saveable")
        attn = _checkpointed(self._attention_block)
        if policy == "save_names" or self.routes_experts:
            rest = _checkpointed(self._after_attention)
        else:
            pre = _checkpointed(lambda x, o, p: self._mlp_pre(
                self._mlp_input(x, self._residual(x, o, p), p), p))
            post = _checkpointed(lambda x, o, u, p: self._finish(
                self._residual(x, o, p), self._mlp_post(u, p), p))

            def rest(x, o, p):
                return post(x, o, pre(x, o, p), p), None

        def layer(x, p, positions, attn_mask):
            return rest(x, attn(x, p, positions, attn_mask), p)

        return layer

    def _embed(self, params, input_ids):
        """(B, S) ids → ((B, S, d) embeddings, (B, S) positions)."""
        cfg = self.cfg
        B, S = input_ids.shape
        lay = self._layout()
        if lay is not None and lay.vocab_split:
            x = vocab_lookup(params["tok_embed"], input_ids, lay) \
                .to(cfg.dtype)
        else:
            x = F.embedding(input_ids, params["tok_embed"]).to(cfg.dtype)
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
        if cfg.embed_norm:
            x = _norm(x, params["embed_ln_scale"], params.get("embed_ln_bias"),
                      cfg.norm, cfg.norm_eps)
        return x, positions

    def _head_norm(self, params, x):
        """Final norm; a post-LN trunk has none (each block ends
        normalized)."""
        if self.cfg.post_ln:
            return x
        return _norm(x, params["lnf_scale"], params.get("lnf_bias"),
                     self.cfg.norm, self.cfg.norm_eps)

    def _pre_head(self, params, x):
        """Final norm + (BERT) MLM transform (dense, activation, norm):
        everything before the unembedding product, shared by the logits
        head and the fused-xent loss path."""
        cfg = self.cfg
        x = self._head_norm(params, x)
        if cfg.mlm_transform:
            x = _activation(x @ params["mlm_dense_w"].to(x.dtype)
                            + params["mlm_dense_b"].to(x.dtype),
                            cfg.activation)
            x = _norm(x, params["mlm_ln_scale"], params.get("mlm_ln_bias"),
                      cfg.norm, cfg.norm_eps)
        return x

    def _head(self, params, x, gather: bool = True):
        """Pre-head + unembedding: (B, S, d) → (B, S, V) logits. A
        vocabulary-split rank forms its columns (behind Megatron's *f*)
        and, with ``gather``, all-gathers the rest (no grad through the
        gather: the loss takes the rank's columns)."""
        cfg = self.cfg
        x = self._pre_head(params, x)
        lay = self._layout()
        split = lay is not None and lay.vocab_split
        if split:
            x = copy_to(x, "model", mesh=lay.mesh)
        w = (params["tok_embed"].to(x.dtype).T if cfg.tie_embeddings
             else params["lm_head"].to(x.dtype))
        if cfg.tiled_head > 1 and w.shape[1] % cfg.tiled_head == 0:
            logits = tiled_matmul(x, w, cfg.tiled_head)
        else:
            logits = x @ w
        if cfg.lm_head_bias:
            logits = logits + params["lm_head_bias"].to(logits.dtype)
        if split and gather:
            logits = comm.all_gather(logits.detach(), "model",
                                     logits.ndim - 1, mesh=lay.mesh)
        return logits

    def _trunk(self, params: Params, input_ids, attn_mask, remat_policy):
        """Embed + layer stack: (B, S) ids → ((B, S, d) before the final
        norm, the layers' aux losses summed: None for a dense trunk)."""
        x, positions = self._embed(params, input_ids)
        layers = layer_params(params)
        layer = self._remat_layer(remat_policy)
        aux = None
        for i in range(self.cfg.n_layer):
            x, a = layer(x, {k: v[i] for k, v in layers.items()}, positions,
                         attn_mask)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def apply(self, params: Params, input_ids, *, attn_mask=None,
              remat_policy: Optional[str] = None, return_aux: bool = False):
        """(B, S) ids → (B, S, V) logits in the compute dtype, or (B, S, d)
        final-norm hidden states for ``objective='feature'``; with
        ``return_aux`` also the summed aux loss (0 for a dense trunk).

        A ``layers.<name>`` value is the stacked ``(L, ...)`` tensor or a
        sequence of L per-layer tensors (the training engine's leaves).
        ``remat_policy`` (:data:`REMAT_POLICIES`) runs each layer under
        ``torch.utils.checkpoint``, as the JAX trunk wraps its scan body in
        ``jax.checkpoint``."""
        x, aux = self._trunk(params, input_ids, attn_mask, remat_policy)
        if self.cfg.objective == "feature":
            out = self._head_norm(params, x)
        else:
            out = self._head(params, x)
        if return_aux:
            return out, (aux if aux is not None else
                         torch.zeros((), device=out.device))
        return out

    # ----------------------------------------------------------------- loss
    def loss(self, params: Params, batch: dict, *,
             remat_policy: Optional[str] = None):
        """Objective-dependent cross-entropy, fp32, mean over the counted
        tokens (``transformer.py:781``): ``clm`` next-token over the
        (``loss_mask``-ed) positions, ``mlm`` ``batch['labels']`` at the
        ``loss_mask`` positions; an MoE trunk adds ``moe_aux_loss_weight``
        × its summed aux loss. Where :meth:`_fused_xent_active` says so
        the head runs through the fused xent kernels and no logits are
        formed; the mask and the mean stay outside them."""
        cfg = self.cfg
        if cfg.objective == "feature":
            raise ValueError(
                "objective='feature' models have no unembedding/LM loss; "
                "train them under a task head (apply() gives hidden states)")
        ids = batch["input_ids"]
        mlm = cfg.objective == "mlm"
        attn_mask = batch.get("attention_mask")
        compute = getattr(params.get("tok_embed"), "dtype", None)
        if self._fused_xent_active(ids.device.type == "cuda", compute):
            x, aux = self._trunk(params, ids, attn_mask, remat_policy)
            feats = self._pre_head(params, x)
            if mlm:
                nll = self._fused_nll(params, feats, batch["labels"])
            else:
                nll = self._fused_nll(params, feats[:, :-1], ids[:, 1:])
        else:
            x, aux = self._trunk(params, ids, attn_mask, remat_policy)
            logits = self._head(params, x, gather=False)
            if mlm:
                nll = self._token_nll(logits, batch["labels"])
            else:
                nll = self._token_nll(logits[:, :-1], ids[:, 1:])
        mask = batch["loss_mask"] if mlm else batch.get("loss_mask")
        if mask is None:
            ce = nll.mean()
        else:
            mask = (mask if mlm else mask[:, 1:]).float()
            ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        if cfg.num_experts > 1:
            ce = ce + cfg.moe_aux_loss_weight * aux
        return ce

    def _token_nll(self, logits, targets):
        """:func:`token_nll`, or over a vocabulary-split rank's columns
        :func:`vocab_parallel_nll`."""
        lay = self._layout()
        if lay is not None and lay.vocab_split:
            return vocab_parallel_nll(logits, targets, lay)
        return token_nll(logits, targets)

    def _fused_nll(self, params, feats, targets):
        """(B, S', d) features and (B, S') targets → (B, S') fp32 NLL
        through the fused kernels; the table and the bias go in the
        features' dtype (``_fused_nll``, ``transformer.py:871``)."""
        B, S, d = feats.shape
        bias = (params["lm_head_bias"].to(feats.dtype)
                if self.cfg.lm_head_bias else None)
        lay = self._layout()
        args = (feats.reshape(B * S, d), params["tok_embed"].to(feats.dtype),
                bias, targets.reshape(B * S))
        if lay is not None:          # vocab_split: _fused_xent_active
            nll = fused_token_nll_tp(*args, v0=lay.v0, mesh=lay.mesh)
        else:
            nll = fused_token_nll(*args)
        return nll.reshape(B, S)

    def _fused_xent_active(self, on_card: bool, compute_dtype=None) -> bool:
        """Would the JAX package route this loss through its fused
        softmax-xent kernels (#10-#12; ``_fused_xent_active``,
        ``transformer.py:823-865``)? Only for a tied clm/mlm head at an
        eligible width and dtype; then ``fused_xent=True`` always, and the
        auto mode (``None``) on its accelerator, which the port reads as
        the card. A tensor-parallel rank takes it only where ``tp`` divides
        the vocabulary (``fused_token_nll_tp``), as JAX does."""
        cfg = self.cfg
        if cfg.fused_xent is False or not cfg.tie_embeddings \
                or cfg.objective not in ("clm", "mlm"):
            return False
        lay = self._layout()
        if lay is not None and not lay.vocab_split:
            return False
        if not fused_xent_eligible(cfg.dtype, compute_dtype, cfg.d_model,
                                    on_card):
            return False
        return bool(cfg.fused_xent) or on_card

    def forward(self, input_ids, attn_mask=None):
        return self.apply(dict(self.named_parameters()), input_ids,
                          attn_mask=attn_mask)
