"""Mixture-of-Experts layer and MoE transformer trunk (counterpart of
``deepspeed_tpu/models/moe.py``).

GShard top-1 / top-2 gating with a static per-expert capacity, and the
expert bank as stacked ``(E, d, f)`` weights under every layer: tokens are
grouped per batch row, each group gets the capacity ``C = ceil(S * k * cf /
E)``, and dispatch and combine are one-hot einsums, so the layer is a few
batched products (``torch.einsum`` → ``bmm``) with static shapes. The
decode step (T = 1) routes the whole batch as one group with ``C = B``, so
no decode token is dropped.

Everything here is a function of tensors with no host read-back (no
``.item()``, no data-dependent shape): the serving engine captures the
decode step, MoE layer included, in one CUDA graph.

The router stays fp32: the engines keep ``fp32_param_names()`` out of
their compute cast and WOQ keeps it unquantized, so near-tie routing
decisions do not flap with bf16 rounding.

Expert parallelism serves (the inference engine's ``expert_parallel``):
the router is whole on every rank, so every rank routes alike; a rank
runs its ``E / ep`` experts at ``f / tp`` columns (its ``TPLayout``) on
its slice of the dispatch, and one all-reduce over the ``("expert",
"model")`` line sums the combined outputs (``b_out`` joins on one rank of
each ``model`` line only).

In training (``TPLayout.rows_split``: ``expert`` is a batch axis, each
rank of an ``expert`` line routes its own rows, JAX ``_mlp_block``,
``moe.py:117-158``) the ``(B, E, C, d)`` dispatch goes through an
all-to-all over ``expert`` (chunk j of the experts to rank j), the rank
runs its experts on every rank's slots at ``f / tp`` columns behind
Megatron's *f*, ``w_out``'s partials are all-reduced over ``model``
(*g*) before ``b_out``, and a second all-to-all brings the outputs back
before the combine.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..comm import comm
from ..comm.autograd import exchange
from .transformer import LAYER_PREFIX, TransformerLM, _activation

EXPERT = ("expert",)


def _capacity(tokens_per_group: int, num_experts: int, capacity_factor: float,
              top_k: int, min_capacity: int = 4,
              drop_tokens: bool = True) -> int:
    """Static per-expert capacity; ``drop_tokens=False`` sizes it to hold
    every token of the group (no token is ever dropped)."""
    if not drop_tokens:
        return tokens_per_group
    cap = int(math.ceil(tokens_per_group * top_k * capacity_factor
                        / num_experts))
    return max(cap, min_capacity)


def topk_gating(logits: torch.Tensor, top_k: int, capacity: int,
                choices=None):
    """GShard top-k gating with a static capacity, for each token group.

    ``logits``: (..., T, E) router logits, a group of T tokens per leading
    index; ``choices`` (..., T, top_k), optional: each pass's expert, in
    place of its argmax (a replay of a routing decided elsewhere). Returns
    ``combine`` (..., T, E, C) fp32 weights (0 for a dropped token),
    ``dispatch`` (..., T, E, C) bool and ``aux`` (...,) fp32, the
    load-balancing loss ``E * sum_e mean(prob_e) * mean(top1_e)``.

    Each pass takes every token's best remaining expert (``argmax``: the
    first index on a tie, as ``jnp.argmax``); a token's slot is the count
    of earlier tokens of its group that chose the same expert, after the
    fill the earlier passes left; past ``capacity`` it is dropped. At
    ``top_k > 1`` the kept gates are renormalized over the chosen
    experts."""
    E = logits.shape[-1]
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    experts = torch.arange(E, device=dev)
    slots = torch.arange(capacity, device=dev)
    combine = torch.zeros(probs.shape + (capacity,), device=dev)
    dispatch = torch.zeros(probs.shape + (capacity,), dtype=torch.bool,
                           device=dev)
    remaining = probs
    fill = torch.zeros(probs.shape[:-2] + (E,), dtype=torch.int32,
                       device=dev)
    gates_sum = torch.zeros(probs.shape[:-1], device=dev)
    top1 = None
    for k in range(top_k):
        idx = torch.argmax(remaining, dim=-1) if choices is None \
            else choices[..., k]                               # (..., T)
        mask = (idx[..., None] == experts).to(torch.int32)     # (..., T, E)
        if k == 0:
            top1 = mask
        pos_in_expert = (torch.cumsum(mask, dim=-2, dtype=torch.int32)
                         - mask + fill[..., None, :])
        pos = torch.sum(pos_in_expert * mask, dim=-1)          # (..., T)
        kept = pos < capacity
        gate = torch.sum(probs * mask, dim=-1) * kept          # (..., T)
        onehot_pos = (pos.clamp(max=capacity - 1)[..., None]
                      == slots).float()                        # (..., T, C)
        sel = mask.float() * kept[..., None]                   # (..., T, E)
        combine = combine + (gate[..., None, None] * sel[..., :, None]
                             * onehot_pos[..., None, :])
        dispatch = dispatch | (sel[..., :, None] * onehot_pos[..., None, :]
                               > 0)
        gates_sum = gates_sum + gate
        fill = fill + torch.sum(mask * kept[..., None], dim=-2,
                                dtype=torch.int32)
        remaining = remaining * (1 - mask)
    if top_k > 1:
        combine = combine / gates_sum.clamp(min=1e-9)[..., None, None]
    me = probs.mean(dim=-2)                                    # (..., E)
    ce = top1.float().mean(dim=-2)
    aux = torch.sum(me * ce, dim=-1) * E
    return combine, dispatch, aux


def expert_shapes(cfg) -> dict:
    """The MoE leaves of one layer stack (``moe.py:230`` ``init``), keyed
    without the ``layers.`` prefix; they replace the dense FFN's."""
    d, f, L, E = cfg.d_model, cfg.ffn_dim, cfg.n_layer, cfg.num_experts
    out = {"router": (L, d, E), "w_in": (L, E, d, f), "w_out": (L, E, f, d)}
    if cfg.is_glu:
        out["w_gate"] = (L, E, d, f)
    if cfg.use_bias:
        out.update(b_in=(L, E, f), b_out=(L, E, d))
    return out


def expert_specs(cfg) -> dict:
    """Their sharding (``moe.py:253-264``): experts over ``expert``, the FFN
    width over ``model``, the router whole."""
    M, R = ("model",), ()
    out = {"router": (R, R, R), "w_in": (R, EXPERT, R, M),
           "w_out": (R, EXPERT, M, R)}
    if cfg.is_glu:
        out["w_gate"] = (R, EXPERT, R, M)
    if cfg.use_bias:
        out.update(b_in=(R, EXPERT, M), b_out=(R, EXPERT, R))
    return out


class MoETransformerLM(TransformerLM):
    """``TransformerLM`` with the dense FFN replaced by an expert bank in
    every layer (Mixtral-style); attention is inherited.

    ``moe_eval_mode`` (set by the engines: the training engine's eval step,
    the inference engine's copy of the model) routes with the eval
    capacity factor."""

    routes_experts = True
    moe_eval_mode = False

    def _init_scales(self) -> dict:
        return {**super()._init_scales(), LAYER_PREFIX + "router": 0.02}

    def fp32_param_names(self) -> tuple:
        """Leaf names the engines' compute cast keeps in fp32 (router
        precision governs tie-breaking)."""
        return ("router",)

    def _expert_bias(self, u, p, name):
        lay = getattr(self, "tp_layout", None)
        if name == "b_out" and lay is not None and lay.m > 0 \
                and not lay.rows_split:
            return u      # one rank of the model line adds the row bias
        if self.cfg.use_bias and name in p:
            return u + p[name][:, None, :].to(u.dtype)   # (E, f) → (E, 1, f)
        return u

    def _local(self, combine, dispatch):
        """The rank's experts' slice of the (..., E, C) combine and dispatch
        under expert parallelism (the whole of them otherwise)."""
        lay = getattr(self, "tp_layout", None)
        if lay is None or lay.ep == 1:
            return combine, dispatch
        sl = slice(lay.e0, lay.e0 + lay.experts)
        return combine[..., sl, :], dispatch[..., sl, :]

    def _combined(self, res):
        """The combine's all-reduce over the ``("expert", "model")`` line
        of an inference engine's rank (a copy in a world of one; none with
        no process group or in training)."""
        lay = getattr(self, "tp_layout", None)
        if lay is None:
            return res
        return comm.all_reduce(res, ("expert", "model"), mesh=lay.mesh)

    @staticmethod
    def _bank(p, name, dtype):
        """Dense view of a (possibly int8 / int4) expert bank at its point
        of use: the decode step keeps the banks quantized and dequantizes
        one layer's bank here, inside the step, never a whole-model copy."""
        from ..inference.quantization import QuantizedTensor, dequantize

        w = p[name]
        if isinstance(w, QuantizedTensor):
            return dequantize(w, dtype)
        return w.to(dtype)

    def _experts(self, xs, p, dims: str):
        """The expert FFN on dispatched tokens ``xs`` (``dims`` + ``d``,
        expert dim ``e``): ``w_in`` (and the gate), the activation,
        ``w_out``, each bank read through :meth:`_bank`."""
        cfg, dt = self.cfg, xs.dtype
        u = torch.einsum(f"{dims}d,edf->{dims}f", xs,
                         self._bank(p, "w_in", dt))
        u = self._expert_bias(u, p, "b_in")
        if cfg.is_glu:
            g = torch.einsum(f"{dims}d,edf->{dims}f", xs,
                             self._bank(p, "w_gate", dt))
            u = F.silu(g) * u
        else:
            u = _activation(u, cfg.activation)
        out = torch.einsum(f"{dims}f,efd->{dims}d", u,
                           self._bank(p, "w_out", dt))
        lay = getattr(self, "tp_layout", None)
        if lay is not None and lay.rows_split:
            out = self._tp_out(out)      # training: g, then the row bias
        return self._expert_bias(out, p, "b_out")

    def _mlp_block(self, y, p):
        """y: (B, S, d) post-norm activations, one routing group per batch
        row. Returns (out, the mean of the rows' aux losses)."""
        cfg = self.cfg
        B, S, d = y.shape
        factor = cfg.moe_capacity_factor
        if self.moe_eval_mode:
            factor = cfg.moe_eval_capacity_factor or 2.0 * factor
        C = _capacity(S, cfg.num_experts, factor, cfg.moe_top_k,
                      min_capacity=cfg.moe_min_capacity,
                      drop_tokens=cfg.moe_drop_tokens)
        logits = y.float() @ p["router"].float()               # (B, S, E)
        combine, dispatch, aux = topk_gating(logits, cfg.moe_top_k, C)
        lay = getattr(self, "tp_layout", None)
        if lay is not None and lay.rows_split:
            xs = torch.einsum("bsec,bsd->becd", dispatch.to(y.dtype),
                              y).contiguous()
            out = self._exchanged(xs, p, lay)
            res = torch.einsum("bsec,becd->bsd", combine.to(y.dtype), out)
            return res, aux.mean()
        combine, dispatch = self._local(combine, dispatch)
        # contiguous, as the exchange leaves them: the products then see
        # the same operand layouts with an expert line of one or none
        xs = torch.einsum("bsec,bsd->becd", dispatch.to(y.dtype),
                          y).contiguous()
        out = self._experts(xs, p, "bec").contiguous()
        res = torch.einsum("bsec,becd->bsd", combine.to(y.dtype), out)
        return self._combined(res), aux.mean()

    def _exchanged(self, xs, p, lay):
        """Training's expert parallelism on the ``(B, E, C, d)`` dispatch:
        the all-to-all over ``expert`` (chunk j of the experts to rank j),
        the rank's ``E / ep`` experts on the slots of every rank of the
        line, the all-to-all back. Returns ``(B, E, C, d)``."""
        B, E, C, d = xs.shape
        ep = lay.ep
        send = xs.reshape(B, ep, E // ep, C, d).transpose(0, 1).contiguous()
        got = exchange(send, "expert", mesh=lay.mesh)     # (ep, B, E/ep, ..)
        got = self._tp_in(got.reshape(ep * B, E // ep, C, d))
        out = self._experts(got, p, "bec").reshape(ep, B, E // ep, C, d)
        back = exchange(out.contiguous(), "expert", mesh=lay.mesh)
        return back.transpose(0, 1).reshape(B, E, C, d)

    def _mlp_block_infer(self, y, p):
        """The decode step's dispatch: the B·T tokens as ONE group with
        capacity C = B·T, so no token is dropped. Every expert runs on the
        whole batch (E/k times the routed work; decode reads the whole bank
        anyway). Routing is per token, so this equals :meth:`_mlp_block`
        wherever that drops nothing."""
        cfg = self.cfg
        B, T, d = y.shape
        yt = y.reshape(B * T, d)
        logits = yt.float() @ p["router"].float()
        combine, dispatch, aux = topk_gating(logits, cfg.moe_top_k, B * T)
        combine, dispatch = self._local(combine, dispatch)
        xs = torch.einsum("tec,td->ecd", dispatch.to(y.dtype), yt)
        out = self._experts(xs, p, "ec")
        res = torch.einsum("tec,ecd->td", combine.to(y.dtype), out)
        return self._combined(res).reshape(B, T, d), aux
