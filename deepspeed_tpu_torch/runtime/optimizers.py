"""Optimizers over the fp32 master state dict (counterpart of
``deepspeed_tpu/runtime/optimizers.py``).

Each optimizer is ``init(params) -> OptState`` and ``update(params, state,
grads, lr) -> (params, state)`` on dicts of fp32 tensors, with JAX's order
of operations: the bias correction from the incremented count, AdamW's
decoupled decay added to the step before ``lr`` multiplies it. The JAX
package has no kernel for them; here they are PyTorch ops, and ``update``
writes the params and moments IN PLACE (a 1.5 B-parameter state has no
room for a second copy) and returns the same dicts; under ZeRO the dicts
hold this rank's shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """Moments; unused slots hold (0,)-shaped placeholders, as in JAX."""
    mu: Params
    nu: Params
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params, float], tuple]


def _zeros(params):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _empty(params):
    return {k: torch.zeros((0,), dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _bias_corrections(b1, b2, count, like):
    """1 - b^count in fp32, as JAX computes them from the int count."""
    c = _f32(float(count), like)
    return 1.0 - _f32(b1, like) ** c, 1.0 - _f32(b2, like) ** c


# ------------------------------------------------------------------- Adam(W)
def adam(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
         adamw: bool = True, bias_correction: bool = True) -> Optimizer:
    b1, b2 = betas

    def init(params):
        return OptState(_zeros(params), _zeros(params), 0)

    def update(params, state, grads, lr):
        count = state.count + 1
        for k, p in params.items():
            m, v = state.mu[k], state.nu[k]
            if bias_correction:
                bc1, bc2 = _bias_corrections(b1, b2, count, p)
            g = grads[k].float()
            if weight_decay and not adamw:      # classic Adam: L2 in the grad
                g = g + weight_decay * p
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g.square())
            if bias_correction:
                step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            else:
                step = m / v.sqrt().add_(eps)
            if weight_decay and adamw:          # AdamW: decoupled decay
                step.add_(weight_decay * p)
            p.sub_(step.mul_(lr))
        state.count = count
        return params, state

    return Optimizer("adamw" if adamw else "adam", init, update)


# --------------------------------------------------------------------- Lion
def lion(betas=(0.9, 0.99), weight_decay: float = 0.0) -> Optimizer:
    b1, b2 = betas

    def init(params):
        return OptState(_zeros(params), _empty(params), 0)

    def update(params, state, grads, lr):
        for k, p in params.items():
            m, g = state.mu[k], grads[k].float()
            upd = torch.sign(b1 * m + (1.0 - b1) * g)
            if weight_decay:
                upd = upd + weight_decay * p
            m.copy_(b2 * m + (1.0 - b2) * g)
            p.sub_(lr * upd)
        state.count += 1
        return params, state

    return Optimizer("lion", init, update)


# --------------------------------------------------------------------- LAMB
def lamb(betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0,
         min_trust: float = 0.01, max_trust: float = 10.0,
         norm: Optional[Callable] = None) -> Optimizer:
    """LAMB with a per-param trust ratio ``||p|| / ||u||`` clipped to
    [min_trust, max_trust] (1 where either norm is 0). The norms are of
    whole leaves: ``norm(name, t)`` gives one from this rank's part of a
    leaf cut over ranks (the engine all-reduces its sum of squares)."""
    b1, b2 = betas
    if norm is None:
        def norm(name, t):
            return t.norm()

    def init(params):
        return OptState(_zeros(params), _zeros(params), 0)

    def update(params, state, grads, lr):
        count = state.count + 1
        for k, p in params.items():
            m, v, g = state.mu[k], state.nu[k], grads[k].float()
            bc1, bc2 = _bias_corrections(b1, b2, count, p)
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g.square())
            u = (m / bc1) / ((v / bc2).sqrt() + eps) + weight_decay * p
            w_norm, u_norm = norm(k, p), norm(k, u)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                (w_norm / u_norm).clamp(min_trust, max_trust),
                                1.0)
            p.sub_(lr * trust * u)
        state.count = count
        return params, state

    return Optimizer("lamb", init, update)


# ------------------------------------------------------------------ Adagrad
def adagrad(eps: float = 1e-10, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(_zeros(params), _empty(params), 0)

    def update(params, state, grads, lr):
        for k, p in params.items():
            acc, g = state.mu[k], grads[k].float()
            if weight_decay:
                g = g + weight_decay * p
            acc.add_(g.square())
            p.sub_(lr * g / (acc.sqrt() + eps))
        state.count += 1
        return params, state

    return Optimizer("adagrad", init, update)


# ---------------------------------------------------------------------- SGD
def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(_zeros(params) if momentum else _empty(params),
                        _empty(params), 0)

    def update(params, state, grads, lr):
        for k, p in params.items():
            g = grads[k].float()
            if weight_decay:
                g = g + weight_decay * p
            if momentum:
                m = state.mu[k]
                m.copy_(momentum * m + g)
                g = g + momentum * m if nesterov else m
            p.sub_(lr * g)
        state.count += 1
        return params, state

    return Optimizer("sgd", init, update)


# ------------------------------------------------------------------ registry
ONEBIT_TYPES = ("onebit_adam", "onebit_lamb", "zero_one_adam", "onebitadam",
                "onebitlamb", "zerooneadam")


def build_optimizer(opt_type: str, params: dict,
                    norm: Optional[Callable] = None) -> Optimizer:
    """``optimizer.type`` → optimizer, as ``optimizers.py:212`` parses it;
    ``norm`` is LAMB's norm of a whole leaf from a rank's part (the
    elementwise optimizers update parts as they are)."""
    t = opt_type.lower().replace("_", "").replace("-", "")
    p = dict(params)
    p.pop("lr", None)         # lr flows through the scheduler
    betas = tuple(p.pop("betas", (0.9, 0.999)))
    wd = p.pop("weight_decay", 0.0)
    eps = p.pop("eps", 1e-8)
    if t in ("adam",):
        return adam(betas=betas, eps=eps, weight_decay=wd, adamw=False)
    if t in ("adamw", "fusedadam", "cpuadam"):
        return adam(betas=betas, eps=eps, weight_decay=wd, adamw=True)
    if t in ("lamb", "fusedlamb"):
        return lamb(betas=(betas[0], betas[1]), eps=eps, weight_decay=wd,
                    norm=norm)
    if t in ("lion", "fusedlion", "cpulion"):
        return lion(betas=(betas[0], betas[1]), weight_decay=wd)
    if t in ("adagrad", "cpuadagrad"):
        return adagrad(eps=1e-10, weight_decay=wd)
    if t == "sgd":
        return sgd(momentum=p.pop("momentum", 0.0), weight_decay=wd,
                   nesterov=p.pop("nesterov", False))
    raise ValueError(f"unknown optimizer type '{opt_type}'")
