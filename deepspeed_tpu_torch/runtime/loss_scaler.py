"""Dynamic loss scaling for fp16 (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``): scale the loss, check the
grads for non-finite values with one reduction, skip the step and back
off the scale on overflow (after ``hysteresis`` overflows), double it
after ``loss_scale_window`` good steps. bf16 and fp32 run at scale 1.

The state is host numbers: the skip decision needs the finite flag on
the host anyway, read once per step and only under fp16.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    scale: float
    good_steps: int
    hysteresis: int


def init_loss_scale(cfg) -> LossScaleState:
    if not cfg.enabled:
        return LossScaleState(1.0, 0, cfg.hysteresis)
    init = cfg.loss_scale if cfg.loss_scale > 0 \
        else float(2 ** cfg.initial_scale_power)
    return LossScaleState(float(init), 0, cfg.hysteresis)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every element of every grad is finite."""
    flags = [torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def update_loss_scale(state: LossScaleState, finite: bool,
                      cfg) -> LossScaleState:
    if not cfg.enabled or cfg.loss_scale > 0:    # static scale: never moves
        return state
    if finite:
        grown = state.good_steps + 1
        grow = grown >= cfg.loss_scale_window
        return LossScaleState(state.scale * 2.0 if grow else state.scale,
                              0 if grow else grown, cfg.hysteresis)
    # overflow: consume hysteresis; halve only once it is exhausted
    scale = (max(state.scale * 0.5, cfg.min_loss_scale)
             if state.hysteresis <= 1 else state.scale)
    return LossScaleState(scale, 0, max(state.hysteresis - 1, 0))
