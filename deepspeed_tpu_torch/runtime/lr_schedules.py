"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

``step -> lr`` functions evaluated on the host in fp32 (numpy float32, the
dtype the JAX schedules compute in inside the compiled step), so reading
the lr costs the card no synchronisation. The engine evaluates them at the
step before its increment, as ``_train_step_impl`` does.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
f32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(f32(lr))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log") -> Schedule:
    """Warm up from min to max (log or linear), then hold at max."""
    wmin, wmax = float(warmup_min_lr), float(warmup_max_lr)
    wsteps = max(1, warmup_num_steps)

    def sched(step):
        s = min(f32(step), f32(wsteps))
        if warmup_type == "log":
            frac = np.log1p(s) / f32(math.log1p(wsteps))
        else:
            frac = s / f32(wsteps)
        return float(f32(wmin) + f32(wmax - wmin) * frac)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """Warm up, then decay linearly to 0 at ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    total, wsteps = max(1, total_num_steps), max(1, warmup_num_steps)

    def sched(step):
        s = f32(step)
        if s < wsteps:
            return warm(step)
        decay = np.clip((f32(total) - s) / f32(max(1, total - wsteps)),
                        f32(0.0), f32(1.0))
        return float(f32(warmup_max_lr) * decay)

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3) -> Schedule:
    total, wsteps = max(1, total_num_steps), max(1, warmup_num_steps)

    def sched(step):
        s = f32(step)
        if s < wsteps:
            frac = f32(warmup_min_ratio) + f32(1 - warmup_min_ratio) \
                * min(s / f32(wsteps), f32(1.0))
        else:
            prog = np.clip((s - f32(wsteps)) / f32(max(1, total - wsteps)),
                           f32(0.0), f32(1.0))
            frac = f32(cos_min_ratio) + f32(1 - cos_min_ratio) * f32(0.5) \
                * (f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(warmup_max_lr) * frac)

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int | None = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0) -> Schedule:
    """Triangular up / down between min and max, then optional decay."""
    up = max(1, cycle_first_step_size)
    down = max(1, cycle_second_step_size or cycle_first_step_size)
    lo, hi = f32(cycle_min_lr), f32(cycle_max_lr)

    def sched(step):
        s = f32(step)
        if s < up:
            frac = np.clip(s / f32(up), f32(0), f32(1))
            return float(lo + f32(cycle_max_lr - cycle_min_lr) * frac)
        if s < up + down:
            frac = np.clip((s - f32(up)) / f32(down), f32(0), f32(1))
            return float(hi - f32(cycle_max_lr - cycle_min_lr) * frac)
        post = s - f32(up + down)
        decay = f32(1.0)
        if decay_step_size > 0:
            decay = max(f32(0.0), f32(1.0) - f32(decay_lr_rate)
                        * (post / f32(decay_step_size)))
        return float(lo * decay)

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    size = max(1, lr_range_test_step_size)

    def sched(step):
        s = f32(step)
        interval = np.floor(s / f32(size)) if lr_range_test_staircase \
            else s / f32(size)
        return float(f32(lr_range_test_min_lr)
                     * (f32(1.0) + interval * f32(lr_range_test_step_rate)))

    return sched


SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": lambda lr=1e-3, **_: constant(lr),
}


def build_schedule(sched_type: str | None, params: dict,
                   fallback_lr: float) -> Schedule:
    """``scheduler`` → schedule; no scheduler → the optimizer's constant lr."""
    if sched_type is None:
        return constant(fallback_lr)
    key = sched_type.lower().replace("_", "")
    if key not in SCHEDULES:
        raise ValueError(f"unknown scheduler '{sched_type}' (have "
                         f"{sorted(SCHEDULES)})")
    p = dict(params)
    if key in ("warmuplr", "warmupdecaylr", "warmupcosinelr") \
            and "warmup_max_lr" not in p:
        p["warmup_max_lr"] = fallback_lr
    return SCHEDULES[key](**p)
