"""deepspeed_tpu_torch optimizers, LR schedules and loss scaler vs the JAX
package's.

Optimizers: three updates of the same fp32 params / grads (numpy, seeded)
through ``build_optimizer`` of both packages, params and moments compared
within 1e-6 relative to their max |value| (fp32 on both sides; XLA may
fuse a multiply-add where PyTorch rounds twice). Schedules: lr at steps
0..N within 1e-6 relative (both compute in fp32). Loss scaler: the state
after each flag of a fixed finite/overflow sequence, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import FP16Config as JaxFP16
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu_torch.config import FP16Config
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import optimizers as topt
from torch_one_thread import one_torch_thread  # noqa: F401

OPTIMIZERS = {
    "adamw": ("adamw", {"lr": 1e-3, "weight_decay": 0.01}),
    "adam_l2": ("adam", {"weight_decay": 0.01, "betas": [0.8, 0.99]}),
    "lion": ("lion", {"weight_decay": 0.1, "betas": [0.9, 0.99]}),
    "lamb": ("lamb", {"weight_decay": 0.01, "eps": 1e-6}),
    "adagrad": ("adagrad", {"weight_decay": 0.001}),
    "sgd_nesterov": ("sgd", {"momentum": 0.9, "nesterov": True,
                             "weight_decay": 0.01}),
    "sgd_plain": ("sgd", {}),
}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "zero": np.zeros((4,), np.float32)}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    kind, hp = OPTIMIZERS[name]
    params = _tree(0)
    jo, to = jopt.build_optimizer(kind, hp), topt.build_optimizer(kind, hp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step, lr in enumerate((1e-3, 5e-3, 2e-3)):
        g = _tree(10 + step)
        g["zero"] = np.zeros((4,), np.float32)     # a leaf with no grad
        jp, js = jo.update(jp, js, {k: jnp.asarray(v) for k, v in g.items()},
                           jnp.float32(lr))
        tp, ts = to.update(tp, ts, {k: torch.from_numpy(v) for k, v in
                                    g.items()}, float(np.float32(lr)))
    assert ts.count == int(js.count) == 3
    for k in params:
        for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                          (ts.nu[k], js.nu[k])):
            want = np.asarray(want)
            assert got.shape == want.shape
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-6 * max(np.abs(want).max(initial=0.0), 1e-3))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("adafactor", {})


SCHEDULES = {
    "constant": (None, {}),
    "warmup_log": ("WarmupLR", {"warmup_num_steps": 7, "warmup_min_lr": 1e-5}),
    "warmup_linear": ("WarmupLR", {"warmup_num_steps": 5,
                                   "warmup_type": "linear"}),
    "warmup_decay": ("WarmupDecayLR", {"warmup_num_steps": 4,
                                       "total_num_steps": 20}),
    "warmup_cosine": ("WarmupCosineLR", {"warmup_num_steps": 4,
                                         "total_num_steps": 20,
                                         "warmup_min_ratio": 0.1}),
    "one_cycle": ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                               "cycle_first_step_size": 5,
                               "cycle_second_step_size": 6,
                               "decay_step_size": 3, "decay_lr_rate": 0.1}),
    "lr_range_test": ("LRRangeTest", {"lr_range_test_step_size": 3,
                                      "lr_range_test_staircase": True}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    kind, params = SCHEDULES[name]
    js = jlr.build_schedule(kind, params, 3e-3)
    ts = tlr.build_schedule(kind, params, 3e-3)
    for step in range(26):
        want = float(js(jnp.int32(step)))
        assert ts(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("fp16", [
    dict(enabled=True, initial_scale_power=4, loss_scale_window=3,
         hysteresis=2, min_loss_scale=2.0),
    dict(enabled=True, loss_scale=128.0),
    dict(enabled=False)])
def test_loss_scale_sequence_matches_jax(fp16):
    flags = [True, True, False, False, True, True, True, False, False,
             False, False, True, True, True, True]
    jc, tc = JaxFP16(**fp16), FP16Config(**fp16)
    js, ts = jls.init_loss_scale(jc), tls.init_loss_scale(tc)
    for i, f in enumerate(flags):
        js = jls.update_loss_scale(js, jnp.bool_(f), jc)
        ts = tls.update_loss_scale(ts, f, tc)
        assert (ts.scale, ts.good_steps, ts.hysteresis) == (
            float(js.scale), int(js.good_steps), int(js.hysteresis)), i


def test_grads_finite_matches_jax():
    good = {"a": np.ones(3, np.float32), "b": np.zeros((2, 2), np.float32)}
    bad = dict(good, b=np.array([[0, np.inf], [1, 2]], np.float32))
    for tree in (good, bad):
        want = bool(jls.grads_finite(jax.tree.map(jnp.asarray, tree)))
        got = bool(tls.grads_finite(torch.from_numpy(v) for v in
                                    tree.values()))
        assert got == want
