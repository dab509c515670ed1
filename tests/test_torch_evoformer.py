"""deepspeed_tpu_torch evoformer attention vs the JAX package's.

The four tests of ``tests/unit/test_evoformer.py``, each run on the port
and held against the JAX function (its flash kernels in interpret mode) on
the same numpy inputs, and the gated, pair-biased block of
``examples/evoformer_science.py`` at its smoke size trained six SGD steps
on both sides from the example's seeded weights. Everything is fp32; the
port takes its plain versions on the CPU.

Tolerances, as rtol = atol: outputs 3e-5 and grads 1e-4 (the bias cases
of ``tests/unit/test_flash_attention.py``); the pinned and gated outputs
at the JAX test's own tolerances; the block's losses within 1e-5
relative at every step (both sides fp32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer as jevo
from deepspeed_tpu_torch.models.transformer import causal_attention
from deepspeed_tpu_torch.ops import evoformer as tevo
from deepspeed_tpu_torch.ops import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401


def _qkv(B=2, S=16, H=4, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


def _both(q, k, v, **kw):
    """The JAX and the port's evoformer_attention on the same inputs."""
    j = jevo.evoformer_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    t = tevo.evoformer_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        **{n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    return np.asarray(j), t.numpy()


def test_bias_shifts_attention():
    q, k, v = _qkv()
    base_j, base = _both(q, k, v, bias=np.zeros((2, 4, 16, 16), np.float32))
    # a huge bias toward key 0 makes every query attend key 0
    bias = np.zeros((2, 4, 16, 16), np.float32)
    bias[..., 0] = 1e4
    pinned_j, pinned = _both(q, k, v, bias=bias)
    want = np.broadcast_to(v[:, 0][:, None], pinned.shape)
    np.testing.assert_allclose(pinned, want, rtol=1e-4, atol=1e-4)
    assert not np.allclose(base, pinned)
    np.testing.assert_allclose(base, base_j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(pinned, pinned_j, rtol=3e-5, atol=3e-5)


def test_gating():
    q, k, v = _qkv()
    bias = np.zeros((2, 4, 16, 16), np.float32)
    _, ungated = _both(q, k, v, bias=bias)
    big_j, big = _both(q, k, v, bias=bias,
                       gate=np.full(q.shape, 50.0, np.float32))   # sigmoid 1
    np.testing.assert_allclose(big, ungated, rtol=1e-5)
    neg_j, neg = _both(q, k, v, bias=bias,
                       gate=np.full(q.shape, -50.0, np.float32))  # sigmoid 0
    np.testing.assert_allclose(neg, 0.0, atol=1e-6)
    np.testing.assert_allclose(big, big_j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(neg, neg_j, rtol=3e-5, atol=3e-5)


def test_no_bias_routes_to_flash():
    q, k, v = _qkv()
    got_j, got = _both(q, k, v, causal=True)
    want = causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, got_j, rtol=3e-5, atol=3e-5)


def test_grads_flow_through_bias():
    q, k, v = _qkv(S=8)
    bias = np.zeros((2, 4, 8, 8), np.float32)
    want = jax.grad(lambda b: jnp.sum(jevo.evoformer_attention(
        *(jnp.asarray(a) for a in (q, k, v)), bias=b) ** 2))(
        jnp.asarray(bias))
    tb = torch.from_numpy(bias).requires_grad_()
    (tevo.evoformer_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              bias=tb) ** 2).sum().backward()
    assert np.abs(tb.grad.numpy()).sum() > 0
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_dense_biased_attention_is_the_flash_function():
    """The dense reference of the port, the JAX one and the flash path
    agree on a broadcast bias under a key mask."""
    q, k, v = _qkv(S=32)
    bias = np.random.default_rng(4).standard_normal((1, 4, 32, 32)) \
        .astype(np.float32)
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0
    tq, tk, tv, tb, tm = (torch.from_numpy(a) for a in (q, k, v, bias, mask))
    dense = tevo.dense_biased_attention(tq, tk, tv, tb, mask=tm)
    want = jevo.dense_biased_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), mask=jnp.asarray(mask))
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    flash = tevo.evoformer_attention(tq, tk, tv, bias=tb, mask=tm)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=3e-5,
                               atol=3e-5)


# --------------------------------------- examples/evoformer_science.py
def example_inputs(B, S, H, hd, d_pair=8):
    """The example's data and weights, drawn from default_rng(0) in its
    order: x, pair, target, then wq, wk, wv, w_gate, w_bias."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    pair = rng.standard_normal((B, S, S, d_pair)).astype(np.float32)
    target = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    params = {n: (rng.standard_normal(shape) * 0.05).astype(np.float32)
              for n, shape in (("wq", (H * hd, H * hd)),
                               ("wk", (H * hd, H * hd)),
                               ("wv", (H * hd, H * hd)),
                               ("w_gate", (H * hd, H * hd)),
                               ("w_bias", (d_pair, H)))}
    params["pair"] = pair
    return x, target, params


def torch_block(p, x, B, S, H, hd, attention=tevo.evoformer_attention):
    """The example's block: q, k, v and the gate projected from x, the full
    (B, H, S, S) bias projected from the pair representation."""
    q, k, v, gate = ((x @ p[n]).reshape(B, S, H, hd)
                     for n in ("wq", "wk", "wv", "w_gate"))
    bias = torch.einsum("bstd,dh->bhst", p["pair"], p["w_bias"])
    return attention(q, k, v, bias=bias, gate=gate).reshape(B, S, H * hd)


def test_example_block_trains_like_jax():
    B, S, H, hd = 2, 32, 4, 16             # the example's smoke size
    x, target, params = example_inputs(B, S, H, hd)
    lr, steps = 0.05, 6

    def jax_loss(p):
        q, k, v, gate = ((jnp.asarray(x) @ p[n]).reshape(B, S, H, hd)
                         for n in ("wq", "wk", "wv", "w_gate"))
        bias = jnp.einsum("bstd,dh->bhst", p["pair"], p["w_bias"])
        out = jevo.evoformer_attention(q, k, v, bias=bias, gate=gate)
        return jnp.mean((out.reshape(B, S, H * hd) - jnp.asarray(target))
                        ** 2)

    grad_fn = jax.jit(jax.value_and_grad(jax_loss))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()).requires_grad_()
          for n, a in params.items()}
    tx, tt = torch.from_numpy(x), torch.from_numpy(target)
    want, got = [], []
    for _ in range(steps):
        val, g = grad_fn(jp)
        jp = jax.tree.map(lambda w, gw: w - lr * gw, jp, g)
        want.append(float(val))
        loss = ((torch_block(tp, tx, B, S, H, hd) - tt) ** 2).mean()
        grads = torch.autograd.grad(loss, list(tp.values()))
        assert float(grads[-1].norm()) > 0        # d pair
        with torch.no_grad():
            for w, gw in zip(tp.values(), grads):
                w -= lr * gw
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


@pytest.mark.parametrize("causal", [False, True])
def test_mask_and_gate_compose_with_flash(causal):
    """evoformer_attention is flash_attention(bias_is_constant=False) times
    sigmoid(gate), the key mask passed to the kernels as it is."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=24))
    g = torch.Generator().manual_seed(3)
    bias = torch.randn(4, 24, 24, generator=g)
    gate = torch.randn(q.shape, generator=g)
    mask = torch.ones(2, 24)
    mask[0, 17:] = 0
    got = tevo.evoformer_attention(q, k, v, bias=bias, gate=gate, mask=mask,
                                   causal=causal)
    want = tfa.flash_attention(q, k, v, bias=bias, mask=mask, causal=causal) \
        * torch.sigmoid(gate)
    assert torch.equal(got, want)
