"""deepspeed_tpu_torch flash attention vs the JAX package's.

The same numpy inputs (seeded) go through the JAX ``flash_attention`` with
its Pallas kernels in interpret mode and through the port's, which takes
its plain PyTorch versions on the CPU; the outputs and dq/dk/dv (from
``jax.grad`` and ``torch.autograd`` of ``sum(o * w)`` for one fixed
cotangent ``w``) are compared.

Tolerances, as max |port - JAX| over max |JAX| of each tensor:
- fp32: 2e-5. Both sides compute in fp32; the port's plain version takes
  one softmax over all keys where the kernels stream 16-key blocks, so
  sums run in another order.
- bf16: 2e-2. The operands and outputs are bf16 on both sides and p is
  rounded to bf16 before p·v against a running max (JAX) or the row max
  (the port): a few bf16 ulps (2^-8 each) at the top of each tensor.
- S not a multiple of any block JAX accepts (S = 40, block 16): JAX runs
  its dense ``causal_attention`` there, whose rounding points differ (the
  scores einsum in the storage dtype, ``finfo.min`` masking), so that case
  has its own tolerance: 2e-5 in fp32, 4e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_slopes
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DENSE_TOL = {"float32": 2e-5, "bfloat16": 4e-2}

# name: (B, S, H, KV, hd, causal, mask, alibi, block)
CASES = {
    "causal": (2, 32, 4, 4, 16, True, None, False, 16),
    "full": (2, 32, 4, 4, 16, False, None, False, 16),
    "gqa": (2, 32, 4, 2, 16, True, None, False, 16),
    "mask_full_rows": (2, 32, 4, 4, 16, True, "left_pad", False, 16),
    "mask_full_noncausal": (2, 32, 4, 2, 16, False, "dead_row", False, 16),
    "alibi": (2, 32, 4, 4, 16, True, None, True, 16),
    "alibi_mask_gqa": (2, 32, 4, 2, 16, True, "left_pad", True, 16),
    "odd_S_dense_in_jax": (2, 40, 4, 2, 16, True, None, False, 16),
}


def make_inputs(case, dtype, seed=0):
    B, S, H, KV, hd, causal, mask_kind, alibi, block = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    mask = None
    if mask_kind == "left_pad":          # rows 0-2 of batch 1 see no key
        mask = np.ones((B, S), np.int32)
        mask[1, :3] = 0
    elif mask_kind == "dead_row":        # batch 1 has no live key at all
        mask = np.ones((B, S), np.int32)
        mask[1, :] = 0
        mask[0, S - 5:] = 0
    slopes = np.array(jax_slopes(H)) if alibi else None
    if dtype == "bfloat16":              # both sides see the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return dict(q=q, k=k, v=v, w=w, mask=mask, slopes=slopes, causal=causal,
                block=block)


def jax_side(x, dtype):
    dt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(x[n], dt) for n in ("q", "k", "v"))
    mask = None if x["mask"] is None else jnp.asarray(x["mask"])
    slopes = None if x["slopes"] is None else jnp.asarray(x["slopes"])

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, mask=mask, alibi_slopes=slopes,
                                   causal=x["causal"], block=x["block"],
                                   interpret=True)

    def loss(q, k, v):
        return jnp.sum(f(q, k, v).astype(jnp.float32) * x["w"])

    o = f(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(a.astype(jnp.float32)) for a in (o, *grads)]


def to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def torch_side(x, dtype):
    q, k, v = (to_torch(x[n], dtype).requires_grad_() for n in ("q", "k", "v"))
    mask = None if x["mask"] is None else torch.from_numpy(x["mask"])
    slopes = None if x["slopes"] is None else torch.from_numpy(x["slopes"])
    o = tfa.flash_attention(q, k, v, mask=mask, alibi_slopes=slopes,
                            causal=x["causal"], block=x["block"])
    (o.float() * torch.from_numpy(x["w"])).sum().backward()
    return [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_output_and_grads_match_jax(case, dtype):
    x = make_inputs(case, dtype)
    want = jax_side(x, dtype)
    got = torch_side(x, dtype)
    tol = (DENSE_TOL if case.startswith("odd_S") else TOL)[dtype]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        share = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert share <= tol, (name, share)


def test_fully_masked_rows_give_zeros_not_nan():
    x = make_inputs("mask_full_noncausal", "float32")
    o, dq, dk, dv = torch_side(x, "float32")
    assert np.all(o[1] == 0) and np.all(dq[1] == 0)
    assert np.all(dk[1] == 0) and np.all(dv[1] == 0)
    assert np.all(dk[0, -5:] == 0) and np.all(dv[0, -5:] == 0)


def test_plain_pieces_agree_with_the_autograd_function():
    """flash_fwd / flash_bwd_dq / flash_bwd_dkv on CPU tensors are the
    plain versions, and the Function's grads are theirs."""
    x = make_inputs("alibi_mask_gqa", "float32")
    q, k, v = (to_torch(x[n], "float32") for n in ("q", "k", "v"))
    mask, slopes = torch.from_numpy(x["mask"]), torch.from_numpy(x["slopes"])
    do = torch.from_numpy(x["w"])
    o, lse = tfa.flash_fwd(q, k, v, mask=mask, alibi_slopes=slopes)
    assert lse.shape == (2, 4, 32) and lse.dtype == torch.float32
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, mask=mask,
                                               alibi_slopes=slopes)
    got = torch_side(x, "float32")
    for a, b in zip((o, dq, dk, dv), got):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


def test_bias_raises_and_factory_flags():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match=r"item 8 \(off the main"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(8, 8))
    fn = tfa.make_flash_attention()
    assert fn.bias_is_constant and fn.accepts_alibi_slopes
    assert not fn.accepts_bias          # until the bias operand is ported
    with pytest.raises(NotImplementedError, match="bias operand"):
        fn(q, q, q, bias=torch.zeros(8, 8))


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor off the CPU launches a kernel or raises: here (no card) a
    meta tensor is refused, and no launch is counted."""
    q = torch.zeros(1, 8, 2, 16, device="meta", dtype=torch.bfloat16)
    before = tfa.flash_fwd.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_bwd_dq(q, q, q, q, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_bwd_dkv(q, q, q, q, None, None)
    assert tfa.flash_fwd.launches == before
