"""deepspeed_tpu_torch decode attention vs the JAX package's.

The port's plain version (what its wrapper runs for CPU tensors, and what
the CUDA kernel is held against on the card) against the JAX Pallas kernel
in interpret mode and against the JAX dense ``_cache_attend``; and the
port's dense ``_cache_attend`` against the JAX one. Inputs from numpy
seeds. Tolerances: 2e-5 in fp32 (both sides fp32 online or plain softmax,
sums in another order); in bf16 2e-2, one bf16 rounding step of the
outputs (|o| < 2) plus the score rounding of the dense path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.decode import _cache_attend as jax_cache_attend
from deepspeed_tpu.models.transformer import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.decode_attention import decode_attention as jax_kernel
from deepspeed_tpu_torch.inference.decode import _cache_attend
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import decode_attention as da

FP32_TOL = 2e-5
BF16_TOL = 2e-2


def make(B=2, S=128, H=4, KV=2, hd=32, T=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32))


def both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("kv", [4, 2, 1])              # MHA, GQA, MQA
@pytest.mark.parametrize("length", [1, 64, 77, 128])
def test_plain_matches_jax_kernel_and_dense(kv, length):
    (jq, jk, jv), (tq, tk, tv) = both(make(KV=kv))
    got = da.decode_attention_plain(tq, tk, tv, length)
    kernel = jax_kernel(jq, jk, jv, jnp.int32(length), interpret=True)
    dense = jax_cache_attend(jq, jk, jv, jnp.int32(length))
    np.testing.assert_allclose(f32(got), f32(kernel), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(f32(got), f32(dense), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("alibi", [False, True])
def test_per_row_lengths_and_alibi_match_jax_kernel(alibi):
    (jq, jk, jv), (tq, tk, tv) = both(make(B=4, H=8, KV=2))
    lengths = np.array([1, 30, 128, 77], np.int32)
    got = da.decode_attention_plain(
        tq, tk, tv, torch.from_numpy(lengths),
        alibi_slopes=alibi_slopes(8) if alibi else None)
    want = jax_kernel(jq, jk, jv, jnp.asarray(lengths), interpret=True,
                      alibi_slopes=jax_slopes(8) if alibi else None)
    np.testing.assert_allclose(f32(got), f32(want), atol=FP32_TOL, rtol=0)


def test_bf16_matches_jax_kernel():
    (jq, jk, jv), (tq, tk, tv) = both(make(KV=2), jnp.bfloat16,
                                      torch.bfloat16)
    got = da.decode_attention_plain(tq, tk, tv, 100)
    want = jax_kernel(jq, jk, jv, jnp.int32(100), interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=BF16_TOL, rtol=0)


def test_zero_length_row_is_exactly_zero():
    _, (tq, tk, tv) = both(make(B=2))
    got = da.decode_attention_plain(tq, tk, tv, torch.tensor([0, 5]))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert got[1].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,lengths,alibi", [
    (1, 77, False), (1, [5, 128], True), (16, 40, False), (16, 40, True),
    (4, [20, 100], False)])
def test_dense_cache_attend_matches_jax(dtype, T, lengths, alibi):
    """Prefill (T > 1) and decode (T = 1), scalar and per-row lengths: the
    dense path with its bf16 rounding points."""
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    (jq, jk, jv), (tq, tk, tv) = both(make(T=T, H=4, KV=2),
                                      getattr(jnp, dtype),
                                      getattr(torch, dtype))
    jl, tl = jnp.asarray(lengths, jnp.int32), torch.tensor(lengths)
    want = jax_cache_attend(jq, jk, jv, jl,
                            alibi=jax_slopes(4) if alibi else None)
    got = _cache_attend(tq, tk, tv, tl, alibi=alibi_slopes(4) if alibi else None)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_only(monkeypatch):
    """A CPU tensor goes to the plain version and launches nothing; a
    tensor on another device raises instead of falling back."""
    calls = []
    plain = da.decode_attention_plain
    monkeypatch.setattr(da, "decode_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = da.decode_attention.launches
    _, (tq, tk, tv) = both(make())
    torch.testing.assert_close(da.decode_attention(tq, tk, tv, 50),
                               plain(tq, tk, tv, 50), atol=0, rtol=0)
    assert calls == [1] and da.decode_attention.launches == before
    with pytest.raises(ValueError, match="device"):
        da.decode_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"), 50)


def test_flash_gate_routes_one_token_steps_on_128_multiples(monkeypatch):
    """``_cache_attend`` calls the wrapper only for T == 1, no bias, and a
    cache length that is a multiple of 128 (decode.py:144)."""
    seen = []
    monkeypatch.setattr(da, "decode_attention",
                        lambda q, *a, **k: seen.append(q.shape) or
                        da.decode_attention_plain(q, *a, **k))
    for S, T, hit in ((128, 1, True), (96, 1, False), (128, 4, False)):
        _, (tq, tk, tv) = both(make(S=S, T=T))
        _cache_attend(tq, tk, tv, S, flash_decode=True)
        assert bool(seen) == hit, (S, T)
        seen.clear()
