"""deepspeed_tpu_torch decode attention vs the JAX package's.

The port's plain version (what its wrapper runs for CPU tensors, and what
the CUDA kernel is held against on the card) against the JAX Pallas kernel
in interpret mode and against the JAX dense ``_cache_attend``; and the
port's dense ``_cache_attend`` against the JAX one; the kernel's split
plan (shapes only, every position once, CUDA's grid limits) and a plain
emulation of its split-K and in-order merge against the JAX kernel.
Inputs from numpy seeds. Tolerances: 2e-5 in fp32 (both sides fp32 online or plain softmax,
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
from torch_one_thread import one_torch_thread  # noqa: F401

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


# ------------------------------------------------------- the split plan
def split_reference(q, ck, cv, length, nsplit, chunk, alibi_slopes=None):
    """The kernel's split-K in plain tensor ops: per split, an fp32 partial
    (m, l, unnormalised acc) over its positions [s * chunk, (s + 1) * chunk)
    below L; then the partials of the live splits (those that start below
    L) merged in split order, as the last block of a (row, KV head) does."""
    B, _, H, hd = q.shape
    KV = ck.shape[1]
    G = H // KV
    L = torch.as_tensor(length).reshape(-1).expand(B).long()
    qf = q[:, 0].double().reshape(B, KV, G, hd) / hd ** 0.5
    out = torch.zeros(B, KV, G, hd, dtype=torch.float64)
    for b in range(B):
        parts = []
        for s in range(nsplit):
            lo, hi = s * chunk, min((s + 1) * chunk, int(L[b]))
            if lo >= hi:
                continue
            sc = torch.einsum("kgd,ksd->kgs", qf[b], ck[b, :, lo:hi].double())
            if alibi_slopes is not None:
                pos = torch.arange(lo, hi, dtype=torch.float64)
                sc = sc + alibi_slopes.double().reshape(KV, G, 1) \
                    * (pos - (int(L[b]) - 1))
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgs,ksd->kgd", p,
                                       cv[b, :, lo:hi].double())))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        num = sum(a * torch.exp(m - mx) for m, _, a in parts)
        out[b] = num / den
    return out.reshape(B, 1, H, hd).float()


SM_COUNTS = (132, 114, 8)                 # H100 SXM, H100 PCIe, a small card


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("B,H,KV,S,hd", [
    (4, 32, 32, 640, 128),                 # Llama-2-7B decode, PERF.md row 1
    (4, 64, 8, 640, 128),                  # Llama-2-70B's GQA heads
    (16, 32, 32, 4096, 128),               # the serving shape
    (1, 32, 32, 32768, 128),               # one long row: many splits
    (64, 32, 32, 4096, 128), (2, 12, 4, 384, 256), (3, 8, 1, 100, 40),
    (1, 1, 1, 1, 8), (4, 25, 25, 1024, 64), (1, 8, 8, 1 << 20, 128)])
def test_split_plan_covers_the_cache_once_within_cuda_limits(sms, B, H, KV,
                                                             S, hd):
    plan = da.split_plan(B, H, KV, S, hd, sms)
    chunk, nsplit, tile = plan["chunk"], plan["nsplit"], plan["tile"]
    # the ranges [s * chunk, (s + 1) * chunk) cover [0, S) once, none empty
    assert chunk % tile == 0 and chunk > 0
    assert (nsplit - 1) * chunk < S <= nsplit * chunk
    assert nsplit <= da.MAX_SPLITS
    assert tile == 8 * 16 // da.lane_elements(hd)
    G = H // KV
    assert plan["gb"] in (1, 2, 4, 8) and plan["gb"] * da.lane_elements(hd) \
        <= 32
    assert plan["nch"] * plan["gb"] >= G > (plan["nch"] - 1) * plan["gb"]
    # CUDA's grid: x < 2^31, y and z <= 65535
    assert nsplit < 2 ** 31 and KV * plan["nch"] <= 65535 and B <= 65535
    # about a block an SM where the cache allows it; long ranges split
    pairs = B * KV * plan["nch"]
    tiles = -(-S // tile)
    assert nsplit * pairs >= min(da.BLOCKS_PER_SM * sms, pairs * tiles) // 2
    assert chunk // tile <= max(da.MAX_TILES_PER_SPLIT,
                                -(-tiles // da.MAX_SPLITS))


def test_split_plan_reads_shapes_only(monkeypatch):
    """The plan is a function of Python ints: it never reads a tensor, so
    it never syncs with the card (the lengths stay there)."""
    def refuse(*a, **k):
        raise AssertionError("the split plan read a tensor")

    for name in ("item", "tolist", "__int__", "__index__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    plan = da.split_plan(4, 32, 32, 640, 128, 132)
    assert all(isinstance(v, int) for v in plan.values())
    with pytest.raises(ValueError, match="65535"):
        da.split_plan(70000, 32, 32, 640, 128, 132)


@pytest.mark.parametrize("kv,alibi", [(4, False), (2, True), (1, False)])
def test_split_k_and_in_order_merge_match_jax_kernel(kv, alibi):
    """Split-K as the kernel runs it, on the plan's chunk: lengths on a
    chunk edge and one past it, a row of one position, an empty row (0
    exactly), splits past L that hold nothing; GQA / MQA and ALiBi."""
    B, H, S, hd = 6, 4, 512, 32
    plan = da.split_plan(B, H, kv, S, hd, 132)
    c, nsplit = plan["chunk"], plan["nsplit"]
    assert nsplit > 2
    lengths = np.array([c, c + 1, 2 * c, 1, 0, S], np.int32)
    (jq, jk, jv), (tq, tk, tv) = both(make(B=B, S=S, H=H, KV=kv, hd=hd))
    slopes = alibi_slopes(H) if alibi else None
    got = split_reference(tq, tk, tv, torch.from_numpy(lengths), nsplit, c,
                          alibi_slopes=slopes)
    want = jax_kernel(jq, jk, jv, jnp.asarray(lengths), interpret=True,
                      alibi_slopes=jax_slopes(H) if alibi else None)
    np.testing.assert_allclose(f32(got), f32(want), atol=FP32_TOL, rtol=0)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    plain = da.decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths),
                                      alibi_slopes=slopes)
    np.testing.assert_allclose(f32(got), f32(plain), atol=FP32_TOL, rtol=0)


def test_split_plan_depends_on_the_batch_at_the_serving_shape():
    """Why a served request's tokens may part from its solo generate() on
    the card: at Llama-2-7B's heads and a 1024-position cache, the slot
    step's batch of 8 streams each row in one range while a batch of 1
    splits it in four, so the two sum a row's softmax in another order (a
    last-bit difference, which a near tie of two logits can turn)."""
    from deepspeed_tpu_torch.ops.decode_attention import split_plan

    b8 = split_plan(8, 32, 32, 1024, 128, 132)
    b1 = split_plan(1, 32, 32, 1024, 128, 132)
    assert (b8["nsplit"], b8["chunk"]) == (1, 1024)
    assert (b1["nsplit"], b1["chunk"]) == (4, 256)
