"""deepspeed_tpu_torch on the card: the CUDA kernels against their plain
versions, and the generate path through them.

Marked ``gpu``; each test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). Run on a card:
``python -m pytest -m gpu tests/test_torch_gpu.py -q``."""

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import bert, bloom, llama2, tiny_test
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.gpu

# fp32: both sides fp32 online softmax, another summation order; bf16 and
# fp16: one rounding step of the outputs (|o| < 2)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("H,KV,hd", [(32, 32, 128), (32, 8, 128), (32, 1, 64),
                                     (12, 4, 256), (4, 4, 40)])
@pytest.mark.parametrize("alibi", [False, True])
def test_kernel_matches_plain(cuda, dtype, H, KV, hd, alibi):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S = 4, 384
    q, ck, cv = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for shape in ((B, 1, H, hd), (B, KV, S, hd), (B, KV, S, hd)))
    lengths = torch.tensor([1, S, 200, 0], dtype=torch.int32, device=cuda)
    slopes = alibi_slopes(H, cuda) if alibi else None
    before = da.decode_attention.launches
    got = da.decode_attention(q, ck, cv, lengths, alibi_slopes=slopes)
    want = da.decode_attention_plain(q, ck, cv, lengths, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KV,hd,S,edge", [
    (4, 32, 32, 128, 640, "splits"),      # Llama-2-7B: lengths on split edges
    (4, 64, 8, 128, 640, "splits"),       # Llama-2-70B's GQA heads
    (4, 32, 32, 128, 640, "empty"),       # every row empty
    (1, 32, 32, 128, 32768, "long"),      # one long row: many splits
    (16, 32, 32, 128, 4096, "ragged"),    # the serving shape
    (3, 8, 2, 40, 300, "splits"), (2, 8, 8, 256, 500, "splits")])
def test_kernel_split_edges_and_repeatability(cuda, dtype, B, H, KV, hd, S,
                                              edge):
    """Split-K at the plan's own edges: lengths on a split boundary and one
    past it, all rows empty (exactly 0), a long row over many splits,
    ragged rows; two calls on the same inputs are bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, ck, cv = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for shape in ((B, 1, H, hd), (B, KV, S, hd), (B, KV, S, hd)))
    c = da.split_plan(B, H, KV, S, hd, torch.cuda.get_device_properties(
        cuda).multi_processor_count)["chunk"]
    if edge == "splits":
        lens = [min(x, S) for x in (c, c + 1, 2 * c - 1, 1)][:B] \
            + [S] * max(0, B - 4)
    elif edge == "ragged":
        lens = torch.randint(512, S + 1, (B,), generator=g,
                             device=cuda).tolist()
    else:
        lens = [0 if edge == "empty" else S - 3] * B
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = da.decode_attention(q, ck, cv, lengths)
    again = da.decode_attention(q, ck, cv, lengths)
    want = da.decode_attention_plain(q, ck, cv, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


def test_kernel_scalar_length_and_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 1, 8, 64, generator=g, device=cuda)
    ck = torch.randn(2, 8, 256, 64, generator=g, device=cuda)
    torch.testing.assert_close(da.decode_attention(q, ck, ck, 100),
                               da.decode_attention_plain(q, ck, ck, 100),
                               atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="dtypes"):
        da.decode_attention(q, ck.half(), ck.half(), 100)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, ck.transpose(2, 3).contiguous().transpose(2, 3),
                            ck, 100)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 1, 264, device=cuda)
        da.decode_attention(big, torch.zeros(1, 1, 8, 264, device=cuda),
                            torch.zeros(1, 1, 8, 264, device=cuda), 1)


@pytest.mark.parametrize("cfg", [tiny_test(dtype=torch.float32),
                                 llama2("tiny", dtype=torch.float32),
                                 bloom("tiny", dtype=torch.float32)])
def test_generate_through_the_kernel(cuda, cfg):
    """fp32 greedy tokens through the kernel equal the dense path's, with
    one launch per layer per decode step."""
    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g, device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (3, 20), generator=g, device=cuda)
    dense = dt.init_inference(model, params, {"dtype": "float32",
                                              "flash_decode": False})
    flash = dt.init_inference(model, params, {"dtype": "float32"})
    assert flash.flash_decode and flash.device.type == "cuda"
    want = dense.generate(ids, 10, greedy=True)
    before = da.decode_attention.launches
    got = flash.generate(ids, 10, greedy=True)
    assert da.decode_attention.launches - before == cfg.n_layer * 9
    assert torch.equal(got, want)


# ------------------------------------------------------------- WOQ GEMMs
# max |kernel - plain| as a share of max |plain|, by output dtype: fp32
# sums in another order; bf16/fp16 one output rounding on each side
WOQ_SHARE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
             torch.float16: 2.0 ** -9}


def _woq_pair(cuda, kernel, M, rows, cols, group, bits, xdtype, seed=0):
    from deepspeed_tpu_torch.inference.quantization import quantize

    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(rows, cols, generator=g, device=cuda) * 0.05
    qt = quantize(w, group, bits)
    x = torch.randn(M, cols if kernel == "t" else rows, generator=g,
                    device=cuda).to(xdtype)
    return x, qt


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 4, 17])
@pytest.mark.parametrize("K,N,out", [
    (4096, 12288, None), (4096, 4096, None), (4096, 11008, None),
    (11008, 4096, None), (4096, 32000, torch.float32),   # Llama-2-7B decode
    (4096, 16384, None), (16384, 4096, None),            # OPT-6.7B MLP
    (1000, 512, None), (256, 1001, torch.float32)])      # G = 1, ragged N
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_woq_matmul_kernel_matches_plain(cuda, bits, M, K, N, out, xdtype):
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "mm", M, K, N, 128, bits, xdtype)
    kw = dict(group_size=qt.group_size, bits=qt.bits, out_dtype=out)
    before = wm.woq_matmul.launches
    got = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    assert wm.woq_matmul.launches == before + 1
    assert got.dtype == (out or xdtype) and got.shape == (M, N)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=WOQ_SHARE[got.dtype] * want.float().abs().max().item())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 4, 8, 17])
@pytest.mark.parametrize("V,K,group", [(50272, 4096, 128), (32000, 4096, 128),
                                       (1002, 256, 64), (2048, 130, 128)])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32,
                                    torch.float16])
def test_woq_matmul_t_kernel_matches_plain(cuda, bits, M, V, K, group, xdtype):
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "t", M, V, K, group, bits, xdtype)
    kw = dict(group_size=qt.group_size, bits=qt.bits, out_dtype=torch.float32)
    before = wm.woq_matmul_t.launches
    got = wm.woq_matmul_t(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_t_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    assert wm.woq_matmul_t.launches == before + 1
    torch.testing.assert_close(
        got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
def test_woq_matmul_t_mma_route_out_dtype_and_repeatability(cuda, xdtype,
                                                            bits):
    """The tensor-core route in x's dtype out (one rounding of the output
    on each side) and twice bit-identical (no atomics)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "t", 4, 50272, 4096, 128, bits, xdtype)
    assert wm.woq_t_route(xdtype, 4096, 50272, qt.group_size) == "mma"
    kw = dict(group_size=qt.group_size, bits=qt.bits)
    got = wm.woq_matmul_t(x, qt.q, qt.scale, **kw)
    again = wm.woq_matmul_t(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_t_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    assert got.dtype == xdtype and torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=WOQ_SHARE[xdtype] * want.float().abs().max().item())


def test_woq_kernels_refuse_what_they_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "mm", 4, 256, 128, 64, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wm.woq_matmul(x.t().contiguous().t(), qt.q, qt.scale, group_size=64)
    with pytest.raises(ValueError, match="group_size"):
        wm.woq_matmul(x, qt.q, qt.scale, group_size=48)
    with pytest.raises(ValueError, match="out_dtype"):
        wm.woq_matmul(x, qt.q, qt.scale, group_size=64,
                      out_dtype=torch.float16)
    with pytest.raises(ValueError, match="scale must be"):
        wm.woq_matmul_t(x[:, :128], qt.q, qt.scale, group_size=64, bits=4)


@pytest.mark.parametrize("cfg,bits", [
    (tiny_test(dtype=torch.float32), 8),
    (llama2("tiny", dtype=torch.float32), 4),
    (bloom("tiny", dtype=torch.float32, vocab_size=1000), 8)])
def test_woq_generate_through_the_kernels(cuda, cfg, bits):
    """fp32 greedy tokens through the WOQ kernels equal the per-use
    dequant path's, with one launch per quantized projection per decode
    step and one head launch (woq_matmul_t for a tied table)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g, device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (3, 20), generator=g, device=cuda)
    conf = {"dtype": "float32", "quantize": True, "quant_bits": bits,
            "quant_group_size": 32}
    per_use = dt.init_inference(model, params, {**conf, "woq_kernel": False})
    kernel = dt.init_inference(model, params, conf)
    assert kernel.model.woq_kernel and not per_use.model.woq_kernel
    want = per_use.generate(ids, 10, greedy=True)
    before = (wm.woq_matmul.launches, wm.woq_matmul_t.launches)
    got = kernel.generate(ids, 10, greedy=True)
    per_step = (5 if cfg.is_glu else 4) * cfg.n_layer \
        + (not cfg.tie_embeddings)
    assert wm.woq_matmul.launches - before[0] == per_step * 9
    assert wm.woq_matmul_t.launches - before[1] == 9 * cfg.tie_embeddings
    assert torch.equal(got, want)


# ------------------------------------------------------------- flash attention
# (B, H, KV, S, hd, causal, mask kind, alibi): chip_smoke.py phase 5's cases
FLASH_CASES = [
    (4, 25, 25, 1024, 64, True, None, False),      # GPT-2 1.5B
    (1, 32, 32, 4096, 128, True, None, False),     # Llama-2-7B
    (1, 64, 8, 2048, 128, True, None, False),      # Llama-2-70B heads (GQA)
    (1, 8, 8, 8192, 128, True, None, False),       # where the TPU streams
    (2, 4, 4, 256, 64, True, "left_pad", False),
    (2, 4, 2, 256, 64, False, "dead_row", False),
    (2, 8, 8, 512, 64, True, None, True),
    (2, 4, 4, 512, 128, False, None, False),
    (2, 4, 4, 1000, 64, True, None, False),
    (1, 4, 1, 77, 32, True, "left_pad", True),
    (2, 4, 4, 100, 16, False, None, False),
]
# max |kernel - plain| / max |plain| of o, dq, dk, dv: a few ulps of the
# storage dtype at the top of each tensor (chip_smoke.py FLASH_TOL_SHARE)
FLASH_SHARE = {torch.bfloat16: 2e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, case, dtype):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, alibi = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q, do = (torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    mask = None
    if mask_kind:
        mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
        if mask_kind == "left_pad":
            mask[-1, :3] = False
        else:
            mask[-1] = False
    kw = dict(mask=mask, alibi_slopes=alibi_slopes(H, cuda) if alibi else None,
              causal=causal)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.attention_delta(o_p, do)
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    o, lse = fa.flash_fwd(q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    want = (o_p, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                 fa.flash_bwd_dkv)] == [b + 1 for b in before]
    for got, ref in zip((o, dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        share = ((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30)).item()
        assert share <= FLASH_SHARE[dtype]
    live = lse_p > fa.BIG_NEG / 2
    assert (lse - lse_p).abs()[live].max().item() <= 2e-3


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    # fp32 runs through the kernels (it raised before they took fp32)
    q = torch.randn(1, 64, 2, 64, device=cuda)
    o, lse = fa.flash_fwd(q, q, q)
    assert _max_share(o, fa.flash_attention_fwd_plain(q, q, q)[0]) <= 1e-4
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        fa.flash_fwd(q.double(), q.double(), q.double())
    q = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16)
        fa.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


# ------------------------------------------------- the wgmma forward
# (B, H, KV, S, hd, causal, mask kind, alibi): the head dims the wgmma / TMA
# forward (csrc/flash_fwd_sm90.cu) serves, causal and full, S off its
# 128-row tiles (77, 100, 333, 1000), key masks with fully masked rows
# ("dead_row": a whole batch row; "left_pad": three queries of the last
# one see no key when causal), GQA 8:1 and 64:8, ALiBi
FWD_CASES = [
    (2, 4, 4, 77, 32, True, None, False),
    (2, 4, 2, 100, 64, False, None, False),
    (1, 4, 4, 333, 128, True, None, False),
    (2, 4, 4, 1000, 64, True, None, False),
    (2, 4, 4, 333, 128, False, "dead_row", False),
    (2, 8, 1, 256, 64, True, "left_pad", False),
    (1, 64, 8, 512, 128, True, None, False),
    (2, 8, 8, 333, 32, False, "left_pad", True),
    (2, 8, 8, 1000, 128, True, None, True),
    (1, 4, 1, 77, 32, True, "left_pad", True),
    (3, 4, 4, 100, 32, False, "dead_row", False),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wgmma_forward_matches_plain(cuda, case, dtype):
    """The wgmma forward against the plain one: o within phase 5's share,
    lse within 2e-3 on rows with a live key, o exactly 0 and lse finite on
    rows without; then the backward kernels, fed its o and lse, against the
    plain backward."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, alibi = case
    assert fa.library("flash_fwd", dtype, hd) == "flash_fwd_sm90"
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, dtype)
    mask = None
    if mask_kind:
        mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
        if mask_kind == "left_pad":
            mask[-1, :3] = False
        else:
            mask[-1] = False
    kw = dict(mask=mask, causal=causal,
              alibi_slopes=alibi_slopes(H, cuda) if alibi else None)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    assert bool(torch.isfinite(lse).all())
    assert _max_share(o, o_p) <= FLASH_SHARE[dtype]
    live = lse_p > fa.BIG_NEG / 2
    assert (lse - lse_p).abs()[live].max().item() <= 2e-3
    if not bool(live.all()):
        assert bool((o.transpose(1, 2)[~live] == 0).all())
    delta, delta_p = fa.attention_delta(o, do), fa.attention_delta(o_p, do)
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta_p, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _max_share(g, w) <= FLASH_SHARE[dtype]


def test_wgmma_forward_refuses_and_routes(cuda):
    """The forward's routes: 16-bit hd 32-128 to the wgmma library, hd 16
    and fp32 to the mma.sync ones; an odd head dim or a misaligned operand
    raises before any launch."""
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    assert hasattr(builder.load("flash_fwd_sm90"), "dstpu_flash_fwd")
    assert not hasattr(builder.load("flash_fwd_sm90"), "dstpu_flash_bwd_dq")
    for dtype, hd in ((torch.bfloat16, 16), (torch.float16, 16),
                      (torch.float32, 64), (torch.bfloat16, 128)):
        q = torch.randn(1, 70, 2, hd, device=cuda).to(dtype)
        o, _ = fa.flash_fwd(q, q, q)
        tol = 1e-4 if dtype == torch.float32 else FLASH_SHARE[dtype]
        assert _max_share(o, fa.flash_attention_fwd_plain(q, q, q)[0]) <= tol
    before = fa.flash_fwd.launches
    x = torch.zeros(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(x, x, x)
    buf = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 64, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd(odd, odd, odd)
    assert fa.flash_fwd.launches == before



# ------------------------------------------------- the wgmma backward
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wgmma_backward_matches_plain(cuda, case, dtype):
    """The wgmma dq and dk/dv kernels (csrc/flash_bwd_dq_sm90.cu,
    csrc/flash_bwd_dkv_sm90.cu) against the plain backward, fed the plain
    forward's lse and delta: each output within phase 5's share, dq exactly
    0 on rows without a live key and dk, dv exactly 0 on masked keys."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, alibi = case
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.library(kernel, dtype, hd) == f"{kernel}_sm90"
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, dtype)
    mask = None
    if mask_kind:
        mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
        if mask_kind == "left_pad":
            mask[-1, :3] = False
        else:
            mask[-1] = False
    kw = dict(mask=mask, causal=causal,
              alibi_slopes=alibi_slopes(H, cuda) if alibi else None)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.attention_delta(o_p, do)
    before = [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    assert [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches] == [
        before[0] + 1, before[1] + 1]
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert _max_share(got, ref) <= FLASH_SHARE[dtype]
    live = lse_p > fa.BIG_NEG / 2
    if not bool(live.all()):
        assert bool((dq.transpose(1, 2)[~live] == 0).all())
    if mask is not None:
        assert bool((dk[~mask] == 0).all()) and bool((dv[~mask] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["ss", "hss", "bhss", "b1ss", "1hss",
                                    "expanded"])
def test_wgmma_backward_bias_layouts(cuda, layout, dtype):
    """Every bias layout through the wgmma pair at hd 128 and 32, causal,
    S off the tiles: dbias within one rounding of its dtype and exactly 0
    above the diagonal."""
    for case, bias_dtype in (((2, 4, 2, 200, 128, True, None, layout), dtype),
                             ((2, 4, 4, 333, 32, True, "left_pad", layout),
                              torch.float32)):
        dbias = _flash_bias_check(cuda, case, dtype, bias_dtype)
        assert bool((dbias.triu(1) == 0).all())


def test_wgmma_backward_is_deterministic(cuda):
    """No atomics: two runs of the pair give the same bits, with and
    without dbias, GQA and causal."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _sparse_inputs(cuda, 2, 8, 2, 1000, 128, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    bias = torch.randn(2, 8, 1000, 1000, device=cuda, dtype=torch.bfloat16)
    runs = [(fa.flash_bwd_dq(q, k, v, do, lse, delta),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta),
             *fa.flash_bwd_dq(q, k, v, do, lse, delta, bias=bias,
                              grad_bias=True))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wgmma_backward_refuses_and_routes(cuda):
    """The backward's routes: 16-bit hd 32-128 to the two wgmma libraries,
    each exporting only its own kernel; hd 16 and fp32 to the mma.sync
    ones, whose 16-bit build refuses hd 32-128; an odd head dim or a
    misaligned operand raises before any launch."""
    import ctypes

    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    dq_lib, dkv_lib = (builder.load(n) for n in ("flash_bwd_dq_sm90",
                                                 "flash_bwd_dkv_sm90"))
    assert hasattr(dq_lib, "dstpu_flash_bwd_dq")
    assert not hasattr(dq_lib, "dstpu_flash_bwd_dkv")
    assert hasattr(dkv_lib, "dstpu_flash_bwd_dkv")
    assert not hasattr(dkv_lib, "dstpu_flash_bwd_dq")
    # the mma.sync bf16 / fp16 library no longer builds hd 32-128
    x = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    lib = fa._lib("flash_attention")
    P = ctypes.c_void_p
    err = lib.dstpu_flash_bwd_dq(
        *(P(t.data_ptr()) for t in (x, x, x, x, lse, lse)), None, None,
        None, P(x.data_ptr()), None, 1, 64, 2, 2, 64, 1, 2, 0, 0, 0, 0.125,
        P(torch.cuda.current_stream().cuda_stream))
    assert err != 0
    for dtype, hd in ((torch.bfloat16, 16), (torch.float16, 16),
                      (torch.float32, 64), (torch.bfloat16, 128),
                      (torch.float16, 32)):
        q = torch.randn(1, 70, 2, hd, device=cuda).to(dtype)
        o, lse = fa.flash_attention_fwd_plain(q, q, q)
        delta = fa.attention_delta(o, q)
        tol = 1e-4 if dtype == torch.float32 else FLASH_SHARE[dtype]
        got = (fa.flash_bwd_dq(q, q, q, q, lse, delta),
               *fa.flash_bwd_dkv(q, q, q, q, lse, delta))
        want = (fa.flash_bwd_dq_plain(q, q, q, q, lse, delta),
                *fa.flash_bwd_dkv_plain(q, q, q, q, lse, delta))
        for g, w in zip(got, want):
            assert _max_share(g, w) <= tol
    before = [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    x = torch.zeros(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_bwd_dq(x, x, x, x, lse, lse)
    buf = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 64, 2, 64)
    lse = torch.zeros(2, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_bwd_dkv(odd, odd, odd, odd, lse, lse)
    assert [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches] == before

# ------------------------------------------------------------- sparse attention
# (B, H, KV, S, hd, causal, config class, fields): chip_smoke.py phase 5c's
# cases at smaller sizes: the default Fixed layout, each layout, blocks 16,
# 32 and 128, hd 128 and 16, GQA / MQA, one block, and a layout whose
# narrow lists leave out block 0 (a kernel reading its lists past k_n /
# q_n would add block 0, their padding)
SPARSE_CASES = [
    (1, 25, 25, 2048, 64, True, "FixedSparsityConfig", {}),
    (2, 4, 4, 1024, 64, False, "FixedSparsityConfig", {}),
    (2, 4, 4, 1024, 64, True, "VariableSparsityConfig", {}),
    (2, 4, 4, 1024, 64, False, "BigBirdSparsityConfig", {}),
    (2, 4, 4, 1024, 64, True, "BSLongformerSparsityConfig", {}),
    (2, 4, 4, 512, 64, True, "FixedSparsityConfig", {"block": 16}),
    (2, 4, 4, 512, 64, False, "BigBirdSparsityConfig", {"block": 32}),
    (1, 4, 4, 1024, 64, True, "FixedSparsityConfig", {"block": 128}),
    (1, 8, 2, 1024, 128, True, "FixedSparsityConfig", {}),
    (1, 8, 1, 512, 128, False, "VariableSparsityConfig", {"block": 128}),
    (2, 4, 4, 256, 16, True, "VariableSparsityConfig", {"block": 32}),
    (2, 4, 4, 64, 32, True, "SparsityConfig", {}),
    (1, 4, 4, 1024, 64, True, "BSLongformerSparsityConfig",
     {"num_sliding_window_blocks": 1, "global_block_indices": (15,)}),
    (1, 4, 4, 1024, 64, False, "BSLongformerSparsityConfig",
     {"num_sliding_window_blocks": 1, "global_block_indices": (15,)}),
]


def _sparse_inputs(cuda, B, H, KV, S, hd, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _max_share(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", SPARSE_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_sparse_kernels_match_plain(cuda, case, dtype):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    B, H, KV, S, hd, causal, cls, fields = case
    layout = sa.sparse_layout(getattr(sa, cls)(**fields), S, causal, cuda)
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, dtype)
    o_p, lse_p = sa.sparse_attention_fwd_plain(q, k, v, layout)
    delta = fa.attention_delta(o_p, do)
    fns = (sa.sparse_fwd, sa.sparse_bwd_dq, sa.sparse_bwd_dkv)
    before = [f.launches for f in fns]
    o, lse = sa.sparse_fwd(q, k, v, layout)
    dq = sa.sparse_bwd_dq(q, k, v, do, lse_p, delta, layout)
    dk, dv = sa.sparse_bwd_dkv(q, k, v, do, lse_p, delta, layout)
    want = (o_p, sa.sparse_bwd_dq_plain(q, k, v, do, lse_p, delta, layout),
            *sa.sparse_bwd_dkv_plain(q, k, v, do, lse_p, delta, layout))
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [b + 1 for b in before]
    for got, ref in zip((o, dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert _max_share(got, ref) <= FLASH_SHARE[dtype]
    assert (lse - lse_p).abs().max().item() <= 2e-3
    # no atomics: a second launch repeats the first bit for bit
    assert torch.equal(sa.sparse_fwd(q, k, v, layout)[0], o)
    assert torch.equal(sa.sparse_bwd_dkv(q, k, v, do, lse_p, delta,
                                         layout)[0], dk)


@pytest.mark.parametrize("case", [(1, 25, 25, 1024, 64, True),
                                  (2, 4, 2, 512, 128, False)])
def test_sparse_dense_layout_equals_the_flash_kernels(cuda, case):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    B, H, KV, S, hd, causal = case
    layout = sa.sparse_layout(sa.SparsityConfig(), S, causal, cuda)
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, torch.bfloat16, 1)
    o_f, lse_f = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(o_f, do)
    want = (o_f, fa.flash_bwd_dq(q, k, v, do, lse_f, delta, causal=causal),
            *fa.flash_bwd_dkv(q, k, v, do, lse_f, delta, causal=causal))
    o, lse = sa.sparse_fwd(q, k, v, layout)
    got = (o, sa.sparse_bwd_dq(q, k, v, do, lse_f, delta, layout),
           *sa.sparse_bwd_dkv(q, k, v, do, lse_f, delta, layout))
    for g, w in zip(got, want):
        assert _max_share(g, w) <= FLASH_SHARE[torch.bfloat16]
    assert (lse - lse_f).abs().max().item() <= 2e-3


def test_sparse_kernels_refuse_what_they_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    layout = sa.sparse_layout(sa.FixedSparsityConfig(), 128, True, cuda)
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        sa.sparse_fwd(q, q, q, layout)
    q = q.bfloat16()
    x = torch.zeros(1, 128, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        sa.sparse_fwd(x, x, x, layout)
    for block in (8, 256):
        odd = sa.sparse_layout(sa.FixedSparsityConfig(block=block), 512,
                               True, cuda)
        y = torch.zeros(1, 512, 2, 64, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="sparsity block"):
            sa.sparse_fwd(y, y, y, odd)
    with pytest.raises(ValueError, match="positions"):
        sa.sparse_fwd(q[:, :64], q[:, :64], q[:, :64], layout)
    with pytest.raises(ValueError, match="lists are on"):
        sa.sparse_fwd(q, q, q, sa.sparse_layout(sa.FixedSparsityConfig(), 128,
                                                True, "cpu"))


def test_sparse_training_step_through_the_kernels(cuda):
    """One optimizer step of a tiny decoder with the sparse attention_fn:
    the sparse launch counts of remat (the forward reruns in the backward),
    no flash launch, and a finite loss."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    cfg = tiny_test(dtype=torch.bfloat16, max_seq=256)
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "remat": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 256))
    eng = dt.initialize(conf, dt.build_model(
        cfg, attention_fn=sa.make_sparse_attention_fn(
            sa.FixedSparsityConfig(block=16, num_local_blocks=2))), seed=0)
    fns = (sa.sparse_fwd, sa.sparse_bwd_dq, sa.sparse_bwd_dkv, fa.flash_fwd)
    before = [f.launches for f in fns]
    m = eng.train_batch({"input_ids": ids})
    n = cfg.n_layer * 2
    assert [f.launches - b for f, b in zip(fns, before)] == [2 * n, n, n, 0]
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


# ------------------------------------------------------------- fused xent
# (T, V, d, bias): nothing divides a tile, one token, BERT-large's and
# GPT-2 1.5B's widths at a cut vocab, a d that two clusters share unevenly
# (blocks past d), the widest eligible d
XENT_CASES = [(77, 1000, 64, True), (1, 1000, 64, False),
              (300, 3001, 1024, True), (200, 2500, 1600, False),
              (300, 3000, 2304, True), (130, 700, 6144, True),
              (4092, 50257, 1600, False)]
# max |kernel - plain| / max |plain| (chip_smoke.py XENT_TOL_SHARE)
XENT_SHARE = {"nll": 1e-4, "lse": 1e-4, "dx": 2e-2, "dw": 2e-2, "db": 1e-3}


def _xent_operands(cuda, T, V, d, bias, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(T, d, generator=g, device=cuda).bfloat16()
    w = (torch.randn(V, d, generator=g, device=cuda) * 0.05).bfloat16()
    b = (torch.randn(V, generator=g, device=cuda) * 0.5).bfloat16() \
        if bias else None
    t = torch.randint(0, V, (T,), generator=g, device=cuda)
    t[0] = V - 1                      # the tail tile's last valid column
    cot = torch.randn(T, generator=g, device=cuda) / T
    cot[::7] = 0.0
    return x, w, b, t, cot


@pytest.mark.parametrize("case", XENT_CASES)
def test_xent_kernels_match_plain(cuda, case):
    from deepspeed_tpu_torch.ops import xent as xe

    T, V, d, bias = case
    x, w, b, t, cot = _xent_operands(cuda, T, V, d, bias)
    if T > 2:
        t[1], t[2] = V + 3, -5        # outside the vocab: match nothing
    nll_p, lse_p = xe.xent_fwd_plain(x, w, b, t)
    dx_p, dw_p, db_p = xe.xent_bwd_plain(x, w, b, t, lse_p, cot)
    fns = (xe.xent_fwd, xe.xent_dx, xe.xent_dw)
    before = [f.launches for f in fns]
    nll, lse = xe.xent_fwd(x, w, b, t)
    dx = xe.xent_dx(x, w, b, t, lse_p, cot)
    dw, db = xe.xent_dw(x, w, b, t, lse_p, cot)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    assert dx.dtype == dw.dtype == torch.bfloat16 and db.dtype == torch.float32
    for name, got, ref in (("nll", nll, nll_p), ("lse", lse, lse_p),
                           ("dx", dx, dx_p), ("dw", dw, dw_p),
                           ("db", db, db_p)):
        assert bool(torch.isfinite(got).all()), name
        share = ((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30)).item()
        assert share <= XENT_SHARE[name], (name, share)
    assert not bool(dx[::7].any())
    if T > 2:
        assert bool((nll[1:3] == lse[1:3]).all())


def test_xent_partials_combine_to_the_full_forward(cuda):
    """Each shard of a 4-way hand split against its plain version (three
    of four see a foreign target), combined as the vocab-sharded caller
    combines them."""
    from deepspeed_tpu_torch.ops import xent as xe

    T, V, d, P = 500, 4000, 256, 4
    x, w, b, t, _ = _xent_operands(cuda, T, V, d, True, seed=1)
    vs = V // P
    tgt, lse = [], []
    for s in range(P):
        sl = slice(s * vs, (s + 1) * vs)
        got = xe.xent_fwd(x, w[sl], b[sl], t - s * vs, partials=True)
        want = xe.xent_fwd_plain(x, w[sl], b[sl], t - s * vs, partials=True)
        for a, r in zip(got, want):
            torch.testing.assert_close(a, r, rtol=0,
                                       atol=1e-4 * r.abs().max().item())
        tgt.append(got[0])
        lse.append(got[1])
    lse_l = torch.stack(lse)
    m = lse_l.amax(0)
    lse_g = m + torch.log(torch.exp(lse_l - m).sum(0))
    nll_f, lse_f = xe.xent_fwd(x, w, b, t)
    torch.testing.assert_close(lse_g, lse_f, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse_g - torch.stack(tgt).sum(0), nll_f,
                               atol=1e-4, rtol=1e-5)


def test_xent_kernels_refuse_what_they_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import xent as xe

    x, w, b, t, cot = _xent_operands(cuda, 8, 64, 32, True)
    with pytest.raises(ValueError, match="bf16"):
        xe.xent_fwd(x.float(), w.float(), None, t)
    with pytest.raises(ValueError, match="multiple of 16"):
        xe.xent_fwd(x[:, :24].contiguous(), w[:, :24].contiguous(), None, t)
    with pytest.raises(ValueError, match="contiguous"):
        xe.xent_fwd(x.t().contiguous().t(), w, None, t)
    with pytest.raises(ValueError, match="fp32"):
        xe.xent_dx(x, w, b, t, cot.double(), cot)


def test_default_config_loss_runs_the_fused_xent_head_on_the_card(cuda):
    """A tied head with fused_xent=None is where the JAX package takes its
    fused xent kernels on its accelerator; so does the port on the card,
    within bf16 rounding of its own unfused head."""
    from deepspeed_tpu_torch.ops import xent as xe

    cfg = tiny_test(dtype=torch.bfloat16)
    model = dt.build_model(cfg)
    unfused = dt.build_model(tiny_test(dtype=torch.bfloat16, fused_xent=False))
    master = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (4, 33), device=cuda)
    fns = (xe.xent_fwd, xe.xent_dx, xe.xent_dw)
    before = [f.launches for f in fns]
    out = []
    for m in (model, unfused):
        params = {k: v.bfloat16().requires_grad_() for k, v in master.items()}
        loss = m.loss(params, {"input_ids": ids})
        loss.backward()
        out.append((loss.item(), params["tok_embed"].grad.float()))
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1]
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-2)
    assert ((out[0][1] - out[1][1]).norm() / out[1][1].norm()).item() <= 5e-2


def test_bert_mlm_step_through_the_kernels(cuda):
    """One optimizer step of a tiny BERT (Hugging Face layout) on the card:
    bidirectional flash attention under a padding mask and the fused xent
    head with its bias, against the unfused head on dense attention."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import xent as xe

    over = dict(dtype=torch.bfloat16, vocab_size=1000, post_ln=True,
                embed_norm=True, mlm_transform=True, lm_head_bias=True)
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "remat": {"enabled": True, "policy": "save_names"},
            "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    rng = np.random.default_rng(0)
    att = np.ones((4, 64), np.int32)
    att[1, 40:] = 0
    batch = {"input_ids": rng.integers(0, 1000, (4, 64)),
             "labels": rng.integers(0, 1000, (4, 64)),
             "loss_mask": (rng.random((4, 64)) < 0.15).astype(np.int32) * att,
             "attention_mask": att}
    eng = dt.initialize(conf, dt.build_model(
        bert("tiny", **over),
        attention_fn=dt.make_flash_attention(causal=False)), seed=0)
    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, xe.xent_fwd,
           xe.xent_dx, xe.xent_dw)
    before = [f.launches for f in fns]
    m = eng.train_batch(dict(batch))
    n = 2 * 2                                     # layers x micro-batches
    assert [f.launches - b for f, b in zip(fns, before)] \
        == [2 * n, n, n, 2, 2, 2]
    dense = dt.initialize(conf, dt.build_model(
        bert("tiny", fused_xent=False, **over)), seed=0)
    r = dense.train_batch(dict(batch))
    assert float(m["loss"]) == pytest.approx(float(r["loss"]), rel=2e-2)
    assert float(m["grad_norm"]) == pytest.approx(float(r["grad_norm"]),
                                                  rel=5e-2)


# tied heads with fused_xent=False take the unfused head, as in the JAX
# package; the default config takes the fused xent kernels on the card
@pytest.mark.parametrize("cfg", [tiny_test(dtype=torch.bfloat16,
                                           fused_xent=False),
                                 tiny_test(dtype=torch.bfloat16),
                                 llama2("tiny", dtype=torch.bfloat16,
                                        vocab_size=512),
                                 bloom("tiny", dtype=torch.bfloat16,
                                       vocab_size=512, fused_xent=False)])
def test_training_step_through_the_kernels(cuda, cfg):
    """One optimizer step through the kernels on the card: the flash launch
    counts of remat (the forward reruns in the backward) and a finite loss
    and grad norm within 2e-2 of the plain attention path's."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import xent as xe

    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "remat": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    eng = dt.initialize(conf, dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()), seed=0)
    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, xe.xent_fwd,
           xe.xent_dx, xe.xent_dw)
    before = [f.launches for f in fns]
    m = eng.train_batch({"input_ids": ids})
    n = cfg.n_layer * 2
    head = 2 * eng.model._fused_xent_active(True, torch.bfloat16)
    assert [f.launches - b for f, b in zip(fns, before)] \
        == [2 * n, n, n, head, head, head]
    dense = dt.initialize(conf, dt.build_model(cfg), seed=0)
    r = dense.train_batch({"input_ids": ids})
    assert float(m["loss"]) == pytest.approx(float(r["loss"]), rel=2e-2)
    assert float(m["grad_norm"]) == pytest.approx(float(r["grad_norm"]),
                                                  rel=2e-2)


# ------------------------------------------------- flash: bias and fp32
# (B, H, KV, S, hd, causal, mask kind, bias layout): every layout of the
# bias, S past a tile (ragged), GQA, hd 16 and 128, the key masks; an
# "expanded" bias is a (1, H, S, S) tensor expanded to (B, H, S, S), the
# stride-0 view a learned broadcast bias reaches the kernels as
BIAS_CASES = [
    (2, 4, 2, 333, 64, True, None, "ss"),
    (2, 4, 2, 333, 64, False, None, "hss"),
    (2, 4, 4, 200, 32, True, "left_pad", "bhss"),
    (2, 4, 4, 200, 32, False, "dead_row", "b1ss"),
    (3, 8, 8, 256, 32, False, "left_pad", "1hss"),
    (3, 8, 8, 256, 32, True, None, "expanded"),
    (1, 4, 1, 130, 16, True, None, "bhss"),
    (2, 2, 2, 96, 128, False, None, "bhss"),
]
# max |kernel - plain| / max |plain| of o, dq, dk, dv and dbias by q's
# dtype: bf16 / fp16 a few ulps (phase 5's FLASH_SHARE); fp32 the 3xTF32
# products (~2^-22 of each term) and __expf, summed in another order
BIAS_SHARE = {torch.bfloat16: 2e-2, torch.float16: 1e-2, torch.float32: 1e-4}
# dbias is rounded to the bias's dtype on both sides: where that dtype is
# coarser than q's tolerance, one ulp of it (relative, at most 2^-7 for
# bf16, 2^-10 for fp16) bounds the difference
DBIAS_ROUNDING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
                  torch.float32: 0.0}


def _bias_for(layout, B, H, S, dtype, cuda, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = {"ss": (S, S), "hss": (H, S, S), "bhss": (B, H, S, S),
             "b1ss": (B, 1, S, S), "1hss": (1, H, S, S),
             "expanded": (1, H, S, S)}[layout]
    bias = (2 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    return bias.expand(B, H, S, S) if layout == "expanded" else bias


def _flash_bias_check(cuda, case, dtype, bias_dtype):
    """The three kernels with the bias against their plain versions; dq
    also with dbias, the bias expanded to (B, H, S, S) where it is
    broadcast. Returns the kernels' dbias."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, layout = case
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, dtype)
    bias = _bias_for(layout, B, H, S, bias_dtype, cuda)
    mask = None
    if mask_kind:
        mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
        if mask_kind == "left_pad":
            mask[-1, :3] = False
        else:
            mask[-1] = False
    kw = dict(mask=mask, causal=causal, bias=bias)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.attention_delta(o_p, do)
    full = fa.bias4(bias, B, H, S).expand(B, H, S, S)
    dq_p, dbias_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                          grad_bias=True,
                                          **{**kw, "bias": full})
    want = (o_p, dq_p, *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                               **kw), dbias_p)
    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [f.launches for f in fns]
    o, lse = fa.flash_fwd(q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dq2, dbias = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, grad_bias=True,
                                 **{**kw, "bias": full})
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [before[0] + 1, before[1] + 2,
                                         before[2] + 1]
    assert torch.equal(dq, dq2)
    assert dbias.dtype == bias_dtype and dbias.shape == (B, H, S, S)
    for name, got, ref in zip(("o", "dq", "dk", "dv", "dbias"),
                              (o, dq, dk, dv, dbias), want):
        assert bool(torch.isfinite(got).all()), name
        tol = BIAS_SHARE[dtype] if name != "dbias" else max(
            BIAS_SHARE[dtype], DBIAS_ROUNDING[bias_dtype])
        assert _max_share(got, ref) <= tol, name
    live = lse_p > fa.BIG_NEG / 2
    assert (lse - lse_p).abs()[live].max().item() <= 2e-3
    return dbias


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("case", BIAS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bias_kernels_match_plain(cuda, case, dtype, bias_dtype):
    _flash_bias_check(cuda, case, dtype, bias_dtype)


def test_flash_dbias_zero_above_the_diagonal(cuda):
    """dbias is allocated empty: the kernel writes every element, exact
    zeros where the causal loop skips a key tile and above the diagonal
    inside the diagonal tile, over memory that held NaN."""
    B, H, S = 2, 4, 333
    junk = torch.full((B * H * S * S * 2,), float("nan"), device=cuda)
    del junk                          # the allocator hands its block out again
    dbias = _flash_bias_check(cuda, (B, H, H, S, 64, True, None, "bhss"),
                              torch.bfloat16, torch.float32)
    assert bool((dbias.triu(1) == 0).all())
    assert not bool(dbias.tril().eq(0).all())


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[3] <= 2048])
def test_flash_fp32_kernels_match_plain(cuda, case):
    """fp32 q, k, v through all three kernels (3xTF32), no bias."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, alibi = case
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, torch.float32)
    mask = None
    if mask_kind:
        mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
        mask[-1, :3] = False
    kw = dict(mask=mask, causal=causal,
              alibi_slopes=alibi_slopes(H, cuda) if alibi else None)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.attention_delta(o_p, do)
    want = (o_p, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
    o, lse = fa.flash_fwd(q, k, v, **kw)
    got = (o, fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _max_share(g, w) <= 1e-4
    live = lse_p > fa.BIG_NEG / 2
    assert (lse - lse_p).abs()[live].max().item() <= 2e-3


def test_flash_bias_refusals_and_the_other_kernels_fp32(cuda):
    """An odd bias shape, a bias not contiguous in its last two dims or on
    another device raises before any launch; the sparse and xent kernels
    still refuse fp32 (ROADMAP.md section 3)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import xent as xe

    q = torch.randn(2, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    before = fa.flash_fwd.launches
    for bad in (torch.zeros(128, 64, device=cuda),
                torch.zeros(3, 4, 128, 128, device=cuda),
                torch.zeros(2, 2, 128, 128, device=cuda)):
        with pytest.raises(ValueError, match="bias must be"):
            fa.flash_fwd(q, q, q, bias=bad)
    with pytest.raises(ValueError, match="contiguous in its last two"):
        fa.flash_fwd(q, q, q, bias=torch.zeros(128, 128, device=cuda).t())
    with pytest.raises(ValueError, match="bias is on"):
        fa.flash_fwd(q, q, q, bias=torch.zeros(128, 128))
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        fa.flash_fwd(q, q, q, bias=torch.zeros(128, 128, device=cuda,
                                               dtype=torch.float64))
    assert fa.flash_fwd.launches == before
    # the autograd entry makes a transposed bias contiguous at its own shape
    t = torch.randn(128, 128, device=cuda).t()
    torch.testing.assert_close(fa.flash_attention(q, q, q, bias=t),
                               fa.flash_attention(q, q, q,
                                                  bias=t.contiguous()),
                               rtol=0, atol=0)
    layout = sa.sparse_layout(sa.FixedSparsityConfig(), 128, True, cuda)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        sa.sparse_fwd(q.float(), q.float(), q.float(), layout)
    x, w, b, tg, _ = _xent_operands(cuda, 8, 64, 32, True)
    with pytest.raises(ValueError, match="bf16"):
        xe.xent_fwd(x.float(), w.float(), None, tg)


def test_fp32_model_trains_through_the_kernels(cuda):
    """An fp32 TransformerLM with make_flash_attention() (the unfused head:
    the xent kernels take bf16 only) trains on the card through the fp32
    flash kernels, within phase 6's gate of the dense path."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = tiny_test(dtype=torch.float32, fused_xent=False)
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "remat": {"enabled": True}, "gradient_clipping": 1.0,
            "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    eng = dt.initialize(conf, dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()), seed=0)
    dense = dt.initialize(conf, dt.build_model(cfg), seed=0)
    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for step in range(3):
        before = [f.launches for f in fns]
        m = eng.train_batch({"input_ids": ids})
        n = cfg.n_layer * 2
        assert [f.launches - b for f, b in zip(fns, before)] == [2 * n, n, n]
        r = dense.train_batch({"input_ids": ids})
        assert float(m["loss"]) == pytest.approx(float(r["loss"]), rel=1e-2)
        assert float(m["grad_norm"]) == pytest.approx(float(r["grad_norm"]),
                                                      rel=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_evoformer_block_through_the_kernels(cuda, dtype):
    """The gated, pair-biased block of examples/evoformer_science.py at its
    smoke size: one launch of each kernel a step, the pair representation's
    gradient from the kernels' dbias against the dense path's."""
    import numpy as np

    from deepspeed_tpu_torch.ops import evoformer as evo
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, S, H, hd = 2, 32, 4, 16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, S, H * hd))).to(cuda, dtype)
    pair = torch.from_numpy(rng.standard_normal((B, S, S, 8))).to(cuda)
    w = {n: torch.from_numpy(rng.standard_normal(s) * 0.05).to(cuda)
         for n, s in (("wq", (H * hd, H * hd)), ("wk", (H * hd, H * hd)),
                      ("wv", (H * hd, H * hd)), ("wg", (H * hd, H * hd)),
                      ("wb", (8, H)))}

    def run(attention):
        leaves = {n: t.float().requires_grad_() for n, t in w.items()}
        p = pair.float().requires_grad_()
        q, k, v, g = ((x @ leaves[n].to(dtype)).reshape(B, S, H, hd)
                      for n in ("wq", "wk", "wv", "wg"))
        bias = torch.einsum("bstd,dh->bhst", p, leaves["wb"]).to(dtype)
        out = attention(q, k, v, bias=bias, gate=g)
        loss = out.float().square().mean()
        loss.backward()
        return loss.item(), p.grad

    def dense(q, k, v, *, bias, gate):
        return evo.dense_biased_attention(q, k, v, bias) \
            * torch.sigmoid(gate)

    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [f.launches for f in fns]
    loss, dpair = run(evo.evoformer_attention)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]
    loss_d, dpair_d = run(dense)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert loss == pytest.approx(loss_d, rel=tol / 5)
    assert float(dpair.norm()) > 0
    assert ((dpair - dpair_d).norm() / dpair_d.norm()).item() <= tol
