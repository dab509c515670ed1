"""deepspeed_tpu_torch on the card: the CUDA kernels against their plain
versions, and the generate path through them.

Marked ``gpu``; each test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). Run on a card:
``python -m pytest -m gpu tests/test_torch_gpu.py -q``."""

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import bloom, llama2, tiny_test
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
@pytest.mark.parametrize("M", [1, 4, 17])
@pytest.mark.parametrize("V,K,group", [(50272, 4096, 128), (32000, 4096, 128),
                                       (1002, 256, 64), (2048, 130, 128)])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
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
