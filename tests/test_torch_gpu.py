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
