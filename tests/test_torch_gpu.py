"""deepspeed_tpu_torch on the card: the CUDA kernels against their plain
versions, and the generate and serving paths through them.

Marked ``gpu``; each test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). Run on a card:
``python -m pytest -m gpu tests/test_torch_gpu.py -q``."""

import dataclasses

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import bert, bloom, llama2, mixtral, tiny_test
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


# x @ W's shapes on the tensor-core route: Llama-2-7B's decode projections
# and head (fp32 out there), OPT-6.7B's w_in / w_out
WOQ_MMA_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
                  (4096, 32000), (4096, 16384), (16384, 4096)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("out", [None, torch.float32])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17])
@pytest.mark.parametrize("K,N", WOQ_MMA_SHAPES)
def test_woq_matmul_mma_matches_plain(cuda, bits, xdtype, out, M, K, N):
    """The tensor-core route against the plain version, one launch a
    call, twice bit-identical (the split-K merge runs in split order)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "mm", M, K, N, 128, bits, xdtype)
    assert wm.woq_route(xdtype, M, K, N, qt.group_size) == "mma"
    kw = dict(group_size=qt.group_size, bits=qt.bits, out_dtype=out)
    before = wm.woq_matmul.launches
    got = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    again = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    assert wm.woq_matmul.launches == before + 2
    assert got.dtype == (out or xdtype) and got.shape == (M, N)
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=WOQ_SHARE[got.dtype] * want.float().abs().max().item())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,group,route", [
    (4, 1600, 4800, 128, "mma"),      # GPT-2 1.5B: one group of 1600 rows
    (17, 1600, 6400, 128, "mma"),
    (4, 4096, 4096, 64, "mma"),       # two groups a stage
    (4, 4096, 4096, 256, "mma"),      # two stages a group
    (4, 1000, 512, 128, "simt"),      # one group of 1000 rows
    (4, 256, 1001, 128, "simt"),      # ragged N
    (4, 4096, 160, 128, "mma"),       # a ragged last column tile
])
def test_woq_matmul_routes_on_the_card(cuda, bits, M, K, N, group, route):
    """Each call runs the route woq_route names, and both routes hold
    against the plain version (bf16 x, fp32 out)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "mm", M, K, N, group, bits, torch.bfloat16)
    assert wm.woq_route(x.dtype, M, K, N, qt.group_size) == route
    kw = dict(group_size=qt.group_size, bits=qt.bits, out_dtype=torch.float32)
    got = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


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


# ------------------------------------------------------------- serving
# (config, inference config): the slot step over decode attention in fp32,
# over both kernels in bf16 int8 (Llama: RoPE, GQA), and under ALiBi
SERVE_CASES = {
    "tiny_test": (lambda: tiny_test(dtype=torch.float32, max_seq=128), {}),
    "llama2_tiny_int8": (lambda: llama2("tiny", max_seq=256),
                         {"quantize": True, "quant_bits": 8,
                          "quant_group_size": 32}),
    "bloom_tiny": (lambda: bloom("tiny", dtype=torch.float32,
                                 vocab_size=1000), {}),
    # MoE: the one-group dispatch, the int8 banks dequantized in the graph
    "mixtral_tiny_int8": (lambda: mixtral("tiny", max_seq=256),
                          {"quantize": True, "quant_bits": 8,
                           "quant_group_size": 32}),
}


def _server(cuda, name, **serving):
    make, conf = SERVE_CASES[name]
    cfg = make()
    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    # fp32 weights: the engine casts them (an MoE router stays fp32)
    params = model.init(g, device=cuda, dtype=torch.float32)
    eng = dt.init_inference(model, params, {
        "dtype": str(cfg.dtype).removeprefix("torch."), **conf})
    return eng, dt.ServingEngine(eng, {"slots": 3, "max_len": 128,
                                       "prefill_chunk": 16, "greedy": True,
                                       **serving})


def _stream(vocab, shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, vocab, (P,), generator=g).numpy(), N, 10 + i)
            for i, (P, N) in enumerate(shapes)]


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_slot_step_replay_equals_eager(cuda, name):
    """Three live slots: the first decode step captured the slot step; a
    replay and an eager step from the same state give the same tokens and
    logits, and launch the kernels the capture recorded."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    eng, srv = _server(cuda, name)
    cfg = eng.model.cfg
    for p, n, s in _stream(cfg.vocab_size, [(5, 60), (20, 60), (40, 60)]):
        srv.submit(p, n, seed=s)
    while srv.sched.occupancy < 3:
        srv.step()
    assert srv.captures == 1 and srv.graph.replays > 0
    # the fused qkv and wo, and a dense FFN's products (an MoE layer's
    # banks dequantize at their point of use instead)
    per_layer = 2 if cfg.num_experts > 1 else (5 if cfg.is_glu else 4)
    woq = per_layer * cfg.n_layer + 1 if "int8" in name else 0
    want = {"decode_attention": cfg.n_layer, "woq_matmul": woq}
    assert srv.graph.captured_launches == {k: n for k, n in want.items()
                                           if n}
    st = srv.state
    with torch.inference_mode():
        marks = [t.clone() for t in (st.cache.length, st.tok, st.done)]
        lg_g = srv.slot_step(graphed=True)[0].clone()
        tok_g = st.tok.clone()
        for t, m in zip((st.cache.length, st.tok, st.done), marks):
            t.copy_(m)
        before = (da.decode_attention.launches, wm.woq_matmul.launches)
        lg_e = srv.slot_step(graphed=False)[0]
        assert (da.decode_attention.launches - before[0],
                wm.woq_matmul.launches - before[1]) == (cfg.n_layer, woq)
        assert torch.equal(st.tok, tok_g)
        torch.testing.assert_close(lg_g, lg_e, atol=1e-5, rtol=0)
        assert torch.equal(st.cache.length, marks[0] + 1)
    assert srv.captures == 1


def test_captures_stay_one_over_a_stream(cuda):
    """Inserts, retirements, and slots idling past max_len (requests one
    at a time over three slots): one capture for the whole stream, and
    every request's greedy tokens equal its solo generate() through the
    same kernels (fp32)."""
    eng, srv = _server(cuda, "tiny_test", max_len=128)
    reqs = _stream(eng.model.cfg.vocab_size,
                   [(9, 100), (30, 90), (4, 110), (60, 60), (17, 100)])
    outs = []
    for p, n, s in reqs:
        outs += srv.serve_batch([p], [n], [s])
    assert int(srv.state.cache.length.max()) > 128
    outs += srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                            [s for _, _, s in reqs])
    assert srv.captures == 1
    for (p, n, s), got in zip(reqs + reqs, outs):
        want = eng.generate(p[None], n, greedy=True, request_seeds=[s],
                            cache_len=128)[0].cpu().numpy()
        assert (got == want).all()


def test_failed_capture_raises(cuda, monkeypatch):
    """A slot step whose capture fails raises from step(); the engine
    never falls back to the eager step, and no later step runs eager."""
    eng, srv = _server(cuda, "tiny_test")
    forward = srv._forward_slots

    def uncapturable():
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this slot step cannot be captured")
        return forward()

    monkeypatch.setattr(srv, "_forward_slots", uncapturable)
    srv.submit(_stream(eng.model.cfg.vocab_size, [(8, 20)])[0][0], 20)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        srv.step()
    assert srv.captures == 0 and not srv.graph.captured
    with pytest.raises(RuntimeError, match="cannot be captured"):
        srv.step()
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        srv.slot_step(graphed=True)
    torch.cuda.synchronize()


# ------------------------------------------------------------ paged serving
PAGED = {"page_size": 16}


def _shared_requests(vocab, seed=0):
    """A stream with prefix hits and copy-on-write: two system prompts of
    48 tokens, suffixes, and a second turn extending a first past a
    partial page."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda n: torch.randint(0, vocab, (n,), generator=g).numpy()
    import numpy as np
    heads = [rnd(48), rnd(48)]
    t1 = np.concatenate([heads[0], rnd(21)])
    reqs = [np.concatenate([heads[i % 2], rnd(5 + 7 * i)]) for i in range(6)]
    reqs[1:1] = [t1, np.concatenate([t1, rnd(19)])]
    return [(p, 12 + 2 * i, 10 + i) for i, p in enumerate(reqs)]


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_captures_stay_one_over_hits_cow_and_evictions(cuda, kv_bits):
    """A paged stream with prefix hits, copy-on-write and evictions (a
    pool of half the pages a full set of slots needs), requests one at a
    time and then all at once: one capture for the whole stream, every
    request OK in full, the pool's pages all back after the drain."""
    eng, srv = _server(cuda, "tiny_test", **PAGED, pool_pages=13,
                       kv_quant_bits=kv_bits)
    reqs = _shared_requests(eng.model.cfg.vocab_size)
    outs = []
    for p, n, s in reqs[:3]:
        outs += srv.serve_batch([p], [n], [s])
    outs += srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                            [s for _, _, s in reqs])
    assert srv.captures == 1 and srv.graph.replays > 0
    assert [len(o) for o in outs] == [n for _, n, _ in reqs[:3] + reqs]
    snap = srv.metrics_snapshot()["pages"]
    assert snap["prefix_hit_rate"] > 0 and snap["cow_copies"] >= 1
    assert snap["evictions"] + snap["defers"] > 0
    assert snap["live_requests"] == 0
    assert snap["free_pages"] + snap["tree_held_pages"] == \
        snap["usable_pages"]


@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny_int8",
                                  "mixtral_tiny_int8"])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_slot_step_replay_equals_eager(cuda, name, kv_bits):
    """Three live paged slots: a replay and an eager step from the same
    state give bit-identical logits and tokens, and launch the kernels the
    capture recorded; the paged tokens of a stream without prefix hits
    equal the contiguous engine's."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    eng, srv = _server(cuda, name, **PAGED, kv_quant_bits=kv_bits)
    cfg = eng.model.cfg
    stream = _stream(cfg.vocab_size, [(5, 60), (20, 60), (40, 60)])
    for p, n, s in stream:
        srv.submit(p, n, seed=s)
    while srv.sched.occupancy < 3:
        srv.step()
    assert srv.captures == 1
    per_layer = 2 if cfg.num_experts > 1 else (5 if cfg.is_glu else 4)
    woq = per_layer * cfg.n_layer + 1 if "int8" in name else 0
    want = {"decode_attention": cfg.n_layer, "woq_matmul": woq}
    assert srv.graph.captured_launches == {k: n for k, n in want.items()
                                           if n}
    st = srv.state
    with torch.inference_mode():
        marks = [t.clone() for t in (st.cache.length, st.tok, st.done)]
        lg_g = srv.slot_step(graphed=True)[0].clone()
        tok_g = st.tok.clone()
        for t, m in zip((st.cache.length, st.tok, st.done), marks):
            t.copy_(m)
        lg_e = srv.slot_step(graphed=False)[0]
        assert torch.equal(st.tok, tok_g) and torch.equal(lg_g, lg_e)
    if kv_bits:
        return
    _, flat = _server(cuda, name)
    args = [[p for p, _, _ in stream], [n for _, n, _ in stream],
            [s for _, _, s in stream]]
    _, again = _server(cuda, name, **PAGED)
    for a, b in zip(again.serve_batch(*args), flat.serve_batch(*args)):
        assert (a == b).all()


@pytest.mark.parametrize("tier", ["host", "nvme", "int8"])
def test_tier_restores_on_the_card(cuda, tier, tmp_path):
    """Two sessions alternating on a one-request pool: every resume
    restores its evicted prefix from the pinned host tier (or the disk rung
    under a host tier of two pages) through the tier stream's copies; the
    tokens equal the tier-off engine's, one capture, nothing pinned or
    leaked, both copy directions timed."""
    paged = {**PAGED, "pool_pages": 5}        # one request's 48 + 8 tokens
    if tier == "int8":
        paged["kv_quant_bits"] = 8
    _, ref = _server(cuda, "tiny_test", **paged)
    page = ref.state.cache.k[:, 0].nbytes + ref.state.cache.v[:, 0].nbytes
    conf = {"host": {"host_pool_bytes": 64 << 20},
            "nvme": {"host_pool_bytes": 2 * page, "nvme_pool_bytes": 64 << 20,
                     "nvme_path": str(tmp_path)},
            "int8": {"host_pool_bytes": 64 << 20}}[tier]
    eng, srv = _server(cuda, "tiny_test", **paged, **conf)
    A, B = (p for p, _, _ in _stream(eng.model.cfg.vocab_size,
                                     [(48, 8), (48, 8)]))

    def cycle(s):
        return [s.serve_batch([p], [8], [10 * i + r])[0].tolist()
                for r in range(3) for i, p in enumerate((A, B))]

    assert cycle(srv) == cycle(ref)
    assert srv.captures == 1
    snap = srv.tier_snapshot()
    assert snap["restores"] >= 4 and snap["fallbacks"] == 0
    io = snap["io"]
    assert io["d2h_bytes"] > 0 and io["d2h_ms"] > 0
    assert io["h2d_bytes"] > 0 and io["h2d_ms"] > 0
    if tier == "nvme":
        assert snap["spills"] > 0 and snap["nvme_tier"]["hits"] > 0
        assert snap["nvme_tier"]["fallbacks"] == 0
    pool = srv.pool
    assert not pool._alloc and len(pool.free) + pool.tree_held == pool.usable
    assert all(not e["pinned"] for e in srv.hostkv.entries.values())
    srv.close()


def test_paged_view_attention_equals_contiguous(cuda):
    """Decode attention over the gathered view of shuffled pages equals
    decode attention over a contiguous cache holding the same bytes, bit
    for bit, bf16 and dequantized int8; an idle row on scratch and one
    past the cache among them."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(0)
    got = chip_smoke._paged_view_check(gen, 4, 256,
                                       (1, 130, 256, 300), cuda, H=8)
    assert got["bf16"] is True and got["int8"] is True


def test_paged_table_flush_reaches_the_next_replay(cuda):
    """Clear a live slot's table row, flush, replay: the replay writes that
    slot's token to scratch page 0 and none of its old pages change, while
    the other slots write their own pages."""
    eng, srv = _server(cuda, "tiny_test", **PAGED)
    for p, n, s in _stream(eng.model.cfg.vocab_size,
                           [(9, 60), (20, 60), (33, 60)]):
        srv.submit(p, n, seed=s)
    while srv.sched.occupancy < 3:
        srv.step()
    assert srv.captures == 1
    st = srv.state
    with torch.inference_mode():
        old = srv._table[1].copy()
        pages = torch.as_tensor(old[old > 0]).long().to(cuda)
        before = st.cache.k[:, pages].clone()
        scratch = st.cache.k[:, 0].clone()
        other = int(srv._table[2][int(st.cache.length[2]) // 16])
        other_before = st.cache.k[:, other].clone()
        srv._table[1] = 0
        srv._table_dirty = True
        srv._flush_table()
        assert int(st.cache.page_table[1].abs().sum()) == 0
        srv.slot_step(graphed=True)
        torch.cuda.synchronize()
        assert torch.equal(st.cache.k[:, pages], before)
        assert not torch.equal(st.cache.k[:, 0], scratch)
        assert not torch.equal(st.cache.k[:, other], other_before)
    assert srv.captures == 1


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
    each exporting only its own kernel; hd 16 to the mma.sync ones, whose
    16-bit build refuses hd 32-128 (fp32: test_f32_backward_plan_and_routes);
    an odd head dim or a
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

# ------------------------------------------- the fp32 wgmma backward
F32_SHARE = 1e-4      # 3xTF32 products (~2^-22 of each term), ex2, sums in
                      # another order: phase 5d's fp32 gate


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("layout", ["ss", "hss", "bhss", "b1ss", "1hss",
                                    "expanded"])
def test_f32_backward_bias_layouts(cuda, layout, bias_dtype):
    """Every bias layout and bias dtype through the fp32 wgmma pair at hd
    64 and 32, causal and not, S off the tiles, a key mask: dbias within
    one rounding of its dtype, exactly 0 above a causal diagonal, and two
    calls with dbias bit-identical."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    for case in ((2, 4, 2, 200, 64, True, None, layout),
                 (2, 4, 4, 333, 32, False, "left_pad", layout),
                 (2, 4, 4, 77, 32, True, "dead_row", layout)):
        B, H, KV, S, hd, causal = case[:6]
        assert fa.library("flash_bwd_dq", torch.float32, hd) \
            == "flash_bwd_dq_f32_sm90"
        dbias = _flash_bias_check(cuda, case, torch.float32, bias_dtype)
        if causal:
            assert bool((dbias.triu(1) == 0).all())
        q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, torch.float32)
        bias = fa.bias4(_bias_for(layout, B, H, S, bias_dtype, cuda),
                        B, H, S).expand(B, H, S, S)
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                              bias=bias)
        delta = fa.attention_delta(o, do)
        a, b = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                bias=bias, grad_bias=True) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_f32_backward_plan_and_routes(cuda):
    """Each fp32 wgmma library exports only its own kernel, takes the
    shared memory flash_bwd_f32_plan() gives, and refuses 16-bit operands
    and the head dims it does not build; fp32 hd 16 and 128 keep the
    mma.sync kernels."""
    import ctypes

    from deepspeed_tpu_torch.ops import flash_attention as fa

    for kernel, other in (("flash_bwd_dq", "flash_bwd_dkv"),
                          ("flash_bwd_dkv", "flash_bwd_dq")):
        lib = fa._lib(f"{kernel}_f32_sm90")
        assert hasattr(lib, f"dstpu_{kernel}")
        assert not hasattr(lib, f"dstpu_{other}")
        smem = getattr(lib, f"dstpu_{kernel}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for hd in (32, 64):
            assert smem(hd) == fa.flash_bwd_f32_plan(kernel, hd)["smem_bytes"]
        assert smem(128) == 0 and smem(16) == 0
        # a bf16 call and an hd 128 call straight to the library: refused
        x = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
        lse = torch.zeros(1, 2, 64, device=cuda)
        P = ctypes.c_void_p
        fn = getattr(lib, f"dstpu_{kernel}")
        for dtype_code, hd in ((2, 64), (3, 128), (3, 16)):
            err = fn(*(P(t.data_ptr()) for t in (x, x, x, x, lse, lse)), None,
                     None, None, P(x.data_ptr()), None, 1, 64, 2, 2, hd, 1,
                     dtype_code, 0, 0, 0, 0.125,
                     P(torch.cuda.current_stream().cuda_stream))
            assert err != 0
        for hd in (16, 128):
            assert fa.library(kernel, torch.float32, hd) \
                == "flash_attention_f32"


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("layout", ["ss", "hss", "bhss", "b1ss", "1hss",
                                    "expanded"])
def test_f32_forward_bias_layouts(cuda, layout, bias_dtype):
    """Every bias layout and bias dtype through the fp32 wgmma forward at hd
    32, 64 and 128, causal and not, S off the tiles, GQA, key masks with
    fully masked rows: o within 1e-4 of max |plain|, lse within 2e-3 on
    live rows, o exactly 0 and lse finite on the dead rows, and a second
    call bit-identical."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    for B, H, KV, S, hd, causal, mask_kind in (
            (2, 4, 2, 200, 64, True, None),
            (2, 4, 4, 333, 32, False, "left_pad"),
            (2, 4, 4, 77, 32, True, "dead_row"),
            (2, 4, 2, 150, 128, False, "dead_row")):
        assert fa.library("flash_fwd", torch.float32, hd) \
            == "flash_fwd_f32_sm90"
        q, k, v, _ = _sparse_inputs(cuda, B, H, KV, S, hd, torch.float32)
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
        o, lse = fa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(o).all())
        assert bool(torch.isfinite(lse).all())
        assert _max_share(o, o_p) <= F32_SHARE
        live = lse_p > fa.BIG_NEG / 2
        assert (lse - lse_p).abs()[live].max().item() <= 2e-3
        if not bool(live.all()):
            assert bool((o.transpose(1, 2)[~live] == 0).all())
        o2, lse2 = fa.flash_fwd(q, k, v, **kw)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_f32_forward_plan_and_routes(cuda):
    """The fp32 wgmma forward's library exports the forward alone, takes
    the shared memory flash_fwd_f32_plan() gives and refuses 16-bit
    operands and hd 16, which keeps the mma.sync kernel."""
    import ctypes

    from deepspeed_tpu_torch.ops import flash_attention as fa

    lib = fa._lib("flash_fwd_f32_sm90")
    assert hasattr(lib, "dstpu_flash_fwd")
    assert not hasattr(lib, "dstpu_flash_bwd_dq")
    smem = lib.dstpu_flash_fwd_f32_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for hd in (32, 64, 128):
        assert smem(hd) == fa.flash_fwd_f32_plan(hd)["smem_bytes"]
    assert smem(16) == 0
    x = torch.zeros(1, 64, 2, 64, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    P = ctypes.c_void_p
    for dtype_code, hd in ((2, 64), (3, 16)):
        err = lib.dstpu_flash_fwd(*(P(t.data_ptr()) for t in (x, x, x)), None,
                                  None, None, P(x.data_ptr()),
                                  P(lse.data_ptr()), 1, 64, 2, 2, hd, 1,
                                  dtype_code, 0, 0, 0, 0.125,
                                  P(torch.cuda.current_stream().cuda_stream))
        assert err != 0
    assert fa.library("flash_fwd", torch.float32, 16) == "flash_attention_f32"


def _probe(cuda, which, a, b):
    import ctypes

    from deepspeed_tpu_torch.ops import builder

    fn = builder.load("flash_bwd_dq_f32_sm90").dstpu_flash_bwd_f32_probe
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    d = torch.empty(64, 32, device=cuda)
    assert fn(which, a.data_ptr(), b.data_ptr(), d.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return d


def test_tf32_wgmma_reads_the_top_19_bits(cuda):
    """Design point 1's check, which the fp32 kernels rely on: one wgmma
    product from raw fp32 tiles has the bits of the same product from
    tiles whose low 13 bits are cleared, so the tensor cores truncate a
    tf32 operand and TMA's raw tile serves as its own high part. The
    masked product is the fp64 one of the masked operands to fp32's
    rounding."""
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn(64, 32, generator=g, device=cuda)
    b = torch.randn(32, 32, generator=g, device=cuda)
    cut = lambda x: (x.view(torch.int32) & -8192).view(torch.float32)  # noqa
    raw, masked = _probe(cuda, 0, a, b), _probe(cuda, 0, cut(a), cut(b))
    assert torch.equal(raw, masked)
    want = cut(a).double() @ cut(b).double().T
    assert (masked.double() - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()


def test_tf32_fragment_order_and_pos(cuda):
    """Design point 3's check: an accumulator-layout (64, 32) matrix taken
    into A fragments in place (split_frags) times a tile transposed in
    pos() order (transpose_step), 3xTF32, is the fp64 product to ~1e-6; a
    wrong fragment order would mix columns and miss by O(1)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    a = torch.randn(64, 32, generator=g, device=cuda)
    b = torch.randn(32, 32, generator=g, device=cuda)
    want = a.double() @ b.double()
    got = _probe(cuda, 1, a, b)
    assert (got.double() - want).abs().max().item() \
        <= 2e-6 * want.abs().max().item()


# ------------------------------------------------------------- sparse attention
# (B, H, KV, S, hd, causal, config class, fields): chip_smoke.py phase 5c's
# cases at smaller sizes: the default Fixed layout, each layout, blocks 16,
# 32 and 128, hd 128, 32 and 16, GQA / MQA, one block, a layout whose
# narrow lists leave out block 0 (a kernel reading its lists past k_n /
# q_n would add block 0, their padding), and one whose last k-block no
# q-block keeps (its dk and dv must come out exactly 0)
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
    (1, 8, 8, 1024, 32, True, "FixedSparsityConfig", {}),
    (1, 8, 2, 1024, 32, False, "BigBirdSparsityConfig", {"block": 128}),
    (1, 4, 2, 1024, 64, True, "PreviousBlockConfig", {}),
    (1, 4, 4, 1024, 128, True, "PreviousBlockConfig", {"block": 128}),
]


def _sparse_config(sa, cls, fields):
    """The config class ``cls`` of the sparse module, or
    ``PreviousBlockConfig``: block i keeps blocks 0 and i - 1 and not
    itself, so under the causal cut the last k-block has an empty q-list."""
    import dataclasses

    if cls != "PreviousBlockConfig":
        return getattr(sa, cls)(**fields)

    @dataclasses.dataclass(frozen=True)
    class PreviousBlockConfig(sa.SparsityConfig):
        def make_layout(self, n):
            import numpy as np

            lay = np.zeros((n, n), bool)
            lay[:, 0] = True
            for i in range(1, n):
                lay[i, i - 1] = True
            return lay

    return PreviousBlockConfig(**fields)


def _empty_key_rows(layout):
    """The key positions of the k-blocks whose q-list is empty."""
    empty = (layout.q_n == 0).nonzero().flatten().tolist()
    return [p for jk in empty
            for p in range(jk * layout.block, (jk + 1) * layout.block)]


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
    layout = sa.sparse_layout(_sparse_config(sa, cls, fields), S, causal,
                              cuda)
    for kernel in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
        assert sa.library(kernel, layout.block, hd) == (
            f"{kernel}_sm90" if layout.block in (64, 128) and hd >= 32
            else "sparse_attention")
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
    o2, lse2 = sa.sparse_fwd(q, k, v, layout)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(sa.sparse_bwd_dq(q, k, v, do, lse_p, delta, layout),
                       dq)
    dk2, dv2 = sa.sparse_bwd_dkv(q, k, v, do, lse_p, delta, layout)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    # k-blocks that no q-block keeps: dk = dv = 0 exactly
    rows = _empty_key_rows(layout)
    assert (cls == "PreviousBlockConfig") == bool(rows)
    for t in (dk, dv):
        assert not t[:, rows].any()
    # the backward pair fed the kernel forward's o and lse, as training
    # feeds it
    delta_k = fa.attention_delta(o, do)
    got = (sa.sparse_bwd_dq(q, k, v, do, lse, delta_k, layout),
           *sa.sparse_bwd_dkv(q, k, v, do, lse, delta_k, layout))
    for g, ref in zip(got, want[1:]):
        assert bool(torch.isfinite(g).all())
        assert _max_share(g, ref) <= FLASH_SHARE[dtype]


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


def test_sparse_wgmma_forward_plan_and_routes(cuda):
    """The wgmma forward's library exports the forward alone, takes the
    shared memory sparse_fwd_plan() gives and refuses blocks 16 and 32, hd
    16 and fp32 straight to the library; blocks 16 and 32 route to the
    mma.sync library, and every route gives the plain version's o."""
    import ctypes

    from deepspeed_tpu_torch.ops import sparse_attention as sa

    lib = sa._lib("sparse_fwd_sm90")
    assert hasattr(lib, "dstpu_sparse_fwd")
    assert not hasattr(lib, "dstpu_sparse_bwd_dq")
    smem = lib.dstpu_sparse_fwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for hd in (32, 64, 128):
        assert smem(hd) == sa.sparse_fwd_plan(hd)["smem_bytes"]
    assert smem(16) == 0
    P = ctypes.c_void_p
    for block, hd, dtype_code in ((32, 64, 2), (16, 64, 2), (64, 16, 2),
                                  (64, 64, 3)):
        layout = sa.sparse_layout(sa.FixedSparsityConfig(block=block), 256,
                                  True, cuda)
        x = torch.zeros(1, 256, 2, hd, device=cuda, dtype=torch.bfloat16)
        lse = torch.zeros(1, 2, 256, device=cuda)
        err = lib.dstpu_sparse_fwd(
            *(P(t.data_ptr()) for t in (x, x, x, x, lse, layout.k_idx,
                                        layout.k_n, layout.q_order)),
            layout.k_idx.shape[1], 1, 256, 2, 2, hd, block, 1, dtype_code,
            0.125, P(torch.cuda.current_stream().cuda_stream))
        assert err != 0
    for block in (16, 32, 64, 128):
        layout = sa.sparse_layout(sa.FixedSparsityConfig(block=block), 512,
                                  True, cuda)
        want = "sparse_fwd_sm90" if block >= 64 else "sparse_attention"
        assert sa.library("sparse_fwd", block, 64) == want
        q, k, v, _ = _sparse_inputs(cuda, 1, 4, 2, 512, 64, torch.bfloat16)
        o, _ = sa.sparse_fwd(q, k, v, layout)
        o_p, _ = sa.sparse_attention_fwd_plain(q, k, v, layout)
        assert _max_share(o, o_p) <= FLASH_SHARE[torch.bfloat16]


def test_sparse_wgmma_backward_plan_and_routes(cuda):
    """The wgmma backward pair's libraries each export their kernel's
    function alone, take the shared memory sparse_bwd_plan() gives and
    refuse blocks 16 and 32, hd 16 and fp32 straight to the library."""
    import ctypes

    from deepspeed_tpu_torch.ops import sparse_attention as sa

    P = ctypes.c_void_p
    for kernel in ("sparse_bwd_dq", "sparse_bwd_dkv"):
        lib = sa._lib(f"{kernel}_sm90")
        others = {"sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"} - {kernel}
        assert hasattr(lib, f"dstpu_{kernel}")
        assert not any(hasattr(lib, f"dstpu_{o}") for o in others)
        smem = getattr(lib, f"dstpu_{kernel}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for hd in (32, 64, 128):
            assert smem(hd) == sa.sparse_bwd_plan(kernel, hd)["smem_bytes"]
            assert smem(hd) <= 232448
        assert smem(16) == 0
        for block, hd, dtype_code in ((32, 64, 2), (16, 64, 2), (64, 16, 2),
                                      (64, 64, 3)):
            layout = sa.sparse_layout(sa.FixedSparsityConfig(block=block),
                                      256, True, cuda)
            x = torch.zeros(1, 256, 2, hd, device=cuda, dtype=torch.bfloat16)
            rows = torch.zeros(1, 2, 256, device=cuda)
            outs = (x,) if kernel == "sparse_bwd_dq" else (x, x)
            idx, cnt, order = ((layout.k_idx, layout.k_n, layout.q_order)
                               if kernel == "sparse_bwd_dq" else
                               (layout.q_idx, layout.q_n, layout.k_order))
            err = getattr(lib, f"dstpu_{kernel}")(
                *(P(t.data_ptr()) for t in (x, x, x, x, rows, rows, *outs,
                                            idx, cnt, order)),
                idx.shape[1], 1, 256, 2, 2, hd, block, 1, dtype_code, 0.125,
                P(torch.cuda.current_stream().cuda_stream))
            assert err != 0


# (B, H, KV, S, hd, causal, config class, fields): the wgmma backward pair
# against the mma.sync pair of sparse_attention.cu on the same inputs, at
# blocks 64 and 128, hd 32-128, GQA, causal and not
AB_CASES = [
    (1, 25, 25, 2048, 64, True, "FixedSparsityConfig", {}),
    (1, 8, 2, 1024, 32, True, "FixedSparsityConfig", {"block": 128}),
    (2, 4, 4, 1024, 128, False, "BigBirdSparsityConfig", {}),
    (1, 4, 4, 1024, 64, True, "BSLongformerSparsityConfig",
     {"num_sliding_window_blocks": 1, "global_block_indices": (15,)}),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", AB_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_sparse_wgmma_backward_matches_the_mma_sync_pair(cuda, case, dtype):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    B, H, KV, S, hd, causal, cls, fields = case
    layout = sa.sparse_layout(getattr(sa, cls)(**fields), S, causal, cuda)
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, dtype, seed=2)
    o, lse = sa.sparse_fwd(q, k, v, layout)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, layout)
    new = (sa._bwd_dq_on(sa.library("sparse_bwd_dq", layout.block, hd),
                         *args),
           *sa._bwd_dkv_on(sa.library("sparse_bwd_dkv", layout.block, hd),
                           *args))
    old = (sa._bwd_dq_on("sparse_attention", *args),
           *sa._bwd_dkv_on("sparse_attention", *args))
    torch.cuda.synchronize()
    for n, a, b in zip(("dq", "dk", "dv"), new, old):
        assert bool(torch.isfinite(a).all()), n
        assert _max_share(a, b) <= FLASH_SHARE[dtype], n


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
# GPT-2 1.5B's widths at a cut vocab (two chunks of the backward, the last
# ragged), a d past a 128-column tile, the widest eligible d, then the main
# paths' heads: GPT-2 1.5B (phase 7), BERT-large's MLM head (phase 8) and
# GPT-2 1.5B at 8191 tokens (phase 9)
XENT_CASES = [(77, 1000, 64, True), (1, 1000, 64, False),
              (300, 3001, 1024, True), (200, 2500, 1600, False),
              (300, 3000, 2304, True), (130, 700, 6144, True),
              (256, 2000, 6144, True), (4092, 50257, 1600, False),
              (8192, 30522, 1024, True), (8191, 50257, 1600, False)]
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
    fns = (xe.xent_fwd, xe.xent_bwd)
    before = [f.launches for f in fns]
    nll, lse = xe.xent_fwd(x, w, b, t)
    dx, dw, db = xe.xent_bwd(x, w, b, t, lse_p, cot)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    # a second call repeats the first bit for bit (no atomics, fixed orders)
    again = xe.xent_bwd(x, w, b, t, lse_p, cot)
    for a, r in zip((dx, dw, db), again):
        assert torch.equal(a, r)
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


@pytest.mark.parametrize("vc", [256, 512, 1024])
def test_xent_bwd_chunks_agree_with_one_call(cuda, vc):
    """The backward walked in small vocab chunks (the dx buffer's first,
    middle and last chunk, the last one ragged) against its plain version,
    and rows with g = 0 exactly 0 in dx."""
    from deepspeed_tpu_torch.ops import xent as xe

    x, w, b, t, cot = _xent_operands(cuda, 300, 1900, 192, True, seed=2)
    lse = xe.xent_fwd_plain(x, w, b, t)[1]
    want = xe.xent_bwd_plain(x, w, b, t, lse, cot)
    plan = xe.xent_bwd_plan(300, 1900, 192, 132, vc)
    assert len(plan["chunks"]) == -(-1900 // vc)
    got = xe.xent_bwd(x, w, b, t, lse, cot, vc=vc)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        share = ((a.float() - r.float()).abs().max()
                 / r.float().abs().max()).item()
        assert share <= XENT_SHARE[name], (name, share)
    assert not bool(got[0][::7].any())


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
        xe.xent_bwd(x, w, b, t, cot.double(), cot)
    with pytest.raises(ValueError, match="multiple of 16"):
        xe.xent_bwd(x[:, :24].contiguous(), w[:, :24].contiguous(), b, t,
                    cot, cot)
    with pytest.raises(ValueError, match="multiple of 256"):
        xe.xent_bwd(x, w, b, t, cot, cot, vc=100)


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
    fns = (xe.xent_fwd, xe.xent_bwd)
    before = [f.launches for f in fns]
    out = []
    for m in (model, unfused):
        params = {k: v.bfloat16().requires_grad_() for k, v in master.items()}
        loss = m.loss(params, {"input_ids": ids})
        loss.backward()
        out.append((loss.item(), params["tok_embed"].grad.float()))
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1]
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
           xe.xent_bwd)
    before = [f.launches for f in fns]
    m = eng.train_batch(dict(batch))
    n = 2 * 2                                     # layers x micro-batches
    assert [f.launches - b for f, b in zip(fns, before)] \
        == [2 * n, n, n, 2, 2]
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
           xe.xent_bwd)
    before = [f.launches for f in fns]
    m = eng.train_batch({"input_ids": ids})
    n = cfg.n_layer * 2
    head = 2 * eng.model._fused_xent_active(True, torch.bfloat16)
    assert [f.launches - b for f, b in zip(fns, before)] \
        == [2 * n, n, n, head, head]
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


# fp32 cases beyond FLASH_CASES and FWD_CASES: the longest sums a dk/dv
# unit of the 3xTF32 wgmma pair runs, G * S / 32 steps (chip_smoke.py
# FLASH_F32_LONG_CASES)
F32_LONG_CASES = [
    (1, 8, 8, 4096, 64, True, None, False),
    (1, 4, 4, 8192, 64, False, None, False),
    (1, 16, 2, 2048, 64, True, None, False),        # GQA group 8
    (1, 8, 1, 8192, 32, True, "left_pad", True),
]
F32_CASES = list(dict.fromkeys([c for c in FLASH_CASES if c[3] <= 2048]
                               + FWD_CASES + F32_LONG_CASES))


@pytest.mark.parametrize("case", F32_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_fp32_kernels_match_plain(cuda, case):
    """fp32 q, k, v through all three kernels (3xTF32), no bias, the
    backward fed the plain forward's lse and delta: the forward at hd
    32-128 and dq and dk/dv at hd 32 and 64 on the wgmma libraries, the
    rest on mma.sync (the route checked); each output within 1e-4 of max
    |plain|, lse within 2e-3 on live rows, o and dq exactly 0 on rows
    without a live key, dk and dv exactly 0 on masked keys, a second
    forward and a second backward bit-identical."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd, causal, mask_kind, alibi = case
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.library(kernel, torch.float32, hd) == (
            f"{kernel}_f32_sm90" if hd in (32, 64) else "flash_attention_f32")
    assert fa.library("flash_fwd", torch.float32, hd) == (
        "flash_fwd_f32_sm90" if hd in (32, 64, 128) else "flash_attention_f32")
    q, k, v, do = _sparse_inputs(cuda, B, H, KV, S, hd, torch.float32)
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
    want = (o_p, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
    o, lse = fa.flash_fwd(q, k, v, **kw)
    before = [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    runs = [(fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert [fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches] == [
        before[0] + 2, before[1] + 2]
    for g, w in zip((o, *runs[0]), want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert _max_share(g, w) <= F32_SHARE
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    live = lse_p > fa.BIG_NEG / 2
    assert (lse - lse_p).abs()[live].max().item() <= 2e-3
    dq, dk, dv = runs[0]
    if not bool(live.all()):
        assert bool((dq.transpose(1, 2)[~live] == 0).all())
        assert bool((o.transpose(1, 2)[~live] == 0).all())
        assert bool(torch.isfinite(lse).all())
    if mask is not None:
        assert bool((dk[~mask] == 0).all()) and bool((dv[~mask] == 0).all())
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


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


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_resume_on_the_card_is_bit_identical(cuda, tmp_path,
                                                        async_save):
    """A tiny bf16 model through the kernels: 2 steps, a save (sync, or
    async with the next steps racing its writer), 2 more steps; a fresh
    engine (another seed) loads the tag, holds exactly the state at the
    save, and its 2 steps equal the first engine's bit for bit."""
    import numpy as np

    from deepspeed_tpu_torch.runtime.checkpoint import engine as ckpt

    cfg = tiny_test(dtype=torch.bfloat16)
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "remat": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "checkpoint": {"async_save": async_save}}
    rng = np.random.default_rng(0)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 64))}
            for _ in range(4)]

    def engine(seed):
        return dt.initialize(conf, dt.build_model(
            cfg, attention_fn=dt.make_flash_attention()), seed=seed)

    def record(m):
        return float(m["loss"]), float(m["grad_norm"]), m["lr"]

    a = engine(0)
    for b in data[:2]:
        a.train_batch(dict(b))
    saved = {g: {k: t.clone() for k, t in d.items()}
             for g, d in ckpt._groups(a).items()}
    a.save_checkpoint(tmp_path)
    assert a._host_state.data["master"].is_pinned()
    want = [record(a.train_batch(dict(b))) for b in data[2:]]
    a.wait_for_checkpoint()
    b = engine(1)
    b.load_checkpoint(tmp_path)
    for g, d in ckpt._groups(b).items():
        for k, t in d.items():
            assert t.device.type == "cuda" and torch.equal(t, saved[g][k]), \
                (g, k)
    assert [record(b.train_batch(dict(x))) for x in data[2:]] == want
    for g, d in ckpt._groups(b).items():
        for k, t in d.items():
            assert torch.equal(t, ckpt._groups(a)[g][k]), (g, k)
    assert (b.step, b.opt_state.count, b.global_steps) \
        == (a.step, a.opt_state.count, a.global_steps)


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


def _world_of_one():
    """A world of one rank over NCCL (``init_distributed``)."""
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)

    return init_distributed(f"localhost:{_free_port()}", 1, 0)


def test_comm_wrappers_over_nccl_match_their_cpu_results(cuda):
    """Every collective of ``comm/comm.py`` over a world of one on the card:
    a line of one rank reduces to the tensor itself, gathers and scatters
    to it along any dim; the same calls with no process group (the CPU
    results) return the same values."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.platform.mesh import build_mesh

    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, 4, generator=g)
    none = build_mesh()
    want = {"sum": comm.all_reduce(x.clone(), "data", mesh=none),
            "gather1": comm.all_gather(x, "data", 1, mesh=none),
            "scatter2": comm.reduce_scatter(x, "data", 2, mesh=none)}
    _world_of_one()
    try:
        mesh = build_mesh()
        assert mesh.active and mesh.world == 1 and not mesh.solo("data")
        y = x.to(cuda)
        for op in ("sum", "mean", "max", "min"):
            got = comm.all_reduce(y.clone(), ("data", "zero"), op, mesh=mesh)
            assert torch.equal(got.cpu(), want["sum"]), op
        for dim in range(3):
            assert torch.equal(comm.all_gather(y, "data", dim,
                                               mesh=mesh).cpu(), x)
            assert torch.equal(comm.reduce_scatter(y, "zero", dim,
                                                   mesh=mesh).cpu(), x)
        out = torch.empty_like(y)
        comm.all_gather(y, "data", 1, mesh=mesh, out=out)
        assert torch.equal(out.cpu(), want["gather1"])
        assert torch.equal(comm.reduce_scatter(y, "data", 2, mesh=mesh)
                           .cpu(), want["scatter2"])
        q = torch.tensor([1, -2, 3], dtype=torch.int8, device=cuda)
        assert torch.equal(comm.all_gather(q, "data", mesh=mesh), q)
        assert torch.equal(comm.broadcast(y.clone(), "data", mesh=mesh), y)
        comm.barrier(mesh=mesh)
        assert (comm.get_world_size(mesh=mesh), comm.get_rank(mesh=mesh)) \
            == (1, 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("remat", [True, False])
def test_stage3_gather_on_use_is_bit_identical_to_stage0(cuda, remat):
    """A tiny bf16 model through the kernels, 2 steps: the engine with no
    process group, then in a world of one over NCCL at stage 0 and at
    stage 3 with every leaf cut (gathered layer by layer, its grads
    reduce-scattered in the backward): losses, grad norms and every master
    / mu / nu leaf bit-identical, at most two layers gathered at once."""
    import numpy as np
    import torch.distributed as dist

    cfg = tiny_test(dtype=torch.bfloat16, n_layer=4)
    rng = np.random.default_rng(0)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 64))}
            for _ in range(2)]
    init = dt.build_model(cfg).init(torch.Generator(device=cuda)
                                    .manual_seed(0), device=cuda,
                                    dtype=torch.float32)

    def run(stage):
        conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "remat": {"enabled": remat}, "gradient_clipping": 1.0,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": stage,
                                      "param_persistence_threshold": 0}}
        e = dt.initialize(conf, dt.build_model(
            cfg, attention_fn=dt.make_flash_attention()), params=init)
        steps = [e.train_batch(dict(b)) for b in data]
        return ([(float(m["loss"]), float(m["grad_norm"])) for m in steps],
                {g: {k: t.clone() for k, t in d.items()} for g, d in (
                    ("master", e.master), ("mu", e.opt_state.mu),
                    ("nu", e.opt_state.nu))}, e.gather_peak_layers)

    want, want_state, _ = run(0)
    _world_of_one()
    try:
        for stage in (0, 3):
            got, state, peak = run(stage)
            assert got == want, stage
            for g, d in state.items():
                for k, t in d.items():
                    assert torch.equal(t, want_state[g][k]), (stage, g, k)
            assert peak == (2 if stage == 3 else 0)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("drop_tokens", [True, False])
def test_moe_layer_on_the_card_matches_its_cpu_run(cuda, drop_tokens):
    """Mixtral tiny's MoE block, bf16 on the card against fp32 on the CPU
    from the same bf16 weights and inputs: the training dispatch (a group
    a row) and the decode dispatch (one group), within one bf16 rounding
    step of the outputs' scale (2e-2 of max |out|; fp32 routing on both
    sides, so the same experts)."""
    cfg = mixtral("tiny", moe_drop_tokens=drop_tokens)
    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    full = model.init(g, device=cuda, dtype=torch.float32)
    p = {k[len("layers."):]: (v[0] if k.endswith("router") else
                              v[0].to(torch.bfloat16))
         for k, v in full.items() if k.startswith("layers.")}
    y = torch.randn((3, 40, cfg.d_model), generator=g, device=cuda) \
        .to(torch.bfloat16)
    cpu = dt.models.build_model(dataclasses.replace(cfg, dtype=torch.float32))
    pc = {k: v.float().cpu() for k, v in p.items()}
    with torch.no_grad():
        for fn, x in (("_mlp_block", y), ("_mlp_block_infer", y[:, :1])):
            got, aux = getattr(model, fn)(x, p)
            want, aux_c = getattr(cpu, fn)(x.float().cpu(), pc)
            assert got.dtype == torch.bfloat16
            scale = want.abs().max().item()
            assert (got.float().cpu() - want).abs().max().item() \
                <= 2e-2 * scale, fn
            assert float(aux) == pytest.approx(float(aux_c), rel=1e-5)


def test_router_stays_fp32_under_a_bf16_cast(cuda):
    """The inference engine's cast and the training engine's compute cast
    keep the router fp32 on the card; every other weight is bf16, and a
    training step runs through the flash kernels."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = mixtral("tiny", max_seq=64, vocab_size=256, n_layer=2)
    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g, device=cuda, dtype=torch.float32)
    eng = dt.init_inference(model, params, {"dtype": "bf16"})
    assert eng.params["layers.router"].dtype == torch.float32
    assert eng.params["layers.w_in"].dtype == torch.bfloat16
    tr = dt.initialize({"train_batch_size": 4,
                        "train_micro_batch_size_per_gpu": 2,
                        "moe": {"enabled": True, "num_experts": 4}},
                       dt.build_model(cfg, attention_fn=dt.make_flash_attention()),
                       params={k: v.cpu() for k, v in params.items()})
    cp, _, _ = tr._cast_compute()
    assert all(t.dtype == torch.float32 for t in cp["layers.router"])
    assert all(t.dtype == torch.bfloat16 for t in cp["layers.w_gate"])
    before = fa.flash_fwd.launches
    ids = torch.randint(0, 256, (4, 64), generator=torch.Generator()
                        .manual_seed(0))
    loss = float(tr.train_batch({"input_ids": ids.numpy()})["loss"])
    assert loss == loss and fa.flash_fwd.launches - before == 2 * 2


# ------------------------------------------------- tensor / expert parallel
# the shapes each rank of a TP 2 / 4 world gives the decode step's kernels:
# Llama-2-7B's heads (H = KV = 32 / tp) and the 70B GQA heads at tp 4 and 8
TP_DECODE_HEADS = [(16, 16), (8, 8), (16, 2), (8, 1)]
# woq_matmul int8, bf16 x, M 8: Llama-2-7B's column shards (fused qkv,
# w_in / w_gate) and row shards (wo; w_out at tp 2) with fp32 partials
TP_WOQ_SHAPES = [(4096, 6144, None), (4096, 3072, None), (4096, 5504, None),
                 (4096, 2752, None), (2048, 4096, torch.float32),
                 (1024, 4096, torch.float32), (5504, 4096, torch.float32)]


@pytest.mark.parametrize("H,KV", TP_DECODE_HEADS)
def test_decode_attention_at_rank_heads_matches_plain(cuda, H, KV):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, hd = 8, 1024, 128
    q, ck, cv = (torch.randn(shape, generator=g, device=cuda)
                 .to(torch.bfloat16) for shape in
                 ((B, 1, H, hd), (B, KV, S, hd), (B, KV, S, hd)))
    lengths = torch.tensor([1, S, 513, 0, 700, 1023, 64, 900],
                           dtype=torch.int32, device=cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, ck, cv, lengths)
    again = da.decode_attention(q, ck, cv, lengths)
    want = da.decode_attention_plain(q, ck, cv, lengths)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("K,N,out", TP_WOQ_SHAPES)
def test_woq_matmul_at_rank_shards_matches_plain(cuda, K, N, out):
    """The shards of the whole leaf's quantization (``rows`` / ``columns``),
    as a rank holds them, through the kernel."""
    from deepspeed_tpu_torch.inference.quantization import quantize
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    g = torch.Generator(device=cuda).manual_seed(1)
    whole = quantize(torch.randn(K * 2 if out else K, N * (1 if out else 2),
                                 generator=g, device=cuda) * 0.05, 128, 8)
    qt = whole.rows(K, 2 * K) if out else whole.columns(N, 2 * N)
    assert qt.aligned
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    assert wm.woq_route(x.dtype, 8, K, N, qt.group_size) == "mma"
    kw = dict(group_size=qt.group_size, bits=8, out_dtype=out)
    got = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=WOQ_SHARE[got.dtype] * want.float().abs().max().item())


@pytest.mark.parametrize("tp", [2, 4])
def test_woq_matmul_t_on_a_vocab_shard_matches_plain(cuda, tp):
    """OPT-6.7B's int4 tied table (one group: 50272 rows at group 128) cut
    over the vocabulary: each rank's table is one group of its own rows."""
    from deepspeed_tpu_torch.inference.quantization import quantize
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    V, K = 50272, 4096
    g = torch.Generator(device=cuda).manual_seed(2)
    whole = quantize(torch.randn(V, K, generator=g, device=cuda) * 0.02,
                     128, 4)
    qt = whole.rows(V // tp, 2 * V // tp)
    assert qt.group_size == V // tp and qt.scale.shape[0] == 1
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    assert wm.woq_t_route(x.dtype, K, V // tp, qt.group_size) == "mma"
    kw = dict(group_size=qt.group_size, bits=4, out_dtype=torch.float32)
    got = wm.woq_matmul_t(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_t_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", ["llama2_tiny_int8", "mixtral_tiny_int8"])
def test_graphed_slot_step_with_collectives_is_bit_identical(cuda, name):
    """A world of one over NCCL: the serving engine's slot step, its
    all-reduces and all-gather captured in the CUDA graph, serves the same
    stream with the same tokens as the engine with no process group, with
    one capture that records the collectives (for an MoE model the
    ("expert", "model") combine)."""
    import torch.distributed as dist

    shapes = [(5, 30), (20, 30), (40, 30), (9, 20)]

    def serve():
        eng, srv = _server(cuda, name)
        reqs = _stream(eng.model.cfg.vocab_size, shapes)
        out = srv.serve_batch([p for p, _, _ in reqs],
                              [n for _, n, _ in reqs],
                              [s for _, _, s in reqs])
        return [o.tolist() for o in out], srv

    want, none = serve()
    assert none.graph.captured_collectives == {}
    _world_of_one()
    try:
        got, srv = serve()
        cfg = srv.model.cfg
        assert got == want and srv.captures == 1
        assert srv.graph.captured_collectives == {
            "allreduce": 1 + 2 * cfg.n_layer, "allgather": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("tp", [2, 4])
def test_xent_kernels_on_vocab_shards_match_the_whole_head(cuda, tp):
    """Phase 16a at a small shape: each rank's ``xent_fwd`` partials on its
    rows with shifted targets, combined, and ``xent_bwd`` with the global
    lse against the kernels on the whole head (``phase_tp_train_kernels``
    raises past its gates; the backward twice bit-identical)."""
    import chip_smoke

    out = chip_smoke.phase_tp_train_kernels(
        device="cuda", head=("small", 509, 4000, 256), tps=(tp,), flash=(),
        iters=2)
    assert len(out["shards"]) == tp
    assert out["max_abs_err"]["dx"] <= chip_smoke.TP_XENT_TOL_SHARE["dx"]


def test_fused_token_nll_tp_over_a_world_of_one_is_fused_token_nll(cuda):
    """``fused_token_nll_tp`` over NCCL in a world of one: the kernels on
    the whole table, the combine exact (lse_l + log 1), dx all-reduced over
    a group of one: NLL and every grad bit-identical to
    ``fused_token_nll``."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.ops import xent as xe
    from deepspeed_tpu_torch.platform.mesh import build_mesh

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(300, 128, generator=g, device=cuda).bfloat16()
    w = (torch.randn(1000, 128, generator=g, device=cuda) * 0.05).bfloat16()
    b = torch.randn(1000, generator=g, device=cuda).bfloat16()
    t = torch.randint(0, 1000, (300,), generator=g, device=cuda)
    t[:2] = torch.tensor([1000, -3])

    def run(fn):
        leaves = [a.clone().requires_grad_() for a in (x, w, b)]
        nll = fn(*leaves)
        nll.sum().backward()
        return [nll.detach()] + [a.grad for a in leaves]

    want = run(lambda x_, w_, b_: xe.fused_token_nll(x_, w_, b_, t))
    _world_of_one()
    try:
        mesh = build_mesh()
        got = run(lambda x_, w_, b_: xe.fused_token_nll_tp(
            x_, w_, b_, t, v0=0, mesh=mesh))
    finally:
        dist.destroy_process_group()
    for a, e in zip(got, want):
        assert torch.equal(a, e)


# ------------------------------------------------------------- speculation
SPEC = {"ngram": 3, "max_draft": 4}


def _spec_server(cuda, name, **serving):
    """``SERVE_CASES[name]`` at a 256-token vocabulary (where a random tiny
    model falls into the output loops the drafter learns), flash_decode
    off, serving with speculation."""
    make, conf = SERVE_CASES[name]
    cfg = dataclasses.replace(make(), vocab_size=256)
    model = dt.models.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g, device=cuda, dtype=torch.float32)
    eng = dt.init_inference(model, params, {
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "flash_decode": False, **conf})
    return eng, dt.ServingEngine(eng, {"slots": 3, "max_len": 128,
                                       "prefill_chunk": 16, "greedy": True,
                                       "speculation": SPEC, **serving})


def _spec_requests(n, seed=0):
    """Half motif-tiled prompts (drafts accepted), half random ones."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            p = torch.randint(0, 32, (4,), generator=g).repeat(5).numpy()
            new = 40 + 3 * i
        else:
            p = torch.randint(0, 256, (9 + 4 * i,), generator=g).numpy()
            new = 20 + 2 * i
        out.append((p, new, 50 + i))
    return out


@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny_int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_replay_equals_eager(cuda, name, paged):
    """Three live slots once the verify graph is captured: a verify replay
    and an eager verify from the same state give bit-identical logits and
    winners, advance every length by max_draft + 1, and the capture
    recorded the step's kernels (int8: 5 ``woq_matmul`` a layer and the
    head)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    eng, srv = _spec_server(cuda, name, **(PAGED if paged else {}))
    cfg = eng.model.cfg
    for p, n, s in _spec_requests(3):
        srv.submit(p, n, seed=s)
    for _ in range(400):
        if srv.sched.occupancy == 3 and srv.verify_captures == 1:
            break
        srv.step()
    assert srv.verify_captures == 1 and srv.sched.occupancy == 3
    woq = 5 * cfg.n_layer + 1 if "int8" in name else 0
    assert srv.verify_graph.captured_launches == (
        {"woq_matmul": woq} if woq else {})
    K = SPEC["max_draft"]
    drafts = torch.randint(0, 256, (3, K),
                           generator=torch.Generator().manual_seed(1))
    st = srv.state
    with torch.inference_mode():
        marks = [t.clone() for t in (st.cache.length, st.tok, st.done)]
        lg_g, back_g = (t.clone() for t in srv.verify_step(drafts,
                                                             graphed=True))
        assert torch.equal(st.cache.length, marks[0] + K + 1)
        for t, m in zip((st.cache.length, st.tok, st.done), marks):
            t.copy_(m)
        before = wm.woq_matmul.launches
        lg_e, back_e = srv.verify_step(drafts, graphed=False)
        assert wm.woq_matmul.launches - before == woq
        assert torch.equal(lg_g, lg_e) and torch.equal(back_g, back_e)
        assert lg_g.shape == (3, K + 1, cfg.vocab_size)
    assert srv.captures == 1 and srv.verify_captures == 1


@pytest.mark.parametrize("paged", [False, True])
def test_verify_graph_captured_once_over_a_stream(cuda, paged):
    """Requests one at a time, then all at once, with as many drafts
    accepted as the model's loops give (the counts vary step to step): one
    capture of each graph for the whole stream; every verify but the
    first (eager, before the capture) is a replay; a paged pool gets every
    page back."""
    eng, srv = _spec_server(cuda, "tiny_test", **(PAGED if paged else {}))
    accepted = []
    commit = srv._spec_verify_commit

    def counted(plan):
        out = commit(plan)
        accepted.append(out[2][1])
        return out

    srv._spec_verify_commit = counted
    reqs = _spec_requests(6)
    for p, n, s in reqs:
        srv.serve_batch([p], [n], [s])
    srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                    [s for _, _, s in reqs])
    snap = srv.spec_snapshot()
    assert srv.captures == 1 and srv.verify_captures == 1
    assert snap["verify_steps"] == len(accepted) > 0
    assert srv.verify_graph.replays == snap["verify_steps"] - 1
    assert len(set(accepted)) >= 3 and snap["accepted_tokens"] > 0
    if paged:
        ps = srv.pool.snapshot()
        assert ps["free_pages"] + ps["tree_held_pages"] == ps["usable_pages"]


SPEC_VERIFY_M = 8 * (SPEC["max_draft"] + 1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N,out", [(4096, 12288, None), (4096, 4096, None),
                                     (4096, 11008, None), (11008, 4096, None),
                                     (4096, 32000, torch.float32)])
def test_woq_matmul_at_the_verify_width_matches_plain(cuda, bits, K, N, out):
    """Llama-2-7B's projections and head at the verify forward's M (8
    slots x 5 tokens): the tensor-core route under its split plan against
    the plain version, twice bit-identical."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_pair(cuda, "mm", SPEC_VERIFY_M, K, N, 128, bits,
                      torch.bfloat16)
    assert wm.woq_route(x.dtype, SPEC_VERIFY_M, K, N, 128) == "mma"
    kw = dict(group_size=qt.group_size, bits=qt.bits, out_dtype=out)
    got = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    again = wm.woq_matmul(x, qt.q, qt.scale, **kw)
    want = wm.woq_matmul_plain(x, qt.q, qt.scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=WOQ_SHARE[got.dtype] * want.float().abs().max().item())


def test_verify_graph_with_collectives_is_bit_identical(cuda):
    """A world of one over NCCL: the verify forward's all-reduces and
    all-gather captured in its graph; the stream's tokens equal the engine
    with no process group's, bit for bit."""
    import torch.distributed as dist

    reqs = _spec_requests(4, seed=3)

    def serve():
        eng, srv = _spec_server(cuda, "llama2_tiny_int8", **PAGED)
        out = srv.serve_batch([p for p, _, _ in reqs],
                              [n for _, n, _ in reqs],
                              [s for _, _, s in reqs])
        return [o.tolist() for o in out], srv

    want, none = serve()
    assert none.verify_graph.captured_collectives == {}
    _world_of_one()
    try:
        got, srv = serve()
        cfg = srv.model.cfg
        assert got == want
        assert srv.verify_captures == 1
        assert srv.spec_snapshot()["accepted_tokens"] > 0
        assert srv.verify_graph.captured_collectives == {
            "allreduce": 1 + 2 * cfg.n_layer, "allgather": 1}
    finally:
        dist.destroy_process_group()
