"""deepspeed_tpu_torch weight-only quantization vs the JAX package's, on
the CPU.

- ``quantize`` / ``_pack_int4`` / ``dequantize`` / ``dequant_rows``: the
  int8 and packed-int4 bytes and the fp32 scales are BYTE-identical to
  JAX's compiled ``quantize`` (what its engine runs) for the same fp32 or
  bf16 input, and dequantized values are equal bit for bit.
- ``woq_matmul_plain`` / ``woq_matmul_t_plain`` against the Pallas kernels
  in interpret mode. fp32 results agree to 2e-5 of the output's max |value|
  (the same products, summed in another order); bf16 results to 2^-7 of it
  and fp16 ones to 2^-9 (one rounding of the output on each side, a few
  ulp apart at most).
- ``woq_t_route``: which shapes and dtypes take the tensor-core kernel.
- Engines: greedy tokens identical to the JAX engine and fp32 decode logits
  within 1e-4 absolute, in both ``woq_kernel`` modes, each against the same
  JAX mode (kernel semantics vs per-use dequant). No leaf of these engines
  meets JAX's off-TPU kernel gate (a group of more than 6144 rows), so the
  kernel modes compare like with like; the one test of such a leaf says so
  and compares with JAX's dequant path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.ops import woq_matmul as jwm
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.ops import woq_matmul as twm

from test_torch_model import make_pair  # a test module of this directory

LOGIT_ATOL = 1e-4
FP32_SHARE = 2e-5
BF16_SHARE = 2.0 ** -7
FP16_SHARE = 2.0 ** -9

# group sizes per engine case: tiny_test at 32 (every weight multi-group);
# llama2 tiny at 64 (w_out's 688 rows degrade to one group); OPT tiny at
# 128 (d 64 and the 50272-row tied table degrade to one group each)
GROUP = {"tiny_test": 32, "llama2_tiny": 64, "opt_tiny": 128}


# the JAX engine quantizes under jit, where XLA turns the division by
# qmax into a product with its fp32 reciprocal: that is the oracle
jquantize = jax.jit(jq.quantize, static_argnames=("group_size", "bits"))


def rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def assert_bytes_equal(tqt, jqt):
    assert (tqt.group_size, tqt.bits) == (jqt.group_size, jqt.bits)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(tqt.scale.numpy().view(np.uint32),
                                  np.asarray(jqt.scale).view(np.uint32))


# --------------------------------------------------------------- quantize
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,gs", [
    ((256, 384), 64),        # multi-group
    ((96, 200), 128),        # degraded: 96 % 128 != 0 -> one group of 96
    ((105, 64), 35),         # odd group: int4 degrades to int8
    ((3, 128, 96), 32),      # stacked (L, K, N) leaf
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bytes_identical_to_jax(bits, shape, gs, dtype):
    w = rand(shape, seed=1)
    jqt = jquantize(to_jax(w, getattr(jnp, dtype)), group_size=gs,
                    bits=bits)
    tqt = tq.quantize(to_torch(w, getattr(torch, dtype)), gs, bits=bits)
    assert tqt.shape == tuple(jqt.shape)
    assert_bytes_equal(tqt, jqt)
    np.testing.assert_array_equal(
        tq.dequantize(tqt, torch.float32).numpy(),
        np.asarray(jq.dequantize(jqt, jnp.float32)))


def test_pack_and_unpack_int4_match_jax():
    vals = np.random.default_rng(2).integers(-8, 8, (4, 64, 24)) \
        .astype(np.int8)
    packed = tq._pack_int4(torch.from_numpy(vals))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq._pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tq._unpack_int4(packed).numpy(), vals)
    np.testing.assert_array_equal(
        twm.unpack_int4(packed[0]).numpy(),
        np.asarray(jwm._unpack_rows(jnp.asarray(packed[0].numpy()))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gs", [50, 64])     # 250 rows: one group / many
def test_dequant_rows_matches_jax(bits, gs):
    w = rand((250, 64), seed=3)
    ids = np.array([[0, 3, 249], [7, 100, 8]], np.int32)
    jqt = jquantize(jnp.asarray(w), group_size=gs, bits=bits)
    tqt = tq.quantize(torch.from_numpy(w), gs, bits=bits)
    got = tq.dequant_rows(tqt, torch.from_numpy(ids).long(), torch.float32)
    want = jq.dequant_rows(jqt, jnp.asarray(ids), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tq.dequantize(tqt, torch.float32).numpy()[ids])


@pytest.mark.parametrize("min_size", [4096, 1])
def test_quantize_params_rules_match_jax(min_size):
    """The same leaves are quantized (by name, rank and size), to the same
    bytes; norms, biases and small leaves stay dense."""
    jm, jparams, tm, tparams = make_pair("opt_tiny")
    jtree = jax.jit(lambda p: jq.quantize_params(
        p, group_size=32, min_size=min_size))(jparams)
    tflat = tq.quantize_params(tparams, group_size=32, min_size=min_size)
    jflat = {k: v for k, v in jtree.items() if k != "layers"}
    jflat.update({f"layers.{k}": v for k, v in jtree["layers"].items()})
    assert set(jflat) == set(tflat)
    quantized = set()
    for k, v in tflat.items():
        assert isinstance(v, tq.QuantizedTensor) \
            == isinstance(jflat[k], jq.QuantizedTensor), k
        if isinstance(v, tq.QuantizedTensor):
            quantized.add(k.rsplit(".", 1)[-1])
            assert_bytes_equal(v, jflat[k])
    assert {"wq", "wo", "w_in", "w_out", "tok_embed", "pos_embed"} <= quantized
    assert not quantized & {"ln1_scale", "ln1_bias", "bq", "b_in", "lnf_scale"}
    assert tq.quantized_bytes(tflat) == jq.quantized_bytes(jtree)
    assert tq.decode_weight_bytes(tflat) == jq.decode_weight_bytes(jtree)


# ------------------------------------------------------------ plain GEMMs
def _close(got, want, share=FP32_SHARE):
    """Both as fp32; |got - want| within ``share`` of max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.astype(np.float32), want, rtol=0,
                               atol=share * float(np.abs(want).max()))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 5])
@pytest.mark.parametrize("K,N,gs", [(256, 384, 64), (96, 200, 128)])
def test_woq_matmul_plain_matches_the_pallas_kernel(bits, xdtype, M, K, N,
                                                    gs):
    w, x = rand((K, N), seed=4, scale=K ** -0.5), rand((M, K), seed=5)
    jqt = jquantize(jnp.asarray(w), group_size=gs, bits=bits)
    tqt = tq.quantize(torch.from_numpy(w), gs, bits=bits)
    for out in (None, "float32"):
        want = jwm.woq_matmul(to_jax(x, getattr(jnp, xdtype)), jqt.q,
                              jqt.scale, group_size=jqt.group_size,
                              bits=jqt.bits, interpret=True,
                              out_dtype=out and jnp.float32)
        got = twm.woq_matmul(to_torch(x, getattr(torch, xdtype)), tqt.q,
                             tqt.scale, group_size=tqt.group_size,
                             bits=tqt.bits, out_dtype=out and torch.float32)
        assert got.dtype == (torch.float32 if out else getattr(torch, xdtype))
        assert got.shape == (M, N)
        _close(got, want, FP32_SHARE if got.dtype == torch.float32
               else BF16_SHARE)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("M", [1, 4, 5])
@pytest.mark.parametrize("V,K,gs", [(512, 128, 128), (250, 128, 128)])
def test_woq_matmul_t_plain_matches_the_pallas_kernel(bits, xdtype, M, V, K,
                                                      gs):
    """Multi-group and G = 1 (250 rows, not divisible by 128) tables; fp16
    x (the tensor-core route's other dtype) rounds the dequantized table
    to fp16 on both sides."""
    w, x = rand((V, K), seed=6, scale=0.02), rand((M, K), seed=7)
    jqt = jquantize(jnp.asarray(w), group_size=gs, bits=bits)
    tqt = tq.quantize(torch.from_numpy(w), gs, bits=bits)
    for out in (None, "float32"):
        want = jwm.woq_matmul_t(to_jax(x, getattr(jnp, xdtype)), jqt.q,
                                jqt.scale, group_size=jqt.group_size,
                                bits=jqt.bits, interpret=True,
                                out_dtype=out and jnp.float32)
        got = twm.woq_matmul_t(to_torch(x, getattr(torch, xdtype)), tqt.q,
                               tqt.scale, group_size=tqt.group_size,
                               bits=tqt.bits, out_dtype=out and torch.float32)
        assert got.shape == (M, V)
        _close(got, want, {torch.float32: FP32_SHARE,
                           torch.bfloat16: BF16_SHARE,
                           torch.float16: FP16_SHARE}[got.dtype])


@pytest.mark.parametrize("xdtype,K,V,gs,route", [
    (torch.bfloat16, 4096, 50272, 50272, "mma"),   # OPT-6.7B head: G = 1
    (torch.bfloat16, 4096, 32000, 128, "mma"),     # table_32000: G = 250
    (torch.float16, 4096, 50272, 50272, "mma"),
    (torch.bfloat16, 1600, 50257, 50257, "mma"),   # GPT-2 1.5B's table
    (torch.bfloat16, 2560, 250880, 128, "mma"),    # Bloom's table
    (torch.bfloat16, 8192, 32000, 128, "mma"),
    (torch.bfloat16, 8208, 32000, 128, "simt"),    # x beyond shared memory
    (torch.float32, 4096, 50272, 50272, "simt"),   # fp32 x
    (torch.bfloat16, 130, 2048, 128, "simt"),      # ragged K
    (torch.bfloat16, 136, 2048, 128, "simt"),
    (torch.bfloat16, 256, 1024, 8, "simt"),        # 16-row tiles span groups
    (torch.bfloat16, 256, 1024, 24, "simt"),
    (torch.bfloat16, 256, 1024, 16, "mma"),
    (torch.bfloat16, 256, 1001, 1001, "mma"),      # odd V: one group
])
def test_woq_t_route(xdtype, K, V, gs, route):
    """The fixed route of ``woq_matmul_t``: the tensor-core kernel for
    16-bit x whose rows split into 16-byte copies, 16-row tiles in one
    group."""
    assert twm.woq_t_route(xdtype, K, V, gs) == route


def test_woq_dot_modes_match_jax_dispatch():
    """``woq_dot`` / ``woq_dot_t`` in both modes against the JAX
    dispatchers (JAX's off-TPU rule keeps these leaves on its kernel)."""
    w, x = rand((256, 384), seed=8, scale=1 / 16), rand((2, 3, 256), seed=9)
    for bits in (8, 4):
        jqt = jquantize(jnp.asarray(w), group_size=128, bits=bits)
        tqt = tq.quantize(torch.from_numpy(w), 128, bits=bits)
        assert jwm.woq_matmul_eligible(256, 128, bits)
        for use_kernel in (False, True):
            want = jq.woq_dot(jnp.asarray(x), jqt, use_kernel=use_kernel)
            got = tq.woq_dot(torch.from_numpy(x), tqt, use_kernel=use_kernel)
            assert got.shape == (2, 3, 384)
            _close(got, want)
            want = jq.woq_dot_t(jnp.asarray(x[..., :128]),
                                jquantize(jnp.asarray(w[:, :128]),
                                          group_size=128, bits=bits),
                                use_kernel=use_kernel, out_dtype=jnp.float32)
            got = tq.woq_dot_t(torch.from_numpy(x[..., :128]),
                               tq.quantize(torch.from_numpy(w[:, :128]), 128,
                                           bits=bits),
                               use_kernel=use_kernel, out_dtype=torch.float32)
            assert got.dtype == torch.float32 and got.shape == (2, 3, 256)
            _close(got, want)
    dense = rand((256, 32), seed=10)
    np.testing.assert_allclose(
        tq.matmul_any(torch.from_numpy(x), torch.from_numpy(dense)).numpy(),
        x @ dense, atol=1e-5)


def test_woq_dot_where_jax_falls_back_to_dequant(monkeypatch):
    """A leaf JAX's off-TPU rule keeps off its kernel (one degraded group
    of 8200 rows: ``woq_matmul_eligible`` caps a group at 6144 rows) goes
    to the port's kernel all the same; in fp32 it still agrees with JAX's
    per-use dequant path to fp32 rounding."""
    w, x = rand((8200, 16), seed=11, scale=0.01), rand((2, 8200), seed=12)
    jqt = jquantize(jnp.asarray(w), group_size=128, bits=8)
    tqt = tq.quantize(torch.from_numpy(w), 128, 8)
    assert tqt.group_size == 8200
    assert not jwm.woq_matmul_eligible(8200, 8200, 8)
    want = jq.woq_dot(jnp.asarray(x), jqt, use_kernel=True)  # JAX: dequant
    calls = []
    plain = twm.woq_matmul_plain
    monkeypatch.setattr(twm, "woq_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = tq.woq_dot(torch.from_numpy(x), tqt, use_kernel=True)
    assert calls == [1]
    _close(got, want)


def test_woq_dot_kernel_mode_refuses_a_stacked_leaf():
    """The kernel path takes one layer's ``(K, N)`` weight: a stacked
    ``(L, K, N)`` leaf raises instead of going to the per-use dequant
    path; its layer slice goes through."""
    w, x = rand((2, 256, 128), seed=13), rand((3, 256), seed=14)
    qt = tq.quantize(torch.from_numpy(w), 128, 8)
    for dot, xs in ((tq.woq_dot, x), (tq.woq_dot_t, x[:, :128])):
        with pytest.raises(ValueError, match="woq_matmul"):
            dot(torch.from_numpy(xs), qt, use_kernel=True)
    got = tq.woq_dot(torch.from_numpy(x), qt[1], use_kernel=True)
    want = tq.woq_dot(torch.from_numpy(x), qt[1], use_kernel=False)
    _close(got, want.numpy())


# ---------------------------------------------------------------- engines
def engines(name, bits, woq_kernel):
    conf = {"dtype": "float32", "quantize": True, "quant_bits": bits,
            "quant_group_size": GROUP[name], "woq_kernel": woq_kernel}
    jm, jparams, tm, tparams = make_pair(name)
    je = jds.init_inference(jm, jparams, conf)
    te = dt.init_inference(tm, tparams, conf, device="cpu")
    return je, te


def prompts(cfg, B=2, S=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def decode_logits(je, te, ids, step):
    """fp32 logits of one decode step after a dense prefill, both
    packages, the weights read quantized."""
    B, S = ids.shape
    jc = jax_decode.init_cache(je.model.cfg, B, S + 4, jnp.float32)
    _, jc = jax_decode.forward_with_cache(je.model, je._materialized(je.params),
                                          jnp.asarray(ids), jc)
    jl, _ = jax_decode.forward_with_cache(je.model, je.params,
                                          jnp.asarray(step), jc)
    tc = decode.init_cache(te.model.cfg, B, S + 4, torch.float32)
    with torch.no_grad():
        _, tc = decode.forward_with_cache(
            te.model, te.params, torch.as_tensor(ids, dtype=torch.long), tc,
            materialize=te.materialize)
        tl, _ = decode.forward_with_cache(
            te.model, te.params, torch.tensor(step, dtype=torch.long), tc)
    return tl.numpy(), np.asarray(jl)


@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny", "opt_tiny"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("woq_kernel", [True, False])
def test_woq_engine_matches_jax_engine(name, bits, woq_kernel):
    je, te = engines(name, bits, woq_kernel)
    assert te.model.woq_kernel is woq_kernel
    assert tq.quantized_bytes(te.params) == jq.quantized_bytes(je.params)
    assert_bytes_equal(te.params["layers.wqkv"], je.params["layers"]["wqkv"])
    ids = prompts(te.model.cfg)
    want = np.asarray(je.generate(ids, 8, greedy=True))
    np.testing.assert_array_equal(te.generate(ids, 8, greedy=True).numpy(),
                                  want)
    got, ref = decode_logits(je, te, ids, want[:, :1])
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)


def test_params_from_jax_takes_a_quantized_engine_tree():
    """The JAX engine's quantized serving tree (fused wqkv) converts to
    the port's QuantizedTensors byte for byte and serves the same tokens."""
    je, te = engines("tiny_test", 8, False)
    tree = jax.tree.map(np.asarray, je.params)
    sd = params_from_jax(tree, te.model.cfg)
    assert isinstance(sd["layers.wq"], tq.QuantizedTensor)
    fused = tq.QuantizedTensor.cat_columns(
        [sd["layers.wq"], sd["layers.wk"], sd["layers.wv"]])
    assert_bytes_equal(fused, je.params["layers"]["wqkv"])
    conv = dt.init_inference(te.model, sd, {
        "dtype": "float32", "quantize": True, "quant_group_size": 32,
        "woq_kernel": False}, device="cpu")
    assert_bytes_equal(conv.params["layers.wqkv"], je.params["layers"]["wqkv"])
    ids = prompts(te.model.cfg)
    np.testing.assert_array_equal(
        conv.generate(ids, 6, greedy=True).numpy(),
        np.asarray(je.generate(ids, 6, greedy=True)))
    with pytest.raises(ValueError, match="quantize"):
        dt.init_inference(te.model, sd, {"dtype": "float32"}, device="cpu")


def test_woq_forward_matches_jax_and_chunked_generate():
    """``forward`` runs on dequantized weights as JAX's does; the chunked
    decode path serves the same tokens."""
    je, te = engines("opt_tiny", 4, True)
    ids = prompts(te.model.cfg)
    np.testing.assert_allclose(te.forward(ids).numpy(),
                               np.asarray(je.forward(ids)), atol=LOGIT_ATOL,
                               rtol=0)
    te.config.decode_chunk = 3
    np.testing.assert_array_equal(te.generate(ids, 7, greedy=True).numpy(),
                                  np.asarray(je.generate(ids, 7, greedy=True)))


def test_woq_kernel_on_cpu_runs_the_plain_versions(monkeypatch):
    """woq_kernel on the CPU: every quantized projection of a decode step
    and the tied head go through the wrappers' plain versions; the CUDA
    launch counters stay 0; the prefill reads dense weights."""
    calls = {"mm": 0, "mmt": 0}
    mm, mmt = twm.woq_matmul_plain, twm.woq_matmul_t_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(twm, "woq_matmul_plain", count("mm", mm))
    monkeypatch.setattr(twm, "woq_matmul_t_plain", count("mmt", mmt))
    _, te = engines("opt_tiny", 8, True)
    before = (twm.woq_matmul.launches, twm.woq_matmul_t.launches)
    te.generate(prompts(te.model.cfg), 5, greedy=True)
    L = te.model.cfg.n_layer
    assert calls == {"mm": 4 * L * 4, "mmt": 4}
    assert (twm.woq_matmul.launches, twm.woq_matmul_t.launches) == before


def test_dequant_per_step_is_accepted_and_changes_nothing():
    _, _, tm, tp = make_pair("tiny_test")
    conf = {"dtype": "float32", "quantize": True, "quant_group_size": 32}
    a = dt.init_inference(tm, tp, conf, device="cpu")
    b = dt.init_inference(tm, tp, {**conf, "dequant_per_step": True},
                          device="cpu")
    assert b.model.woq_kernel is False        # auto: off on the CPU
    ids = prompts(tm.cfg)
    assert torch.equal(a.generate(ids, 4, greedy=True),
                       b.generate(ids, 4, greedy=True))
