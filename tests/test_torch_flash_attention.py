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
from torch_one_thread import one_torch_thread  # noqa: F401

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
    # the head dims of the wgmma forward on the card, whose oracle there is
    # this plain path
    "hd32_mask_alibi": (2, 48, 4, 4, 32, True, "left_pad", True, 16),
    "hd64_causal": (2, 64, 2, 2, 64, True, None, False, 16),
    "hd128_full_gqa": (1, 32, 4, 2, 128, False, None, False, 16),
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
    """The factory's function takes the bias (``accepts_bias``) and computes
    with it; what no bias layout of the JAX function takes raises: an odd
    bias shape, a bias beside ALiBi slopes, dbias of a broadcast bias."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
    fn = tfa.make_flash_attention()
    assert fn.accepts_bias and fn.bias_is_constant and fn.accepts_alibi_slopes
    got = fn(q, q, q, bias=bias)
    assert torch.equal(got, tfa.flash_attention(q, q, q, bias=bias))
    assert not torch.allclose(got, fn(q, q, q))
    for shape in ((8, 9), (3, 8, 8), (2, 2, 8, 8), (8,), (1, 1, 1, 8, 8)):
        with pytest.raises(ValueError, match="bias must be"):
            fn(q, q, q, bias=torch.zeros(shape))
    with pytest.raises(ValueError, match="not both"):
        tfa.flash_attention(q, q, q, bias=bias, alibi_slopes=torch.ones(2))
    o, lse = tfa.flash_fwd(q, q, q, bias=bias)
    delta = tfa.attention_delta(o, q)
    with pytest.raises(ValueError, match=r"full \(B, H, S, S\)"):
        tfa.flash_bwd_dq(q, q, q, q, lse, delta, bias=bias[0],
                         grad_bias=True)


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


# ------------------------------------------------------------ routing
# which library's kernel serves flash_fwd on the card, by (q's dtype, hd)
FWD_ROUTES = {
    **{(d, hd): "flash_fwd_sm90" for d in (torch.bfloat16, torch.float16)
       for hd in (32, 64, 128)},
    (torch.bfloat16, 16): "flash_attention",
    (torch.float16, 16): "flash_attention",
    (torch.float32, 16): "flash_attention_f32",
    **{(torch.float32, hd): "flash_fwd_f32_sm90" for hd in (32, 64, 128)},
}


@pytest.mark.parametrize("route", list(FWD_ROUTES),
                         ids=lambda r: f"{str(r[0])[6:]}-hd{r[1]}")
def test_forward_routes_by_dtype_and_head_dim(route):
    """16-bit operands at hd 32-128 take the wgmma / TMA forward, fp32 at
    hd 32-128 its 3xTF32 twin; hd 16 stays on the mma.sync kernels; fixed,
    no fallback."""
    assert tfa.library("flash_fwd", *route) == FWD_ROUTES[route]


def test_forward_table_covers_what_the_wrapper_takes():
    """Every (dtype, head dim) the wrapper accepts routes to a source the
    builder compiles, and only the mma.sync sources export the backward
    kernels: each wgmma forward source exports the forward alone, the fp32
    one over the fp32 pieces of ``tf32_sm90.cuh``."""
    from deepspeed_tpu_torch.ops import builder

    taken = {(d, hd) for d in (torch.bfloat16, torch.float16, torch.float32)
             for hd in tfa.KERNEL_HEAD_DIMS}
    assert set(FWD_ROUTES) == taken
    names = {tfa.library("flash_fwd", *r) for r in taken}
    assert names == {"flash_fwd_sm90", "flash_fwd_f32_sm90",
                     "flash_attention", "flash_attention_f32"}
    assert names <= set(builder.sources())
    text = {n: (builder.CSRC / f"{n}.cu").read_text() for n in names}
    for wgmma in ("flash_fwd_sm90", "flash_fwd_f32_sm90"):
        assert 'extern "C" int dstpu_flash_fwd(' in text[wgmma]
        assert "dstpu_flash_bwd" not in text[wgmma]
    assert '#include "tf32_sm90.cuh"' in text["flash_fwd_f32_sm90"]
    cuh = (builder.CSRC / "flash_attention.cuh").read_text()
    assert '#include "flash_attention.cuh"' in text["flash_attention"]
    assert 'extern "C" int dstpu_flash_bwd_dq(' in cuh


# the three regions of (q's dtype, hd) the backward wrappers accept, and
# the library each takes, by kernel
_BWD = ("flash_bwd_dq", "flash_bwd_dkv")
BWD_REGIONS = {
    "wgmma": ([(d, hd) for d in (torch.bfloat16, torch.float16)
               for hd in (32, 64, 128)], "{}_sm90"),
    "half_hd16": ([(torch.bfloat16, 16), (torch.float16, 16)],
                  "flash_attention"),
    "fp32": ([(torch.float32, hd) for hd in (16, 128)],
             "flash_attention_f32"),
    "fp32_wgmma": ([(torch.float32, hd) for hd in (32, 64)],
                   "{}_f32_sm90"),
}


@pytest.mark.parametrize("region", list(BWD_REGIONS))
@pytest.mark.parametrize("kernel", _BWD)
def test_backward_routes_by_kernel_dtype_and_head_dim(kernel, region):
    """16-bit operands at hd 32-128 take the wgmma / TMA dq and dk/dv
    kernels, one library each, and fp32 at hd 32 and 64 their 3xTF32
    twins; hd 16 and fp32 at hd 16 and 128 stay on the mma.sync kernels;
    fixed, no fallback."""
    pairs, name = BWD_REGIONS[region]
    for dtype, hd in pairs:
        assert tfa.library(kernel, dtype, hd) == name.format(kernel)


def test_backward_table_covers_what_the_wrappers_take():
    """The regions cover exactly what the backward wrappers accept, each
    route a source ``ops/builder.py`` compiles; each wgmma source (16-bit
    and fp32) exports only its own kernel, and the mma.sync build leaves
    them their regions: the backward at 16-bit hd 32-128 and fp32 hd 32
    and 64."""
    from deepspeed_tpu_torch.ops import builder

    pairs = [p for region, _ in BWD_REGIONS.values() for p in region]
    assert sorted(pairs, key=str) == sorted(
        ((d, hd) for d in (torch.bfloat16, torch.float16, torch.float32)
         for hd in tfa.KERNEL_HEAD_DIMS), key=str)
    for k in _BWD:
        assert {tfa.library(k, *p) for p in pairs} <= set(builder.sources())
        other, = set(_BWD) - {k}
        for src, header in ((f"{k}_sm90", "flash_bwd_sm90.cuh"),
                            (f"{k}_f32_sm90", "flash_bwd_f32_sm90.cuh")):
            text = (builder.CSRC / f"{src}.cu").read_text()
            assert f'#include "{header}"' in text
            assert f'extern "C" int dstpu_{k}(' in text
            assert f"dstpu_{other}(" not in text
    cuh = (builder.CSRC / "flash_attention.cuh").read_text()
    assert "if constexpr (!here<T, HD, true>())" in cuh
    assert "if constexpr (!here<T, HD, false>())" in cuh
    assert ("return HD == 16 || (std::is_same_v<T, float> && BWD && "
            "HD == 128);") in cuh
    assert tuple(hd for hd in tfa.KERNEL_HEAD_DIMS if tfa.library(
        "flash_bwd_dq", torch.float32, hd) != "flash_attention_f32") \
        == tfa.F32_WGMMA_HEAD_DIMS


# the shared memory a block of the card may take: 227 KiB
SMEM_LIMIT = 232448


@pytest.mark.parametrize("hd", tfa.F32_WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("kernel", _BWD)
def test_f32_plan_fits_and_matches_the_header(kernel, hd):
    """``flash_bwd_f32_plan`` fits a block's 227 KiB at every routed head
    dim, and its rows, stages and shared memory are the ones the header's
    constants give (read from the source: the card's library reports the
    same bytes in the gpu tests)."""
    import re

    from deepspeed_tpu_torch.ops import builder

    plan = tfa.flash_bwd_f32_plan(kernel, hd)
    assert plan["smem_bytes"] <= SMEM_LIMIT
    # the pair's own ring depths, and the geometry it shares with the fp32
    # forward
    cuh = "".join((builder.CSRC / n).read_text()
                  for n in ("flash_bwd_f32_sm90.cuh", "tf32_sm90.cuh"))
    const = lambda n: int(re.search(  # noqa: E731
        rf"constexpr int {n} = (\d+);", cuh).group(1))
    assert (plan["unit"], plan["step"]) == (const("kFUnit"), const("kFStep"))
    name = "kDqF32Stages" if kernel == "flash_bwd_dq" else "kDkvF32Stages"
    at32, other = re.search(
        rf"constexpr int {name} = HD == 32 \? (\d+) : (\d+);", cuh).groups()
    assert plan["stages"] == int(at32 if hd == 32 else other)
    assert plan["t_stages"] == const("kF32TStages")
    unit, step = plan["unit"] * hd * 4, plan["step"] * hd * 4
    t_tiles, rows = (2, 0) if kernel == "flash_bwd_dq" else (4, 2 * 32 * 4)
    ns, nt = plan["stages"], plan["t_stages"]
    assert plan["smem_bytes"] == 1024 + 4 * unit + ns * (4 * step + rows) \
        + nt * t_tiles * step + 8 * (3 + 3 * ns + 2 * nt)
    fn = "dq_f32_smem_bytes" if kernel == "flash_bwd_dq" \
        else "dkv_f32_smem_bytes"
    assert f"constexpr int {fn}()" in cuh
    with pytest.raises(ValueError, match="no fp32 wgmma"):
        tfa.flash_bwd_f32_plan(kernel, 128)


@pytest.mark.parametrize("hd", tfa.F32_FWD_WGMMA_HEAD_DIMS)
def test_f32_fwd_plan_fits_and_matches_the_header(hd):
    """``flash_fwd_f32_plan`` fits a block's 227 KiB at every routed head
    dim (hd 128 with two slots of each ring), and its rows, stages and
    shared memory are the ones the source's constants give (read from the
    source: the card's library reports the same bytes in the gpu tests
    and in chip_smoke.py's phase 1)."""
    import re

    from deepspeed_tpu_torch.ops import builder

    plan = tfa.flash_fwd_f32_plan(hd)
    assert plan["smem_bytes"] <= SMEM_LIMIT
    src = "".join((builder.CSRC / n).read_text()
                  for n in ("flash_fwd_f32_sm90.cu", "tf32_sm90.cuh"))
    const = lambda n: int(re.search(  # noqa: E731
        rf"constexpr int {n} = (\d+);", src).group(1))
    assert (plan["unit"], plan["step"]) == (const("kFUnit"), const("kFStep"))
    assert plan["t_stages"] == const("kF32TStages")
    at32, at64, other = re.search(
        r"constexpr int kFwdF32Stages = HD == 32 \? (\d+) : HD == 64 \? "
        r"(\d+) : (\d+);", src).groups()
    assert plan["stages"] == int({32: at32, 64: at64}.get(hd, other))
    unit, step = plan["unit"] * hd * 4, plan["step"] * hd * 4
    ns, nt = plan["stages"], plan["t_stages"]
    assert ns >= 2 and nt >= 2
    assert plan["smem_bytes"] == 1024 + 2 * unit + ns * 3 * step \
        + nt * 2 * step + 8 * (3 + 3 * ns + 2 * nt)
    assert "constexpr int fwd_f32_smem_bytes()" in src
    with pytest.raises(ValueError, match="no fp32 wgmma"):
        tfa.flash_fwd_f32_plan(16)


def _tf32(x, rounded):
    """fp32 ``x`` with its low 13 mantissa bits cleared (a tf32 value),
    truncated or rounded to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` does (1 << 12 added to the magnitude bits)."""
    bits = x.view(torch.int32)
    if rounded:
        bits = bits + 4096
    return (bits & -8192).view(torch.float32)


@pytest.mark.parametrize("rounded", [False, True],
                         ids=["truncated_hi", "rounded_hi"])
@pytest.mark.parametrize("m,k,n", [(256, 64, 256), (256, 1024, 64)])
def test_3xtf32_emulation_keeps_fp32_accuracy(m, k, n, rounded):
    """Why the fp32 kernels' 1e-4 gate holds and one tf32 product would
    not: with x = hi + lo, both tf32, hi.hi + hi.lo + lo.hi (each tf32
    product exact, summed in fp64, rounded to fp32 once) is within 2e-6 of
    the fp64 product as a share of its max |value|, a single hi.hi product
    at least 1e-4 away. The kernels' split is the truncated one: the
    tensor cores read a raw fp32 value as its truncated high part and the
    exact remainder as its truncated low part (~4x the rounded split's
    error, well inside the gate)."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    want = a.double() @ b.double()

    def parts(x):
        hi = _tf32(x, rounded)
        return hi.double(), _tf32(x - hi, rounded).double()

    (ah, al), (bh, bl) = parts(a), parts(b)
    three = (al @ bh + ah @ bl + ah @ bh).float().double()
    one = (ah @ bh).float().double()
    top = want.abs().max().item()
    err3 = (three - want).abs().max().item() / top
    err1 = (one - want).abs().max().item() / top
    assert err3 <= 2e-6, err3
    assert err1 >= 1e-4, err1


def test_profile_names_cover_the_wgmma_kernels():
    """chip_smoke.py reads each flash kernel's share of a profile under its
    mma.sync and its wgmma kernels' names (the fp32 ones too), and each
    sparse kernel's under both of its kernels' names; each name is a
    kernel of a source, so a share cannot read 0 for want of a name."""
    import importlib.util
    import re
    from pathlib import Path

    from deepspeed_tpu_torch.ops import builder

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fns = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    names = smoke.kernel_names(fns)
    assert names == tuple(n for f in fns for n in (
        f"{f.__name__}_kernel", f"{f.__name__}_sm90_kernel",
        f"{f.__name__}_f32_sm90_kernel"))
    # each sparse kernel's wgmma kernel beside its mma.sync one
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    sparse = (tsa.sparse_fwd, tsa.sparse_bwd_dq, tsa.sparse_bwd_dkv)
    assert smoke.kernel_names(sparse) == (
        "sparse_fwd_kernel", "sparse_fwd_sm90_kernel",
        "sparse_bwd_dq_kernel", "sparse_bwd_dq_sm90_kernel",
        "sparse_bwd_dkv_kernel", "sparse_bwd_dkv_sm90_kernel")
    names = names + smoke.kernel_names(sparse)
    text = "".join(p.read_text() for p in builder.CSRC.glob("*.cu*"))
    for n in names:
        assert re.search(rf"__global__[^;{{]*\b{n}\(", text), n


# ------------------------------------------------------------ bias operand
# The bias cases of tests/unit/test_flash_attention.py:158-258: the JAX
# kernels in interpret mode against the port's plain path on the same
# numpy inputs, fp32, at that file's tolerances (rtol = atol): 3e-5 for
# the forward, 1e-4 for the grads (both sides fp32; the kernels stream
# 16-key blocks, the plain path takes one softmax over all keys).
def _biased_inputs(B, S, H, hd, bias_shape, seed):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    bias = np.random.default_rng(seed).standard_normal(bias_shape)
    return q, k, v, bias.astype(np.float32)


def _jax_biased(q, k, v, bias, *, causal=True, mask=None, const=False,
                wrt_bias=True):
    """o and the grads of sum(o²) (q, k, v and, with ``wrt_bias``, bias)
    of the JAX flash_attention in interpret mode."""
    mask = None if mask is None else jnp.asarray(mask)

    def f(qq, kk, vv, bb):
        return jfa.flash_attention(qq, kk, vv, bias=bb, mask=mask,
                                   causal=causal, bias_is_constant=const,
                                   block=16, interpret=True)

    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    o = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(jnp.square(f(*a))),
                     argnums=(0, 1, 2, 3) if wrt_bias else (0, 1, 2))(*args)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *grads)]


def _torch_biased(q, k, v, bias, *, causal=True, mask=None, const=False,
                  bias_dtype=torch.float32):
    """The port's o and its grads of sum(o²): q, k, v, then the bias's
    (None when no gradient reaches it)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    bt = torch.from_numpy(bias).to(bias_dtype).requires_grad_()
    mt = None if mask is None else torch.from_numpy(mask)
    o = tfa.flash_attention(qt, kt, vt, bias=bt, mask=mt, causal=causal,
                            bias_is_constant=const)
    o.square().sum().backward()
    return [t if t is None else t.detach().float().numpy()
            for t in (o, qt.grad, kt.grad, vt.grad, bt.grad)]


BIAS_LAYOUTS = {"hss": lambda B, H, S: (H, S, S),
                "bhss": lambda B, H, S: (B, H, S, S),
                "b1ss": lambda B, H, S: (B, 1, S, S),
                "ss": lambda B, H, S: (S, S)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", list(BIAS_LAYOUTS))
def test_biased_forward_matches_jax(layout, causal):
    B, S, H, hd = 2, 64, 4, 32
    q, k, v, bias = _biased_inputs(B, S, H, hd,
                                   BIAS_LAYOUTS[layout](B, H, S), 7)
    want = _jax_biased(q, k, v, bias, causal=causal)[0]
    got = tfa.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                        bias=torch.from_numpy(bias), causal=causal)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_biased_forward_with_mask_matches_jax():
    B, S, H, hd = 2, 32, 4, 32
    q, k, v, bias = _biased_inputs(B, S, H, hd, (H, S, S), 3)
    mask = np.ones((B, S), np.float32)
    mask[:, 24:] = 0.0
    want = _jax_biased(q, k, v, bias, mask=mask)
    got = _torch_biased(q, k, v, bias, mask=mask)
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_full_shape_bias_grads_match_jax(causal):
    """dq, dk, dv and the in-kernel dbias of a full (B, H, S, S) bias."""
    B, S, H, hd = 2, 32, 2, 16
    q, k, v, bias = _biased_inputs(B, S, H, hd, (B, H, S, S), 5)
    want = _jax_biased(q, k, v, bias, causal=causal)
    got = _torch_biased(q, k, v, bias, causal=causal)
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if causal:                    # hidden by the causal cut: exactly 0
        assert np.all(np.triu(got[4], 1) == 0)


@pytest.mark.parametrize("const", [False, True])
def test_broadcast_bias_grads_match_jax(const):
    """An (H, S, S) bias: q/k/v grads in both modes; a learned one gets the
    summed cotangent (JAX broadcasts it outside its kernel, the port reads
    a stride-0 view), a constant one none (JAX's zero)."""
    B, S, H, hd = 2, 32, 4, 16
    q, k, v, bias = _biased_inputs(B, S, H, hd, (H, S, S), 9)
    want = _jax_biased(q, k, v, bias, causal=True, const=const)
    got = _torch_biased(q, k, v, bias, causal=True, const=const)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if const:
        assert got[4] is None and np.all(want[4] == 0)
    else:
        assert got[4].shape == (H, S, S)
        np.testing.assert_allclose(got[4], want[4], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bias_dtype,q_dtype", [("bfloat16", "float32"),
                                                ("float32", "bfloat16")])
def test_bias_dtype_independent_of_q(bias_dtype, q_dtype):
    """The bias is upcast to fp32 inside the scores whatever q's dtype, and
    dbias comes out in the bias's dtype. Both sides see the same rounded
    values. Everything is held at this file's tolerance for q's dtype
    (with bf16 q, o and dO = 2o round to bf16 on each side, and ds with
    them), and a bf16 dbias of fp32 q within one bf16 rounding (2^-8) of
    the JAX kernel's."""
    B, S, H, hd = 2, 32, 2, 16
    q, k, v, bias = _biased_inputs(B, S, H, hd, (B, H, S, S), 11)
    def rnd(a, dt):               # the values dt holds, as fp32
        return np.array(jnp.asarray(a, dt).astype(jnp.float32))

    q, k, v = (rnd(a, q_dtype) for a in (q, k, v))
    bias = rnd(bias, bias_dtype)
    jq, jk, jv = (jnp.asarray(a, q_dtype) for a in (q, k, v))
    jb = jnp.asarray(bias, bias_dtype)

    def f(qq, kk, vv, bb):
        return jfa.flash_attention(qq, kk, vv, bias=bb, block=16,
                                   interpret=True)

    loss = lambda *a: jnp.sum(jnp.square(f(*a).astype(jnp.float32)))  # noqa
    want = [f(jq, jk, jv, jb),
            *jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jb)]
    assert want[4].dtype == jnp.dtype(bias_dtype)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, q_dtype))
                  .requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).to(getattr(torch, bias_dtype)) \
        .requires_grad_()
    o = tfa.flash_attention(tq, tk, tv, bias=tb)
    o.float().square().sum().backward()
    got = (o, tq.grad, tk.grad, tv.grad, tb.grad)
    assert tb.grad.dtype == getattr(torch, bias_dtype)
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        g, w = g.detach().float().numpy(), np.asarray(w.astype(jnp.float32))
        share = np.abs(g - w).max() / np.abs(w).max()
        tol = 2.0 ** -8 if name == "dbias" and bias_dtype == "bfloat16" \
            else TOL[q_dtype]
        assert share <= tol, (name, share)


def test_plain_dbias_zero_where_hidden():
    """The plain dq with ``grad_bias``: dbias = ds in the bias's dtype,
    exactly 0 above the causal diagonal and on padded keys, and the same
    function the autograd path's dbias is."""
    B, S, H, hd = 2, 24, 2, 16
    q, k, v, bias = (torch.from_numpy(a) for a in
                     _biased_inputs(B, S, H, hd, (B, H, S, S), 13))
    mask = torch.ones(B, S)
    mask[1, -4:] = 0
    do = torch.randn(B, S, H, hd, generator=torch.Generator().manual_seed(0))
    bias16 = bias.half()
    o, lse = tfa.flash_fwd(q, k, v, bias=bias16, mask=mask)
    delta = tfa.attention_delta(o, do)
    dq, dbias = tfa.flash_bwd_dq(q, k, v, do, lse, delta, bias=bias16,
                                 mask=mask, grad_bias=True)
    assert dbias.dtype == torch.float16 and dbias.shape == (B, H, S, S)
    assert torch.all(dbias.float().triu(1) == 0)
    assert torch.all(dbias[1, :, :, -4:] == 0)
    assert torch.equal(dq, tfa.flash_bwd_dq(q, k, v, do, lse, delta,
                                            bias=bias16, mask=mask))
    *_, want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, mask=mask,
                                             bias=bias16, grad_bias=True)
    assert torch.equal(dbias, want)
