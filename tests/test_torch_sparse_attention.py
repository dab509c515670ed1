"""deepspeed_tpu_torch block-sparse attention vs the JAX package's.

The same numpy inputs (seeded) go through the JAX ``sparse_attention`` with
its Pallas kernels in interpret mode and through the port's, which takes its
plain PyTorch versions on the CPU. Everything is fp32.

Tolerances:
- layouts and CSR lists: equal, element for element;
- o: 3e-5 (rtol and atol, as the JAX package's own test holds its kernels
  against a dense reference); the JAX kernels stream one block of keys at a
  time with an online softmax, the port's plain version takes one softmax
  over all keys, so sums run in another order;
- lse: 3e-5 against ``_fwd_call``'s row 0 (the same sums);
- dq, dk, dv: 5e-5 (rtol and atol, the JAX test's tolerance for its grads);
- the slice, 4 training steps: losses and master params within 1e-5
  relative (in norm per leaf, ``layers.bk`` left out), as
  ``tests/test_torch_train.py`` holds the flash slice.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu.runtime.dataloader import random_token_dataset
from deepspeed_tpu_torch.models import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from torch_one_thread import one_torch_thread  # noqa: F401


def config_pair(name, **kw):
    """The same config in both packages."""
    return getattr(jsa, name)(**kw), getattr(tsa, name)(**kw)


# name: (config class, fields); the defaults of each, then small blocks
CONFIGS = {
    "dense": ("SparsityConfig", dict(block=16)),
    "fixed": ("FixedSparsityConfig", dict(block=16, num_local_blocks=2,
                                          num_global_blocks=1)),
    "fixed_default": ("FixedSparsityConfig", {}),
    "fixed_2_global": ("FixedSparsityConfig", dict(num_local_blocks=4,
                                                   num_global_blocks=2)),
    "variable": ("VariableSparsityConfig", dict(
        block=16, local_window_blocks=(1, 2), global_block_indices=(0,))),
    "variable_default": ("VariableSparsityConfig", {}),
    "bigbird": ("BigBirdSparsityConfig", dict(
        block=16, num_random_blocks=1, num_sliding_window_blocks=3,
        num_global_blocks=1)),
    "bigbird_seed_7": ("BigBirdSparsityConfig", dict(num_random_blocks=2,
                                                     seed=7)),
    "longformer": ("BSLongformerSparsityConfig", dict(
        block=16, num_sliding_window_blocks=3)),
    "longformer_last_global": ("BSLongformerSparsityConfig", dict(
        block=16, num_sliding_window_blocks=1, global_block_indices=(3,))),
}


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_layouts_and_lists_equal_jax(name, causal):
    jc, tc = config_pair(CONFIGS[name][0], **CONFIGS[name][1])
    assert tc.block == jc.block
    for n in range(1, 13):
        lay = tc.make_layout(n)
        np.testing.assert_array_equal(lay, jc.make_layout(n))
        try:
            want = jsa._layout_lists(jc.make_layout(n), causal)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tsa._layout_lists(lay, causal)
            continue
        got = tsa._layout_lists(lay, causal)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_empty_row_error_equals_jax():
    lay = np.array([[False, True], [True, True]])
    with pytest.raises(ValueError) as want:
        jsa._layout_lists(lay, True)
    with pytest.raises(ValueError) as got:
        tsa._layout_lists(lay, True)
    assert str(got.value) == str(want.value)
    assert "[0]" in str(got.value)


def test_layout_is_built_once_per_config_seq_causal_device():
    cfg = tsa.FixedSparsityConfig(block=16, num_local_blocks=2)
    a = tsa.sparse_layout(cfg, 64, True, "cpu")
    assert tsa.sparse_layout(tsa.FixedSparsityConfig(
        block=16, num_local_blocks=2), 64, True, "cpu") is a
    assert tsa.sparse_layout(cfg, 64, False, "cpu") is not a
    assert tsa.sparse_layout(cfg, 128, True, "cpu") is not a
    assert a.seq == 64 and a.k_idx.dtype == torch.int32
    # widest lists first; kept elements counted with the diagonal triangle
    assert (a.k_n[a.q_order.long()].diff() <= 0).all()
    assert (a.q_n[a.k_order.long()].diff() <= 0).all()
    keep = (a.keep("cpu") & torch.ones(64, 64, dtype=torch.bool).tril())
    assert a.kept_elements() == int(keep.sum())


# ------------------------------------------------------------------ kernels
def qkv(B=2, S=64, H=2, KV=None, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    KV = KV or H
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


def jax_side(jc, causal, q, k, v, w):
    def f(q, k, v):
        return jsa.sparse_attention(q, k, v, jc, causal=causal, interpret=True)

    def loss(q, k, v):
        return jnp.sum(f(q, k, v) * w)

    args = [jnp.asarray(a) for a in (q, k, v)]
    o = f(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a) for a in (o, *grads)]


def jax_lse(jc, causal, q, k, v):
    H, KV = q.shape[2], k.shape[2]
    k, v = (np.repeat(a, H // KV, axis=2) for a in (k, v))
    S = q.shape[1]
    lists = jsa._layout_lists(jc.make_layout(S // jc.block), causal)
    _, lse = jsa._fwd_call(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
                           lists[0], lists[1], block=jc.block, causal=causal,
                           interpret=True)
    return np.asarray(lse)[:, :, 0, :]


def torch_side(tc, causal, q, k, v, w):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tsa.sparse_attention(q, k, v, tc, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


KERNEL_CONFIGS = ["dense", "fixed", "variable", "bigbird", "longformer",
                  "longformer_last_global"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_output_and_lse_match_jax(name, causal):
    jc, tc = config_pair(CONFIGS[name][0], **CONFIGS[name][1])
    q, k, v, w = qkv()
    want = jax_side(jc, causal, q, k, v, w)[0]
    got = torch_side(tc, causal, q, k, v, w)[0]
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    layout = tsa.sparse_layout(tc, q.shape[1], causal, "cpu")
    _, lse = tsa.sparse_fwd(*(torch.from_numpy(a) for a in (q, k, v)), layout)
    np.testing.assert_allclose(lse.numpy(), jax_lse(jc, causal, q, k, v),
                               rtol=3e-5, atol=3e-5)


# (config, causal, H, KV, S): every config's grads, GQA and MQA (the JAX
# package repeats K/V and sums its grads through the repeat; the port sums
# each group in the dk/dv plain version and in the kernel)
GRAD_CASES = [("fixed", True, 2, 2, 64), ("fixed", False, 2, 2, 64),
              ("variable", True, 4, 2, 64), ("bigbird", False, 4, 2, 64),
              ("longformer", True, 2, 1, 48), ("dense", True, 2, 1, 48),
              ("longformer_last_global", False, 2, 2, 64)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_grads_match_jax(case):
    name, causal, H, KV, S = case
    jc, tc = config_pair(CONFIGS[name][0], **CONFIGS[name][1])
    q, k, v, w = qkv(S=S, H=H, KV=KV, seed=1)
    want = jax_side(jc, causal, q, k, v, w)
    got = torch_side(tc, causal, q, k, v, w)
    for n, g, x in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == x.shape, n
        np.testing.assert_allclose(g, x, rtol=5e-5, atol=5e-5, err_msg=n)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_float64(causal):
    """The Function's backward (dq, then dk/dv from delta) is the gradient
    of its forward: finite differences in float64 at a tiny size, GQA."""
    cfg = tsa.FixedSparsityConfig(block=2, num_local_blocks=2)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 4))).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, 8, 1, 4)))
            .requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tsa.sparse_attention(q, k, v, cfg, causal=causal),
        (q, k, v))


# ------------------------------------------------------------------ errors
def test_errors_match_jax():
    jc, tc = config_pair("FixedSparsityConfig", block=16)
    q, k, v, _ = qkv(S=40)
    with pytest.raises(ValueError) as want:
        jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)), jc,
                             interpret=True)
    with pytest.raises(ValueError) as got:
        tsa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)), tc)
    assert str(got.value) == str(want.value) == \
        "seq 40 not divisible by sparsity block 16"

    q, k, v, _ = qkv(S=32)
    mask = np.ones((2, 32), np.int32)
    with pytest.raises(ValueError) as want:
        jsa.make_sparse_attention_fn(jc, interpret=True)(
            *(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask))
    with pytest.raises(ValueError) as got:
        tsa.make_sparse_attention_fn(tc)(
            *(torch.from_numpy(a) for a in (q, k, v)),
            mask=torch.from_numpy(mask))
    assert str(got.value) == str(want.value)

    # the model refuses the function where JAX's does: ALiBi and encoders
    for preset, phrase in (("bloom", "alibi needs an additive score bias; "
                                     "this attention_fn accepts neither"),
                           ("bert", "encoder (causal=False) configs require "
                                    "the default attention")):
        with pytest.raises(ValueError) as want:
            jax_build(getattr(jax_presets, preset)("tiny"),
                      attention_fn=jsa.make_sparse_attention_fn(jc))
        with pytest.raises(ValueError) as got:
            dt.build_model(getattr(torch_presets, preset)("tiny"),
                           attention_fn=tsa.make_sparse_attention_fn(tc))
        assert str(want.value).startswith(phrase)
        assert str(got.value).startswith(phrase)


def test_fn_carries_no_capability_flag():
    fn = tsa.make_sparse_attention_fn(tsa.FixedSparsityConfig())
    for flag in ("accepts_bias", "accepts_alibi_slopes", "causal"):
        assert not hasattr(fn, flag)


# which library's kernel serves each sparse launch on the card, by (block,
# hd): the wgmma kernels at blocks 64 and 128, hd 32-128, mma.sync else
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("block", tsa.KERNEL_BLOCKS)
def test_routes_by_block_and_head_dim(block, hd):
    """Fixed, no fallback: the forward and the backward pair move to their
    wgmma libraries together, and each route is a source
    ``ops/builder.py`` compiles that exports the kernel's function (each
    wgmma source its own kernel's alone)."""
    from deepspeed_tpu_torch.ops import builder

    wgmma = block in (64, 128) and hd in (32, 64, 128)
    kernels = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
    for kernel in kernels:
        assert tsa.library(kernel, block, hd) == (
            f"{kernel}_sm90" if wgmma else "sparse_attention")
        name = tsa.library(kernel, block, hd)
        assert name in builder.sources()
        text = (builder.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int dstpu_{kernel}(' in text
        text = (builder.CSRC / f"{kernel}_sm90.cu").read_text()
        for other in set(kernels) - {kernel}:
            assert f"dstpu_{other}(" not in text
    with pytest.raises(ValueError, match="no sparse kernel"):
        tsa.library("sparse_bwd", block, hd)
    text = (builder.CSRC / "sparse_fwd_sm90.cu").read_text()
    if wgmma:
        plan = tsa.sparse_fwd_plan(hd)
        assert plan["smem_bytes"] <= 232448
        # the source's constants: 64-row units and chunks, two pipelines,
        # tiles of two chunks but at hd 128, 4 stages at hd 32 and 3 above
        assert "constexpr int kSRows = 64;" in text
        assert "constexpr int kPipes = 2;" in text
        assert "kSKeys = HD == 128 ? 64 : 128;" in text
        assert "kSparseStages = HD == 32 ? 4 : 3;" in text
        assert (plan["rows"], plan["pipes"]) == (64, 2)
        assert plan["keys"] == (64 if hd == 128 else 128)
        assert plan["stages"] == (4 if hd == 32 else 3)
        q_tile, tile = 64 * hd * 2, plan["keys"] * hd * 2
        ns = plan["stages"]
        assert plan["smem_bytes"] == 1024 + 2 * (
            q_tile + 2 * ns * tile + 8 * (2 + 4 * ns))
    if hd not in (32, 64, 128):
        with pytest.raises(ValueError, match="no wgmma"):
            tsa.sparse_fwd_plan(hd)


# the wgmma forward's schedule: every (b, h, q-block, part) once, widest
# list first, over the five layouts, causal and not, blocks 64 and 128
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cls", ["SparsityConfig", "FixedSparsityConfig",
                                 "VariableSparsityConfig",
                                 "BigBirdSparsityConfig",
                                 "BSLongformerSparsityConfig"])
def test_wgmma_forward_schedule_covers_every_unit_widest_first(cls, causal):
    for block, S, B, H, blocks in ((64, 1024, 2, 3, 7), (128, 2048, 1, 5, 4),
                                   (64, 8192, 1, 25, 132)):
        layout = tsa.sparse_layout(getattr(tsa, cls)(block=block), S, causal,
                                   "cpu")
        pipes = tsa.sparse_units(layout, B, H, blocks)
        assert len(pipes) == 2 * blocks
        units = [u for p in pipes for u in p]
        parts = block // 64
        want = {(b, h, iq, part) for b in range(B) for h in range(H)
                for iq in range(S // block) for part in range(parts)}
        assert len(units) == len(want) and set(units) == want
        width = layout.k_n.tolist()
        # pass k's units, pipeline by pipeline, run no wider than pass
        # k - 1's: the widest lists start first
        for p in pipes:
            w = [width[iq] for _, _, iq, _ in p]
            assert w == sorted(w, reverse=True)
        first = [width[p[0][2]] for p in pipes if p]
        assert min(first) >= max(width[iq] for p in pipes
                                 for _, _, iq, _ in p[1:])


# the wgmma backward pair's tiles: sparse_bwd_plan() against the constants
# of csrc/sparse_bwd_sm90.cuh, read from its text
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("kernel", ["sparse_bwd_dq", "sparse_bwd_dkv"])
def test_wgmma_backward_plan_matches_the_header(kernel, hd):
    from deepspeed_tpu_torch.ops import builder

    text = (builder.CSRC / "sparse_bwd_sm90.cuh").read_text()
    assert "constexpr int kBRows = 64;" in text
    assert "constexpr int kBPipes = 2;" in text
    assert "constexpr int kRowsB = 2 * kBRows * 4;" in text
    name = "kDqStages" if kernel == "sparse_bwd_dq" else "kDkvStages"
    m = re.search(rf"constexpr int {name} = HD == 32 \? (\d+) : "
                  rf"HD == 64 \? (\d+) : (\d+);", text)
    stages = dict(zip((32, 64, 128), map(int, m.groups())))
    plan = tsa.sparse_bwd_plan(kernel, hd)
    assert (plan["pipes"], plan["rows"]) == (2, 64)
    assert plan["stages"] == stages[hd]
    tile, ns = 64 * hd * 2, plan["stages"]
    if kernel == "sparse_bwd_dq":
        assert "2 * kBTileB<HD> + 2 * kDqStages<HD> * kBTileB<HD>" in text
        assert "kDqBars = 8 * (2 + 4 * kDqStages<HD>)" in text
        pipe = 2 * tile + 2 * ns * tile + 8 * (2 + 4 * ns)
    else:
        assert "2 * kBTileB<HD> + 2 * kDkvStages<HD> * kBTileB<HD>" in text
        assert "kDkvRowsB = kDkvStages<HD> * kRowsB" in text
        assert "kDkvBars = 8 * (2 + 2 * kDkvStages<HD>)" in text
        pipe = 2 * tile + ns * (2 * tile + 512) + 8 * (2 + 2 * ns)
    assert plan["smem_bytes"] == 1024 + 2 * pipe <= 232448
    # the most stages that fit, at most 8
    more = 2 * (2 * tile + (512 if kernel == "sparse_bwd_dkv" else 0)
                + 8 * (4 if kernel == "sparse_bwd_dq" else 2))
    assert ns == 8 or plan["smem_bytes"] + more > 232448
    for bad in (16, 48):
        with pytest.raises(ValueError, match="no wgmma"):
            tsa.sparse_bwd_plan(kernel, bad)
    with pytest.raises(ValueError, match="no wgmma backward"):
        tsa.sparse_bwd_plan("sparse_fwd", hd)


# the wgmma backward pair's schedule: dq walks every (b, h, q-block, part),
# dk/dv every (b, KV head, k-block, part) once, widest list first, over
# the five layouts, causal and not, blocks 64 and 128
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cls", ["SparsityConfig", "FixedSparsityConfig",
                                 "VariableSparsityConfig",
                                 "BigBirdSparsityConfig",
                                 "BSLongformerSparsityConfig"])
@pytest.mark.parametrize("kernel", ["sparse_bwd_dq", "sparse_bwd_dkv"])
def test_wgmma_backward_schedule_covers_every_unit_widest_first(kernel, cls,
                                                                causal):
    for block, S, B, heads, blocks in ((64, 1024, 2, 3, 7),
                                       (128, 2048, 1, 5, 4),
                                       (64, 8192, 1, 25, 132)):
        layout = tsa.sparse_layout(getattr(tsa, cls)(block=block), S, causal,
                                   "cpu")
        pipes = tsa.sparse_units(layout, B, heads, blocks, kernel)
        assert len(pipes) == 2 * blocks
        units = [u for p in pipes for u in p]
        parts = block // 64
        want = {(b, h, i, part) for b in range(B) for h in range(heads)
                for i in range(S // block) for part in range(parts)}
        assert len(units) == len(want) and set(units) == want
        width = (layout.q_n if kernel == "sparse_bwd_dkv"
                 else layout.k_n).tolist()
        for p in pipes:
            w = [width[i] for _, _, i, _ in p]
            assert w == sorted(w, reverse=True)
        first = [width[p[0][2]] for p in pipes if p]
        assert min(first) >= max(width[i] for p in pipes
                                 for _, _, i, _ in p[1:])
        # a unit walks its list's chunks, less the hidden half of a causal
        # diagonal 128-block, and at least one (dq: every q-block keeps one)
        for b, h, i, part in units[:64]:
            n = width[i]
            chunks = tsa.sparse_unit_chunks(layout, kernel, i, part)
            assert n * parts - 1 <= chunks <= n * parts
            assert chunks > 0 or kernel == "sparse_bwd_dkv"


@pytest.mark.parametrize("kernel", ["sparse_bwd_dq", "sparse_bwd_dkv"])
def test_phase9_pipelines_balance_without_splitting_lists(kernel):
    """At phase 9's shape (B 1, H 25, S 8192, the Fixed layout, 132 blocks
    of two pipelines) the busiest pipeline walks within 5% of the mean
    list steps: the wgmma backward pair splits no list over blocks and so
    keeps one writer a row and no partial sums."""
    layout = tsa.sparse_layout(tsa.FixedSparsityConfig(), 8192, True, "cpu")
    pipes = tsa.sparse_units(layout, 1, 25, 132, kernel)
    steps = [sum(tsa.sparse_unit_chunks(layout, kernel, i, part)
                 for _, _, i, part in p) for p in pipes]
    assert sum(steps) == 25 * int(layout.k_n.sum())
    mean = sum(steps) / len(steps)
    assert max(steps) <= 1.05 * mean, (max(steps), mean)


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor off the CPU launches a kernel or raises: here (no card) a
    meta tensor is refused, and no launch is counted."""
    layout = tsa.sparse_layout(tsa.FixedSparsityConfig(block=16), 64, True,
                               "cpu")
    q = torch.zeros(1, 64, 2, 16, device="meta", dtype=torch.bfloat16)
    counters = (tsa.sparse_fwd, tsa.sparse_bwd_dq, tsa.sparse_bwd_dkv)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.sparse_fwd(q, q, q, layout)
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.sparse_bwd_dq(q, q, q, q, None, None, layout)
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.sparse_bwd_dkv(q, q, q, q, None, None, layout)
    assert [f.launches for f in counters] == before


def test_plain_pieces_are_the_functions_grads():
    """sparse_fwd / sparse_bwd_dq / sparse_bwd_dkv on CPU tensors are the
    plain versions, and the Function's grads are theirs."""
    _, tc = config_pair(CONFIGS["bigbird"][0], **CONFIGS["bigbird"][1])
    q, k, v, w = qkv(H=4, KV=2, seed=2)
    layout = tsa.sparse_layout(tc, 64, True, "cpu")
    tq, tk, tv, do = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = tsa.sparse_fwd(tq, tk, tv, layout)
    assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
    delta = tsa.attention_delta(o, do)
    dq = tsa.sparse_bwd_dq(tq, tk, tv, do, lse, delta, layout)
    dk, dv = tsa.sparse_bwd_dkv(tq, tk, tv, do, lse, delta, layout)
    got = torch_side(tc, True, q, k, v, w)
    for a, b in zip((o, dq, dk, dv), got):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ the slice
STEPS, SEQ = 4, 32


def train_config():
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupDecayLR",
                          "params": {"warmup_num_steps": 2,
                                     "total_num_steps": 10}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
            "remat": {"enabled": True, "policy": "dots_saveable"},
            "bf16": {"enabled": False}, "mesh": {"data": 1},
            "steps_per_print": 1000}


@pytest.fixture(scope="module")
def slice_run():
    """``tiny_test()`` with FixedSparsityConfig(block=16, num_local_blocks=2)
    as its attention_fn, 4 steps through the JAX engine and through the
    port's on the CPU from the same master params."""
    jc, tc = config_pair("FixedSparsityConfig", block=16, num_local_blocks=2)
    jm = jax_build(jax_presets.tiny_test(dtype=jnp.float32),
                   attention_fn=jsa.make_sparse_attention_fn(jc,
                                                             interpret=True))
    mesh = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = ds.initialize(train_config(), jm, mesh=mesh, seed=0)
    tcfg = torch_presets.tiny_test(dtype=torch.float32)
    counters = (tsa.sparse_fwd, tsa.sparse_bwd_dq, tsa.sparse_bwd_dkv)
    before = [f.launches for f in counters]
    teng = dt.initialize(train_config(), dt.build_model(
        tcfg, attention_fn=tsa.make_sparse_attention_fn(tc)),
        params=params_from_jax(jeng.fp32_params(), tcfg), device="cpu")
    data = random_token_dataset(8 * STEPS, SEQ, tcfg.vocab_size, seed=0)
    jl, tl = [], []
    for i in range(STEPS):
        b = {"input_ids": np.stack([d["input_ids"]
                                    for d in data[8 * i:8 * i + 8]])}
        jl.append(float(jeng.train_batch(dict(b))["loss"]))
        tl.append(float(teng.train_batch(dict(b))["loss"]))
    return dict(jax=jl, port=tl,
                jax_master=jax.tree.map(np.asarray, jeng.fp32_params()),
                port_master=params_to_numpy(teng.fp32_params()),
                launches=[f.launches - b for f, b in zip(counters, before)])


def test_slice_losses_match_jax(slice_run):
    got, want = np.array(slice_run["port"]), np.array(slice_run["jax"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_slice_master_params_match_jax(slice_run):
    flat = lambda t: {**{k: v for k, v in t.items() if k != "layers"},  # noqa
                      **{f"layers.{k}": v for k, v in t["layers"].items()}}
    want, got = flat(slice_run["jax_master"]), flat(slice_run["port_master"])
    assert set(want) == set(got)
    errs = {}
    for k in sorted(set(want) - {"layers.bk"}):
        g, w = (np.asarray(x, np.float64) for x in (got[k], want[k]))
        errs[k] = float(np.linalg.norm(g - w) / (np.linalg.norm(w) or 1.0))
    assert max(errs.values()) <= 1e-5, errs


def test_slice_on_the_cpu_launches_no_kernel(slice_run):
    assert slice_run["launches"] == [0, 0, 0]
