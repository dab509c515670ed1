"""deepspeed_tpu_torch.ops.xent vs the JAX fused softmax-xent kernels.

The same operands, made from a numpy seed, go through the JAX package's
``fused_token_nll`` (its Pallas kernels in interpret mode, as
``tests/unit/test_xent.py`` runs them on the CPU) and through the port's,
whose wrappers take their plain PyTorch versions here because the tensors
lie on the CPU (the CUDA kernels are held against those plain versions on
the card, ``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

Tolerances, as shares of max |reference|:
- fp32: 1e-5. Both sides sum fp32 products of the same fp32 operands, in
  another order (JAX tile by tile, online softmax; the port whole rows).
- bf16: nll and lse 1e-4 (fp32 results of the same bf16 operands; the
  order of the fp32 sums only); dx, dW 2e-2 and db 1e-3: dl is rounded to
  bf16 before both products on both sides, so a last-bit difference in p
  flips a rounding of single elements (2^-9 relative), and dx / dW are
  rounded to bf16 once more at the end (2^-8 of an element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepspeed_tpu.ops import xent as jx
from deepspeed_tpu_torch.models import presets
from deepspeed_tpu_torch.ops import xent as tx
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = {"float32": dict(nll=1e-5, grad=1e-5, db=1e-5),
       "bfloat16": dict(nll=1e-4, grad=2e-2, db=1e-3)}
BLOCK = 128          # the JAX kernels' smallest tile: several tiles at V 1000


def share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_np(t):
    return t.detach().float().numpy()


def operands(T, V, d, dtype, bias, seed=0):
    """x, w, bias, targets, g as numpy fp32 / int32, already rounded to
    ``dtype`` so both packages start from the same values."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    rnd = lambda a: torch.as_tensor(a, dtype=torch.float32).to(tdt).float().numpy()  # noqa: E731
    x = rnd(rng.standard_normal((T, d)))
    w = rnd(rng.standard_normal((V, d)) * 0.3)
    b = rnd(rng.standard_normal(V) * 0.5) if bias else None
    t = rng.integers(0, V, T).astype(np.int32)
    g = rng.standard_normal(T).astype(np.float32) / T
    g[::5] = 0.0                       # tokens the loss mask drops
    return x, w, b, t, g


def jax_run(x, w, b, t, g, dtype):
    jdt = jnp.dtype(dtype)
    xs = [jnp.asarray(x, jdt), jnp.asarray(w, jdt)]
    if b is not None:
        xs.append(jnp.asarray(b, jdt))

    def f(*a):
        return jx.fused_token_nll(a[0], a[1], a[2] if b is not None else None,
                                  jnp.asarray(t), BLOCK, BLOCK, True)

    nll, vjp = jax.vjp(f, *xs)
    grads = vjp(jnp.asarray(g))
    return (np.asarray(nll),
            *(np.asarray(a.astype(jnp.float32)) for a in grads))


def port_run(x, w, b, t, g, dtype):
    tdt = getattr(torch, dtype)
    xs = [torch.as_tensor(x).to(tdt).requires_grad_(),
          torch.as_tensor(w).to(tdt).requires_grad_()]
    bt = None
    if b is not None:
        bt = torch.as_tensor(b).to(tdt).requires_grad_()
        xs.append(bt)
    nll = tx.fused_token_nll(xs[0], xs[1], bt, torch.as_tensor(t))
    nll.backward(torch.as_tensor(g))
    assert nll.dtype == torch.float32
    assert all(a.grad.dtype == tdt for a in xs)
    return (to_np(nll), *(to_np(a.grad) for a in xs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape", [(77, 1000, 64), (256, 512, 128)],
                         ids=["ragged", "dividing"])
def test_value_and_grads_match_the_jax_kernels(shape, bias, dtype):
    ops = operands(*shape, dtype, bias)
    want, got = jax_run(*ops, dtype), port_run(*ops, dtype)
    tol = TOL[dtype]
    assert len(got) == len(want) == (4 if bias else 3)
    assert share(got[0], want[0]) <= tol["nll"]
    assert share(got[1], want[1]) <= tol["grad"]          # dx
    assert share(got[2], want[2]) <= tol["grad"]          # dW
    if bias:
        assert share(got[3], want[3]) <= (tol["db"] if dtype == "float32"
                                          else tol["grad"])
    # g = 0 rows take no gradient at all
    assert not got[1][::5].any()


def test_fp32_db_of_the_dw_wrapper_is_unrounded():
    """db comes out fp32 from the unrounded dl even under bf16 operands."""
    x, w, b, t, g = operands(77, 1000, 64, "bfloat16", True)
    args = [torch.as_tensor(a).bfloat16() for a in (x, w, b)]
    tt, gt = torch.as_tensor(t), torch.as_tensor(g)
    _, lse = tx.xent_fwd(*args, tt)
    _, dw, db = tx.xent_bwd(*args, tt, lse, gt)
    jlse = jx._fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                   jnp.asarray(t), BLOCK, BLOCK, True)[1]
    _, _, jdb = jx._bwd_kernels(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (x, w, b)), jnp.asarray(t), jlse,
                                jnp.asarray(g), BLOCK, BLOCK, True)
    assert db.dtype == torch.float32 and dw.dtype == torch.bfloat16
    assert share(to_np(db), np.asarray(jdb)) <= TOL["bfloat16"]["db"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_target_outside_the_vocab_matches_nothing(dtype):
    """A target >= V (in the JAX kernels' padded tail tile) or < 0: nll is
    the logsumexp alone and no onehot enters the gradients."""
    x, w, b, t, g = operands(77, 1000, 64, dtype, True, seed=3)
    t[3], t[10], t[20] = 1010, 1000, 999      # 999: the last valid column
    want, got = jax_run(x, w, b, t, g, dtype), port_run(x, w, b, t, g, dtype)
    tol = TOL[dtype]
    for a, r in zip(got, want):
        assert share(a, r) <= max(tol["nll"], tol["grad"])
    tt = torch.as_tensor(t)
    args = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in (x, w, b)]
    nll, lse = tx.xent_fwd(*args, tt)
    torch.testing.assert_close(nll[[3, 10]], lse[[3, 10]], atol=0, rtol=0)
    assert float(nll[20]) != float(lse[20])
    tt[5] = -7
    nll, lse = tx.xent_fwd(*args, tt)
    assert float(nll[5]) == float(lse[5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_partials_mode_per_shard_and_combined(bias, dtype):
    """``partials=True`` on each of 4 vocab shards (targets global minus
    the shard's offset, so three shards see a foreign target, negative or
    past the shard) against JAX's ``_fwd(..., partials=True)``; then the
    hand combine (max, sum-exp, sum: ``_fwd_tp``'s arithmetic) against the
    full forward of both packages."""
    T, V, d, P = 77, 1000, 64, 4
    x, w, b, t, _ = operands(T, V, d, dtype, bias, seed=5)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    vs = V // P
    tgt_p, lse_p = [], []
    for s in range(P):
        sl = slice(s * vs, (s + 1) * vs)
        t_loc = (t - s * vs).astype(np.int32)
        bs = None if b is None else b[sl]
        got = tx.xent_fwd(torch.as_tensor(x).to(tdt),
                          torch.as_tensor(w[sl]).to(tdt),
                          None if bs is None else torch.as_tensor(bs).to(tdt),
                          torch.as_tensor(t_loc), partials=True)
        want = jx._fwd(jnp.asarray(x, jdt), jnp.asarray(w[sl], jdt),
                       None if bs is None else jnp.asarray(bs, jdt),
                       jnp.asarray(t_loc), BLOCK, BLOCK, True, partials=True)
        for a, r in zip(got, want):
            assert share(to_np(a), np.asarray(r)) <= TOL[dtype]["nll"]
        # a foreign target contributes exactly nothing
        foreign = (t_loc < 0) | (t_loc >= vs)
        assert not to_np(got[0])[foreign].any()
        tgt_p.append(got[0])
        lse_p.append(got[1])
    lse_l = torch.stack(lse_p)
    m_g = lse_l.amax(0)
    lse_g = m_g + torch.log(torch.exp(lse_l - m_g).sum(0))
    nll_g = lse_g - torch.stack(tgt_p).sum(0)
    full = tx.xent_fwd(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                       None if b is None else torch.as_tensor(b).to(tdt),
                       torch.as_tensor(t))
    jfull = jx._fwd(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                    None if b is None else jnp.asarray(b, jdt),
                    jnp.asarray(t), BLOCK, BLOCK, True)
    for a, r, j in zip((nll_g, lse_g), full, jfull):
        assert share(to_np(a), to_np(r)) <= TOL[dtype]["nll"]
        assert share(to_np(a), np.asarray(j)) <= TOL[dtype]["nll"]


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_function_matches_autograd_of_the_unfused_loss(bias):
    """The Function's hand-written backward against autograd through
    ``F.cross_entropy`` of the materialized logits, fp32."""
    x, w, b, t, g = operands(33, 200, 16, "float32", bias, seed=7)
    mk = lambda a: torch.as_tensor(a).requires_grad_()  # noqa: E731
    tt, gt = torch.as_tensor(t).long(), torch.as_tensor(g)
    a = [mk(x), mk(w)] + ([mk(b)] if bias else [])
    r = [mk(x), mk(w)] + ([mk(b)] if bias else [])
    tx.fused_token_nll(a[0], a[1], a[2] if bias else None, tt).backward(gt)
    F.cross_entropy(F.linear(*r), tt, reduction="none").backward(gt)
    for u, v in zip(a, r):
        assert share(to_np(u.grad), to_np(v.grad)) <= 1e-5


def test_no_grad_forward_and_cpu_launch_counts():
    x, w, b, t, g = operands(20, 300, 32, "float32", True)
    before = (tx.xent_fwd.launches, tx.xent_bwd.launches)
    args = [torch.as_tensor(a) for a in (x, w, b)]
    with torch.no_grad():
        nll = tx.fused_token_nll(*args, torch.as_tensor(t))
    want = F.cross_entropy(F.linear(*args), torch.as_tensor(t).long(),
                           reduction="none")
    torch.testing.assert_close(nll, want, atol=1e-5, rtol=0)
    _, lse = tx.xent_fwd(*args, torch.as_tensor(t))
    tx.xent_bwd(*args, torch.as_tensor(t), lse, torch.as_tensor(g))
    assert (tx.xent_fwd.launches, tx.xent_bwd.launches) == before


# dtypes and widths of tests/test_torch_train.py's XENT_CASES, plus the edges
@pytest.mark.parametrize("accelerator", [True, False])
@pytest.mark.parametrize("d", [64, 1600, 6144, 6160, 8192])
@pytest.mark.parametrize("cfg_dtype,compute", [
    ("bfloat16", None), ("bfloat16", "bfloat16"), ("float16", None),
    ("bfloat16", "float16"), ("float32", "float32")])
def test_eligibility_matches_jax(monkeypatch, cfg_dtype, compute, d,
                                 accelerator):
    monkeypatch.setattr(jax, "default_backend",
                        lambda: "tpu" if accelerator else "cpu")
    want = jx.fused_xent_eligible(
        jnp.dtype(cfg_dtype), None if compute is None else jnp.dtype(compute),
        d)
    got = tx.fused_xent_eligible(
        getattr(torch, cfg_dtype),
        None if compute is None else getattr(torch, compute), d, accelerator)
    assert got == want
    assert tx.fused_xent_eligible_d(d) == jx.fused_xent_eligible_d(d)
    assert tx._TILE_ELEM_BUDGET == jx._TILE_ELEM_BUDGET
    assert tx._MIN_TILE == jx._MIN_TILE


@pytest.mark.parametrize("T,V", [(4092, 50257), (8192, 30522), (1, 1000),
                                 (77, 1000), (100000, 64), (5, 63)])
def test_forward_splits_cover_the_vocab_with_no_empty_split(T, V):
    n = tx.fwd_splits(T, V, sms=132)
    tiles = -(-V // tx._FWD_COLS)
    per = -(-tiles // n)
    assert 1 <= n <= tiles and (n - 1) * per < tiles <= n * per
    # one wave: the blocks fit the SMs unless the token tiles alone pass them
    assert n == 1 or n * -(-T // tx._FWD_ROWS) <= 132


# (T, V, d): every preset's head the fused path takes (d <= 6144) at 1 and
# at 4096 tokens, chip_smoke.py's XENT_CASES, and GPT-2 1.5B at 8191 tokens
# (phase 9)
_PRESET_HEADS = sorted({(cfg.vocab_size, cfg.d_model) for cfg in (
    *(presets.gpt2(s) for s in ("125m", "350m", "774m", "1.5b")),
    *(presets.llama2(s) for s in ("tiny", "7b", "13b")),
    *(presets.bert(s) for s in ("tiny", "base", "large")),
    *(presets.opt(s) for s in ("tiny", "125m", "1.3b", "6.7b", "13b")),
    *(presets.bloom(s) for s in ("tiny", "560m", "7b")), presets.tiny_test())
    if tx.fused_xent_eligible_d(cfg.d_model)})
BWD_PLAN_SHAPES = sorted(
    {(T, V, d) for V, d in _PRESET_HEADS for T in (1, 4096)}
    | {(4092, 50257, 1600), (8192, 30522, 1024), (77, 1000, 64),
       (1, 1000, 64), (300, 3000, 2304), (256, 2000, 6144),
       (8191, 50257, 1600)})


@pytest.mark.parametrize("vc", [None, 1024, 4096])
@pytest.mark.parametrize("T,V,d", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_the_vocab_once_in_order(T, V, d, vc):
    """The backward's chunks cover [0, V) exactly once and in order, each a
    multiple of 64 wide but the last (the dl scratch's row pitch stays
    16-byte aligned and its TMA boxes whole); two launches a chunk; the
    tiles and blocks of each launch; the scratch sizes."""
    plan = tx.xent_bwd_plan(T, V, d, sms=132, vc=vc)
    vc_ = plan["vc"]
    assert vc_ % 256 == 0 and vc_ <= (vc or tx.BWD_VC)
    assert vc_ == min(vc or tx.BWD_VC, -(-V // 256) * 256)
    nxt = 0
    for v0, vw in plan["chunks"]:
        assert v0 == nxt and 0 < vw <= vc_
        assert vw == vc_ or v0 + vw == V          # only the last is short
        nxt = v0 + vw
    assert nxt == V
    n = len(plan["chunks"])
    assert n == -(-V // vc_) and plan["launches"] == 2 * n
    ntt, ndt = -(-T // 256), -(-d // 128)
    assert plan["tiles_dl"] == [ntt * -(-vw // 128)
                                for _, vw in plan["chunks"]]
    assert plan["tiles_prod"] == [(-(-vw // 256) + ntt) * ndt
                                  for _, vw in plan["chunks"]]
    assert plan["blocks_dl"] == [min(t, 132) for t in plan["tiles_dl"]]
    assert plan["blocks_prod"] == [min(t, 132) for t in plan["tiles_prod"]]
    assert plan["dl"] == T * vc_ and plan["dbpart"] == ntt * vc_
    assert plan["dxacc"] == (T * d if n > 1 else 0)
    assert plan["scratch_bytes"] == (2 * plan["dl"] + 4 * plan["dbpart"]
                                     + 4 * plan["dxacc"])


@pytest.mark.parametrize("T,d", [(1, 64), (4092, 1600), (8192, 1024),
                                 (8191, 1600)])
def test_bwd_plan_scratch_does_not_grow_with_the_vocab(T, d):
    """Past one chunk the scratch is the same at any V; below it, smaller."""
    sizes = {V: tx.xent_bwd_plan(T, V, d, sms=132)["scratch_bytes"]
             for V in (1000, 30522, 50257, 250880, 10 ** 6)}
    assert sizes[30522] == sizes[50257] == sizes[250880] == sizes[10 ** 6]
    assert sizes[1000] < sizes[50257]
    assert sizes[50257] == (2 * T * tx.BWD_VC + 4 * -(-T // 256) * tx.BWD_VC
                            + 4 * T * d)


@pytest.mark.parametrize("vc", [0, 100, 300, -256])
def test_bwd_plan_refuses_a_chunk_off_256(vc):
    with pytest.raises(ValueError, match="multiple of 256"):
        tx.xent_bwd_plan(77, 1000, 64, sms=132, vc=vc)


@pytest.mark.parametrize("T", [2 ** 20, 3 * 10 ** 6, 2 ** 23 - 1])
def test_bwd_plan_keeps_the_scratch_offsets_32_bit(T):
    """The dl scratch's element offsets are 32-bit in the kernel: the
    chunk shrinks (by whole 256s) until T * vc < 2^31; past 2^23 tokens no
    chunk fits and the plan refuses."""
    plan = tx.xent_bwd_plan(T, 50257, 1600, sms=132)
    assert plan["vc"] % 256 == 0 and T * plan["vc"] < 2 ** 31
    assert plan["vc"] == min(tx.BWD_VC, (2 ** 31 - 1) // T // 256 * 256)
    with pytest.raises(ValueError, match="32-bit"):
        tx.xent_bwd_plan(2 ** 23, 50257, 1600, sms=132)
