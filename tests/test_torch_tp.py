"""deepspeed_tpu_torch tensor and expert parallelism in one process: the
rules that need no process group, against the JAX package's where it has
them.

- The cut of each leaf (``TPLayout.cut``): the fused qkv head-aligned, GQA's
  KV heads split or (``tp`` a multiple of ``n_kv_head``) the one its query
  heads read, a vocabulary ``tp`` does not divide kept whole, experts over
  ``expert``; every rank's cuts tile the whole leaf.
- ``QuantizedTensor.rows``: int4 cut on row pairs, the single-group rule
  (the scale whole, the shard its own group, as JAX's ``K // tp``), and
  the shapes whose rows fall off their groups and dequantize at the point
  of use, on the JAX package's gate (``quantization.py:212-217``), Llama-2-7B's
  ``w_out`` at tp 4 among them. Dequantized shards equal the whole leaf's
  rows exactly.
- ``int8_psum``'s blocking: ``chunk_elems`` and ``_quant_blocks`` against
  the JAX package's on the same array (the jitted quantizer: its bytes).
- ALiBi: a rank's slopes are its slice of the global ramp.
- The refusals: ``expert_parallel`` that does not divide the experts, a
  sharded engine with no process group, the training engine's
  ``mesh.model`` / ``mesh.expert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import compressed as jc
from deepspeed_tpu.models.transformer import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.quant import quant_blocks as jax_quant_blocks

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.comm import compressed as tc
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.models import (TPLayout, build_model, cut_leaf,
                                        llama2, mixtral, tiny_test)
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.platform.mesh import AXIS_ORDER, Mesh
from torch_one_thread import one_torch_thread  # noqa: F401


def layouts(cfg, tp=1, ep=1):
    """Every rank's layout of a tp x ep mesh (no process group)."""
    shape = {a: 1 for a in AXIS_ORDER}
    shape.update(model=tp, expert=ep)
    return [TPLayout.of(cfg, Mesh(shape, r)) for r in range(tp * ep)]


def whole_of(cfg, name, lays, t):
    """Reassemble a leaf from every rank's cut (each piece of a split dim
    back at its place) and check the pieces tile it."""
    out = torch.full_like(t, float("nan"))
    for lay in lays:
        idx = [torch.arange(n) for n in t.shape]
        for dim, ranges in lay.cut(cfg, name).items():
            idx[dim] = torch.cat([torch.arange(a, b) for a, b in ranges])
        out[torch.meshgrid(*idx, indexing="ij")] = cut_leaf(
            t, lay.cut(cfg, name))
    return out


@pytest.mark.parametrize("cfg,tp,ep", [
    (llama2("tiny", vocab_size=256), 2, 1),          # kv 4 over 2
    (llama2("tiny", vocab_size=256), 4, 1),          # kv 4 over 4
    (llama2("tiny", n_kv_head=2, vocab_size=256), 4, 1),   # tp > kv
    (llama2("tiny", n_kv_head=1, vocab_size=256), 8, 1),   # MQA
    (tiny_test(vocab_size=257), 2, 1),               # V % tp != 0
    (mixtral("tiny", vocab_size=256), 2, 2),
    (mixtral("tiny", vocab_size=256), 1, 4)],
    ids=["llama-tp2", "llama-tp4", "gqa-keep", "mqa-tp8", "odd-vocab",
         "mixtral-ep2-tp2", "mixtral-ep4"])
def test_cuts_tile_every_leaf(cfg, tp, ep):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    lays = layouts(cfg, tp, ep)
    for name, t in params.items():
        if all(lay.cut(cfg, name) == {} for lay in lays):
            continue
        # (a KV head that several ranks keep is written by each, alike)
        assert torch.equal(whole_of(cfg, name, lays, t), t), name


def test_fused_qkv_is_cut_head_aligned():
    cfg = llama2("tiny", vocab_size=256)          # h 8, kv 4, hd 32
    h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    cols = torch.arange((h + 2 * kv) * hd, dtype=torch.float32)
    wqkv = cols.reshape(1, 1, -1)                 # (L, d, N)
    for lay in layouts(cfg, 4):
        got = cut_leaf(wqkv, lay.cut(cfg, "layers.wqkv"))
        r = lay.m
        want = torch.cat([cols[r * 2 * hd:(r + 1) * 2 * hd],
                          cols[h * hd + r * hd:h * hd + (r + 1) * hd],
                          cols[(h + kv) * hd + r * hd:
                               (h + kv) * hd + (r + 1) * hd]])
        assert torch.equal(got[0, 0], want)


def test_gqa_rank_keeps_the_kv_head_its_queries_read():
    # the 70B heads at tp 16 and 8 (kv 8): 4 and 8 query heads a rank
    cfg = llama2("70b")
    for tp in (16, 8):
        for lay in layouts(cfg, tp):
            assert lay.kv_heads == (8 // tp if tp <= 8 else 1)
            assert lay.q0 // (cfg.n_head // cfg.kv_heads) == lay.kv0
    # n_kv_head 2, tp 4: ranks 0-1 read KV head 0, ranks 2-3 head 1
    cfg = llama2("tiny", n_kv_head=2)
    assert [(lay.kv0, lay.kv_heads) for lay in layouts(cfg, 4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    with pytest.raises(ValueError, match="n_kv_head"):
        layouts(llama2("tiny", n_kv_head=4, n_head=12, d_model=384), 3)


def test_vocab_the_ranks_do_not_divide_stays_whole():
    cfg = tiny_test(vocab_size=257, tie_embeddings=False, lm_head_bias=True)
    for lay in layouts(cfg, 2):
        assert not lay.vocab_split and (lay.v0, lay.v1) == (0, 257)
        for name in ("tok_embed", "lm_head", "lm_head_bias"):
            assert lay.cut(cfg, name) == {}
        assert lay.cut(cfg, "layers.w_in") == {2: [(lay.f0, lay.f0 + 64)]}
    lay = layouts(tiny_test(vocab_size=256, tie_embeddings=False), 2)[1]
    assert lay.cut(tiny_test(vocab_size=256, tie_embeddings=False),
                   "lm_head") == {1: [(128, 256)]}


def test_quantized_rows_int4_pairs_and_single_group():
    w = torch.randn(48, 24, generator=torch.Generator().manual_seed(1))
    q4 = tq.quantize(w, 8, bits=4)
    whole = tq.dequantize(q4, torch.float32)
    for a, b in ((0, 24), (24, 48), (8, 40)):
        part = q4.rows(a, b)
        assert part.aligned and part.q.shape == ((b - a) // 2, 24)
        assert torch.equal(tq.dequantize(part, torch.float32), whole[a:b])
    with pytest.raises(ValueError, match="pair"):
        q4.rows(3, 11)
    # 48 rows at group 32: one whole group; each shard keeps the one scale
    # row and is a group of its own rows (JAX's gs_local = K // tp)
    one = tq.quantize(w, 32, bits=8)
    assert one.scale.shape == (1, 24) and one.group_size == 48
    part = one.rows(24, 48)
    assert part.group_size == 24 and part.aligned
    assert torch.equal(part.scale, one.scale)
    x = torch.randn(3, 24, generator=torch.Generator().manual_seed(2))
    got = tq.woq_dot(x, part, use_kernel=True)
    np.testing.assert_allclose(
        got.numpy(), (x @ tq.dequantize(one, torch.float32)[24:]).numpy(),
        rtol=0, atol=1e-5)


def jax_row_fallback(K, gs, tp, bits=8) -> bool:
    """The JAX package's gate for a row-split leaf (``quantization.py:
    212-217``): dequantize at the point of use, not the kernel."""
    gs = gs if K % gs == 0 else K
    G = K // gs
    qrows = K // 2 if bits == 4 else K
    return (G % tp != 0 and G != 1) or qrows % tp != 0 or K % tp != 0


@pytest.mark.parametrize("K,gs,tp,bits", [
    (11008, 128, 4, 8),          # Llama-2-7B w_out at tp 4: 86 groups
    (11008, 128, 2, 8), (4096, 128, 4, 8), (4096, 128, 8, 4),
    (688, 16, 2, 8), (688, 64, 2, 8), (704, 16, 4, 4)])
def test_row_shards_fall_back_where_jax_does(K, gs, tp, bits):
    N = 8
    w = torch.randn(K, N, generator=torch.Generator().manual_seed(K + tp))
    qt = tq.quantize(w, gs, bits)
    whole = tq.dequantize(qt, torch.float32)
    shards = [qt.rows(r * K // tp, (r + 1) * K // tp) for r in range(tp)]
    assert any(not s.aligned for s in shards) == jax_row_fallback(
        K, gs, tp, bits)
    x = torch.randn(2, K, generator=torch.Generator().manual_seed(3))
    for r, s in enumerate(shards):
        rows = slice(r * K // tp, (r + 1) * K // tp)
        assert torch.equal(tq.dequantize(s, torch.float32), whole[rows])
        # the kernel route takes aligned shards; the rest dequantize, and
        # both give this rank's partial of x @ W
        part = tq.row_partial(x[:, rows], s, True, tp)
        want = (x[:, rows] @ whole[rows]).numpy()
        assert part.dtype == torch.float32
        np.testing.assert_allclose(part.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_llama2_7b_w_out_at_tp4_is_the_dequantize_fallback(monkeypatch):
    """86 groups of 128 over 4 ranks: 21.5 a rank, so no rank's shard is
    on the kernel route, as JAX's ``G % tp`` gate says; the shard starts
    64 rows into its first group on ranks 1 and 3."""
    called = []
    monkeypatch.setattr(tq, "woq_matmul",
                        lambda *a, **k: called.append(1))
    w = torch.randn(11008, 8, generator=torch.Generator().manual_seed(0))
    qt = tq.quantize(w, 128, 8)
    for r in range(4):
        s = qt.rows(r * 2752, (r + 1) * 2752)
        assert (s.aligned, s.row0, s.scale.shape[0]) == \
            (False, 64 * (r % 2), 22)
        tq.woq_dot(torch.ones(1, 2752), s, use_kernel=True)
    assert not called


def test_int8_psum_blocks_are_jax_blocks():
    for n, world in ((1, 2), (6000, 2), (2048 * 3 + 1, 4), (9000, 4)):
        assert tc.chunk_elems(n, world) == jc.chunk_elems(n, world)
    x = np.random.default_rng(0).standard_normal((4, 3, 2048)) \
        .astype(np.float32) * np.logspace(-3, 2, 3)[None, :, None] \
        .astype(np.float32)
    x[1, 2] = 0.0                     # an all-zero block: the 1e-12 floor
    q, s = tc._quant_blocks(torch.from_numpy(x))
    jq, js = jax.jit(jax_quant_blocks)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_psum_of_one_rank_is_the_identity():
    mesh = Mesh({a: 1 for a in AXIS_ORDER})
    x = torch.randn(5, 7)
    assert tc.int8_psum(x, "model", mesh=mesh) is x


def test_alibi_slopes_are_the_rank_slice_of_the_global_ramp():
    cfg = tiny_test(n_head=16, d_model=256, pos_embedding="alibi")
    full = np.asarray(jax_slopes(16))
    for tp in (2, 4):
        for lay in layouts(cfg, tp):
            got = decode._alibi_slopes(16, "cpu", lay).numpy()
            np.testing.assert_array_equal(
                got, full[lay.q0:lay.q0 + lay.heads])
    # not the ramp of n_head / tp heads (what a rank-local config gives)
    lay = layouts(cfg, 4)[1]
    assert not np.array_equal(decode._alibi_slopes(16, "cpu", lay).numpy(),
                              alibi_slopes(4).numpy())


def test_refusals():
    cfg = mixtral("tiny", num_experts=8, vocab_size=256, n_layer=1)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="must divide"):
        dt.init_inference(model, params, {"expert_parallel": 3},
                          device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        dt.init_inference(model, params, {"expert_parallel": 2},
                          device="cpu")
    tcfg = tiny_test()
    for axis in ("model", "expert"):
        # training under model / expert is ported; hpZ composed with it not
        with pytest.raises(NotImplementedError, match="item 4"):
            dt.initialize({"train_batch_size": 2, "mesh": {axis: 2},
                           "zero_optimization": {
                               "stage": 3, "zero_hpz_partition_size": 2}},
                          build_model(tcfg), device="cpu")


def test_forward_is_refused_on_a_sharded_layout():
    cfg = tiny_test()
    eng = dt.init_inference(build_model(cfg),
                            build_model(cfg).init(torch.Generator()),
                            {"dtype": "float32"}, device="cpu")
    eng.layout = layouts(cfg, 2)[0]
    # forward() runs sharded, over the process group the engine was cut
    # over; a layout set by hand, with no group behind it, is refused
    with pytest.raises(ValueError, match="init_distributed"):
        eng.forward(np.zeros((1, 4), np.int32))


def test_rank_shard_of_a_jax_tree_is_the_jax_device_shard():
    """``models.rank_shard`` on a JAX param tree, dense and JAX-quantized
    (group 8, int8 and int4: llama2 tiny's 688 FFN rows in 86 groups, a
    whole number a device): rank r's shard of each leaf is the block
    ``device_put`` under ``param_specs`` (and ``quantized_shardings``)
    leaves on device r of a 2-device ``model`` mesh, byte for byte."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepspeed_tpu.inference import quantization as jq
    from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
    from deepspeed_tpu_torch.models import rank_shard

    from test_torch_model import make_pair    # a test module of this directory

    jm, jparams, tm, _ = make_pair("llama2_tiny")
    cfg = tm.cfg
    mesh = build_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    specs = jm.param_specs()
    quant = {bits: jax.jit(lambda t, b=bits: jq.quantize_params(
        t, group_size=8, bits=b, specs=specs))(jparams) for bits in (8, 4)}
    for tree in (jparams, quant[8], quant[4]):
        if tree is jparams:
            placed = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                tree, specs, is_leaf=lambda x: isinstance(x, P))
        else:
            placed = jax.device_put(tree, jq.quantized_shardings(
                specs, tree, mesh))
        numpy = jax.tree.map(np.asarray, tree)
        flat = {**{k: v for k, v in placed.items() if k != "layers"},
                **{f"layers.{k}": v for k, v in placed["layers"].items()}}
        for r, lay in enumerate(layouts(cfg, 2)):
            got = rank_shard(numpy, cfg, lay)
            for k, v in flat.items():
                arrays = [(got[k].q, v.q), (got[k].scale, v.scale)] \
                    if isinstance(v, jq.QuantizedTensor) else [(got[k], v)]
                for g, a in arrays:
                    block = {s.device: np.asarray(s.data)
                             for s in a.addressable_shards}[
                                 jax.devices()[r]]
                    np.testing.assert_array_equal(g.numpy(), block,
                                                  err_msg=f"{r} {k}")
