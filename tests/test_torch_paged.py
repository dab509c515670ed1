"""deepspeed_tpu_torch's paged KV pool (serving/pages.py, the paged branches
of inference/decode.py, serving/scheduler.py and serving/engine.py)
against the JAX package's, and against the port's own contiguous engine.

Oracles, on the CPU in fp32, inputs from a numpy seed:
- ``quantize_kv``: int8 bytes identical to the JAX engine's jitted form,
  scales within 1 ulp (XLA folds the division by 127 under jit);
- ``_paged_append`` / ``_paged_view``, ``insert_paged`` / ``hydrate_cache``,
  fp and int8, on random tables with scratch rows and lengths past
  ``max_len``: equal to the JAX functions' results exactly (page 0, the
  scratch page where duplicate writes land, excepted);
- ``plan_chunks(skip=)`` over a grid, and the ``PagePool`` / radix tree
  over one scripted sequence of admissions, copy-on-write, releases,
  evictions, defers and sheds: equal to the JAX package's, allocation by
  allocation and snapshot by snapshot;
- greedy paged serving tokens, fp and int8 KV, equal to the JAX paged
  ``ServingEngine``'s on three configs, over a stream with prefix hits
  and copy-on-write (the int8 oracle is JAX's actual tokens);
- the JAX oracles of ``tests/unit/test_paged_kv.py`` against the port:
  paged equals contiguous over churn, sharing and copy-on-write; shed and
  defer under a fake clock; the config's validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference import decode as jdec
from deepspeed_tpu.models import tiny_test as jax_tiny_test
from deepspeed_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.observability.tracing import ServingStats as JaxStats
from deepspeed_tpu.serving import PagePool as JaxPagePool
from deepspeed_tpu.serving import Scheduler as JaxScheduler
from deepspeed_tpu.serving import pages as jpages
from deepspeed_tpu.serving import plan_chunks as jax_plan_chunks
from deepspeed_tpu.serving.pages import PagePoolExhausted as JaxExhausted
from deepspeed_tpu_torch.inference import decode as tdec
from deepspeed_tpu_torch.inference.config import (InferenceConfig,
                                                  ServingConfig)
from deepspeed_tpu_torch.inference.decode import (GenCarry, KVCache,
                                                  PagedKVCache, cache_layout,
                                                  quantize_kv)
from deepspeed_tpu_torch.models import build_model, tiny_test
from deepspeed_tpu_torch.observability.metrics import MetricsRegistry
from deepspeed_tpu_torch.observability.tracing import ServingStats
from deepspeed_tpu_torch.serving import (PagePool, PagePoolExhausted,
                                         RadixPrefixTree, RequestStatus,
                                         Scheduler, ServingEngine,
                                         hydrate_cache, init_paged_slots,
                                         insert_paged, plan_chunks)

from test_torch_model import make_pair  # a test module of this directory
from torch_one_thread import one_torch_thread  # noqa: F401

M = 48          # slot capacity used across these tests
PS = 8          # page size
EOS = 7
SAMPLING = dict(temperature=0.8, top_k=20)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test(max_seq=64, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    eng = dt.init_inference(model, params,
                            {"dtype": "float32", "eos_token_id": EOS},
                            device="cpu")
    return cfg, eng


def _serve(eng, reqs, extra=None, slots=3, sampling=SAMPLING, **kw):
    srv = ServingEngine(eng, {"slots": slots, "max_len": M,
                              "prefill_chunk": 16, **sampling,
                              **(extra or {})}, **kw)
    return srv, srv.serve_batch(*[list(a) for a in zip(*reqs)])


def _requests(shapes, seed, vocab=256, seed0=100):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (P,)).astype(np.int32), N, seed0 + i)
            for i, (P, N) in enumerate(shapes)]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ------------------------------------------------------------ device layout
def test_paged_cache_layout_and_init(setup):
    """One source of the shapes: the pool's layout is the JAX package's,
    and init_paged_slots allocates it (int8 pools with fp32 scales)."""
    cfg, _ = setup
    jcfg = jax_tiny_test(max_seq=64, dtype=jnp.float32)
    shape, dtype = cache_layout(cfg, 4, M, page_size=PS, pages=10)
    assert shape == jdec.cache_layout(jcfg, 4, M, page_size=PS,
                                      pages=10)[0]
    assert shape == (cfg.n_layer, 10, cfg.kv_heads, PS, cfg.head_dim)
    assert cache_layout(cfg, 4, M)[0] == jdec.cache_layout(jcfg, 4, M)[0]
    state = init_paged_slots(cfg, 4, M, PS, 10, torch.float32)
    assert isinstance(state.cache, PagedKVCache)
    assert state.cache.k.shape == shape and state.cache.k.dtype == dtype
    assert state.cache.k_scale is None and state.cache.page_size == PS
    assert state.cache.page_table.shape == (4, M // PS)
    assert state.cache.page_table.dtype == torch.int32
    assert state.cache.length.shape == (4,) and state.done.all()
    q = init_paged_slots(cfg, 4, M, PS, 10, torch.float32, kv_quant_bits=8)
    assert q.cache.k.dtype == torch.int8
    assert q.cache.k_scale.shape == shape[:-1]
    assert q.cache.k_scale.dtype == torch.float32


# ------------------------------------------------------------------- int8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equals_jitted_jax(dtype):
    """int8 bytes identical to the JAX engine's jitted quantize_kv, scales
    within 1 ulp, dequantize equal, on values of several magnitudes and an
    all-zero row."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 5, 4, 64)) * \
        rng.choice([1e-3, 0.1, 3.0, 50.0], size=(6, 5, 4, 1))
    x[0, 0, 0] = 0.0
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jax.jit(jdec.quantize_kv)(jx)
    q, s = quantize_kv(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    jd = jax.jit(jdec.dequantize_kv, static_argnums=(2,))(jq, js,
                                                          jnp.float32)
    np.testing.assert_array_equal(
        tdec.dequantize_kv(_t(np.asarray(jq)), _t(np.asarray(js)),
                           torch.float32).numpy(), np.asarray(jd))


def test_quantize_kv_bound_and_idempotent():
    """Dequant error <= half a step per element; re-quantizing a
    dequantized value is exact (a hydrated shared prefix re-inserts
    without drift); an all-zero row keeps a positive scale."""
    rng = np.random.default_rng(0)
    x = _t(rng.normal(scale=3.0, size=(5, 4, 64)), torch.float32)
    q, s = quantize_kv(x)
    dq = q.float() * s[..., None]
    assert torch.all((dq - x).abs() <= s[..., None] / 2 + 1e-7)
    q2, s2 = quantize_kv(dq)
    assert torch.equal(q2, q)
    torch.testing.assert_close(s2, s, rtol=1e-6, atol=0)
    qz, sz = quantize_kv(torch.zeros(2, 3, 8))
    assert torch.all(qz == 0) and torch.all(sz > 0)


# ------------------------------------------------- append / view / insert
def _pools(rng, pages, KV, ps, hd, quant):
    ck = rng.normal(size=(pages, KV, ps, hd)).astype(np.float32)
    cv = rng.normal(size=(pages, KV, ps, hd)).astype(np.float32)
    if not quant:
        return ck, cv, None, None
    q = lambda a: np.clip(np.round(a * 40), -127, 127).astype(np.int8)
    s = lambda: rng.uniform(0.01, 0.1, (pages, KV, ps)).astype(np.float32)
    return q(ck), q(cv), s(), s()


def _table(rng, B, n, pages, idle=()):
    """Distinct non-scratch pages per live row; idle rows on scratch."""
    ids = rng.permutation(np.arange(1, pages))[:B * n].reshape(B, n)
    ids = ids.astype(np.int32)
    for b in idle:
        ids[b] = 0
    return ids


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T", [1, 3])
def test_paged_append_equals_jax(quant, T):
    """One layer's append through random tables: a live row, an idle row
    on scratch, a row whose length runs past max_len (its page index
    clips to the row's last entry) and one that ends on a page boundary.
    Every pool page but scratch equals the JAX function's exactly."""
    rng = np.random.default_rng(7 + T)
    pages, KV, ps, hd, n, B = 20, 2, 8, 16, 4, 4
    ck, cv, ks, vs = _pools(rng, pages, KV, ps, hd, quant)
    table = _table(rng, B, n, pages, idle=(1,))
    new_len = np.array([5 + T, 11, 4 * ps + 9, 2 * ps], np.int32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    jout = jax.jit(jdec._paged_append)(
        *(None if a is None else jnp.asarray(a)
          for a in (ck, cv, ks, vs, k, v, table, new_len)))
    tout = [None if a is None else _t(a).clone() for a in (ck, cv, ks, vs)]
    tdec._paged_append(*tout, _t(k), _t(v), _t(table), _t(new_len))
    for got, want in zip(tout, jout):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    # the writes went where the tables say: the live row's last token
    b, pos = 0, 5 + T - 1
    assert torch.equal(tout[0][table[b, pos // ps], :, pos % ps],
                       quantize_kv(_t(k[b, -1]))[0] if quant
                       else _t(k[b, -1]))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_view_equals_jax(quant):
    """The gathered (B, KV, max_len, hd) view, fp and dequantized int8,
    equals the JAX function's exactly; an fp view holds the pool's bytes,
    as a contiguous cache of them would."""
    rng = np.random.default_rng(3)
    pages, KV, ps, hd, n, B = 16, 3, 8, 32, 5, 3
    ck, _, ks, _ = _pools(rng, pages, KV, ps, hd, quant)
    table = _table(rng, B, n, pages, idle=(2,))
    want = jax.jit(jdec._paged_view, static_argnums=(3,))(
        jnp.asarray(ck), None if ks is None else jnp.asarray(ks),
        jnp.asarray(table), jnp.float32)
    got = tdec._paged_view(_t(ck), None if ks is None else _t(ks),
                           _t(table), torch.float32)
    assert got.shape == (B, KV, n * ps, hd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not quant:
        assert torch.equal(got[1, :, 3 * ps:4 * ps],
                           _t(ck)[table[1, 3]])


def _jax_state(quant, slots, pages, rng):
    jcfg = jax_tiny_test(max_seq=64, dtype=jnp.float32)
    st = jpages.init_paged_slots(jcfg, slots, M, PS, pages, jnp.float32,
                                 8 if quant else 0)
    shape = st.cache.k.shape
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    ks = vs = None
    if quant:
        ck = np.clip(np.round(ck * 40), -127, 127).astype(np.int8)
        cv = np.clip(np.round(cv * 40), -127, 127).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)
    return jcfg, st, (ck, cv, ks, vs)


def _port_state(cfg, quant, slots, pages, arrays):
    st = init_paged_slots(cfg, slots, M, PS, pages, torch.float32,
                          8 if quant else 0)
    for dst, a in zip((st.cache.k, st.cache.v, st.cache.k_scale,
                       st.cache.v_scale), arrays):
        if a is not None:
            dst.copy_(_t(a))
    return st


@pytest.mark.parametrize("quant", [False, True])
def test_insert_paged_and_hydrate_equal_jax(setup, quant):
    """An insert with 2 shared leading pages (sent to scratch) and a
    hydrate of 3 pages (the last a copy-on-write source): pools, scales,
    slot vectors and the prefill cache equal the JAX functions'
    exactly."""
    cfg, _ = setup
    rng = np.random.default_rng(11)
    slots, pages, n = 3, 24, M // PS
    jcfg, jst, arrays = _jax_state(quant, slots, pages, rng)
    jst = jst._replace(cache=jst.cache._replace(
        k=jnp.asarray(arrays[0]), v=jnp.asarray(arrays[1]),
        **({} if not quant else {"k_scale": jnp.asarray(arrays[2]),
                                 "v_scale": jnp.asarray(arrays[3])})))
    st = _port_state(cfg, quant, slots, pages, arrays)
    L, KV, hd = cfg.n_layer, cfg.kv_heads, cfg.head_dim
    pk = rng.normal(size=(L, 1, KV, M, hd)).astype(np.float32)
    pv = rng.normal(size=(L, 1, KV, M, hd)).astype(np.float32)
    row = np.array([5, 9, 13, 2, 17, 0], np.int32)
    # hydrate: pages 5, 9 shared, 21 the copy-on-write source
    hyd = np.array([5, 9, 21, 0, 0, 0], np.int32)
    jcache = jdec.KVCache(k=jnp.asarray(pk), v=jnp.asarray(pv),
                          length=jnp.int32(0))
    jh = jax.jit(jpages.hydrate_cache)(jst, jcache, jnp.asarray(hyd),
                                       jnp.int32(3))
    cache = KVCache(_t(pk).clone(), _t(pv).clone(),
                    torch.zeros((), dtype=torch.int32))
    hydrate_cache(st, cache, hyd, 3)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jh.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jh.v))
    # insert the hydrated cache as a prefill of 37 tokens into slot 1
    jpf = jdec.GenCarry(tok=jnp.asarray([42], jnp.int32),
                        cache=jh._replace(length=jnp.int32(37)),
                        rng=jnp.zeros((1, 2), jnp.uint32),
                        done=jnp.asarray([False]))
    jins = jax.jit(jpages.insert_paged)(jst, jnp.int32(1), jpf,
                                        jnp.asarray(row), jnp.int32(2))
    gen = torch.Generator()
    pf = GenCarry(torch.tensor([42]), cache._replace(
        length=torch.tensor(37, dtype=torch.int32)), [gen],
        torch.tensor([False]))
    insert_paged(st, 1, pf, row, 2)
    c, jc = st.cache, jins.cache
    for got, want in ((c.k, jc.k), (c.v, jc.v), (c.k_scale, jc.k_scale),
                      (c.v_scale, jc.v_scale)):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy()[:, 1:],
                                      np.asarray(want)[:, 1:])
    np.testing.assert_array_equal(c.length.numpy(), np.asarray(jc.length))
    assert st.tok.tolist() == np.asarray(jins.tok).tolist()
    assert st.done.tolist() == np.asarray(jins.done).tolist()
    assert st.rng[1] is gen
    # the shared pages 5 and 9 kept their bytes
    for p in (5, 9):
        np.testing.assert_array_equal(c.k[:, p].numpy(), arrays[0][:, p])


# ------------------------------------------------------------- chunk plans
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_plan_chunks_skip_equals_jax(chunk):
    """Every prompt length 1-96 and every skip below it: the JAX plan."""
    prompt = np.arange(1, 97, dtype=np.int32)
    for P in range(1, 97):
        for skip in range(P):
            got = plan_chunks(prompt[:P], chunk, skip=skip)
            want = jax_plan_chunks(prompt[:P], chunk, skip=skip)
            assert [(g.start, g.final, g.last_index, g.true_len,
                     g.ids.tolist()) for g in got] == \
                [(w.start, w.final, w.last_index, w.true_len,
                  w.ids.tolist()) for w in want], (P, skip, chunk)
        with pytest.raises(ValueError, match="skip"):
            plan_chunks(prompt[:P], chunk, skip=P)


def test_plan_chunks_skip():
    p = np.arange(1, 40, dtype=np.int32)            # P=39
    base = plan_chunks(p, 16)
    skipped = plan_chunks(p, 16, skip=16)
    assert skipped[0].start == 16
    assert skipped[-1].final and skipped[-1].start == base[-1].start
    np.testing.assert_array_equal(skipped[-1].ids, base[-1].ids)
    assert all(c.size in (8, 16) for c in skipped)
    tail = plan_chunks(p, 16, skip=38)
    assert tail[-1].final and tail[-1].true_len == 39


# ---------------------------------------------------------- radix tree/pool
def test_radix_tree_match_register_cow():
    tree = RadixPrefixTree(4)
    a = np.arange(10, dtype=np.int32)               # 2 full blocks + tail 2
    assert tree.match(a) == ([], None)
    assert tree.register(a, np.asarray([5, 6, 7, 0], np.int32)) == [5, 6, 7]
    assert tree.match(a) == ([5, 6], (7, 2))        # tail: the COW source
    b = np.concatenate([a, np.arange(100, 104, dtype=np.int32)])
    assert tree.match(b) == ([5, 6], (7, 2))
    c = np.concatenate([a[:4], np.full(6, 99, np.int32)])
    assert tree.match(c) == ([5], None)
    assert len(tree) == 3


def test_page_pool_refcounts_eviction_and_release():
    pool = PagePool(pages=8, page_size=4, max_len=32)   # 7 usable, 8/slot
    a1 = pool.try_admit(np.arange(8, dtype=np.int32), 5, rid=1)   # 3 pages
    assert a1 is not None and a1.shared == 0 and a1.pages == 3
    pool.on_inserted(1, np.arange(8, dtype=np.int32))
    a2 = pool.try_admit(np.arange(8, dtype=np.int32), 5, rid=2)
    assert a2.shared == 2 and a2.skip == 7              # capped at P-1
    assert list(a2.row[:2]) == list(a1.row[:2])
    pool.release(1)
    assert pool.slot_refs[a1.row[0]] == 1               # rid=2 still on it
    pool.release(2)
    assert pool.tree_held == 2
    a3 = pool.try_admit(np.arange(100, 124, dtype=np.int32), 5, rid=3)
    assert a3 is not None and pool.evictions == 2
    a4 = pool.try_admit(np.arange(20, dtype=np.int32), 8, rid=4)
    assert a4 is None and pool.defers == 1
    pool.release(3)
    assert pool.try_admit(np.arange(20, dtype=np.int32), 8, rid=4)
    with pytest.raises(PagePoolExhausted, match="pool holds"):
        pool.check_submit(28, 5)                        # 8 pages > 7 usable
    with pytest.raises(ValueError, match="pages_per_slot"):
        pool.try_admit(np.arange(40, dtype=np.int32), 8, rid=9)
    snap = pool.snapshot()
    assert snap["pages"] == 8 and snap["prefix_sharing"]
    assert snap["prefill_tokens_saved"] >= 7


def test_page_pool_cow_pin_released_on_abort():
    """A request aborted between admission and insert releases its
    copy-on-write pin and every ref: no page leaks."""
    pool = PagePool(pages=16, page_size=4, max_len=32)
    a = np.arange(10, dtype=np.int32)
    pool.try_admit(a, 4, rid=1)
    pool.on_inserted(1, a)
    pool.release(1)
    b = np.concatenate([a, np.arange(50, 58, dtype=np.int32)])
    a2 = pool.try_admit(b, 4, rid=2)
    assert a2.cow and a2.cow_src is not None
    src = a2.cow_src
    assert pool.slot_refs[src] == 1                     # pinned
    pool.release(2)
    assert pool.slot_refs[src] == 0
    assert len(pool.free) + int(np.sum(pool.tree_refs)) == pool.usable


def test_pool_refuses_what_later_items_port():
    """The pool clock is ported (the KV tiers' demote-ahead reads it); the
    observability seams (item 7) and the fleet's residency probe (item
    6(c)) raise."""
    pool = PagePool(pages=4, page_size=8, max_len=16, clock=lambda: 0.0)
    assert pool.on_evict is None and pool.on_pages is None
    pool.on_evict = None
    with pytest.raises(NotImplementedError, match="item 7 "):
        pool.on_evict = print
    with pytest.raises(NotImplementedError, match="item 7 "):
        pool.on_pages = print
    with pytest.raises(NotImplementedError, match=r"part 6\(c\)"):
        pool.residency(np.arange(8))
    with pytest.raises(ValueError, match=">= 2 pages"):
        PagePool(pages=1, page_size=8, max_len=16)


def _alloc_view(a):
    if a is None:
        return None
    return (a.rid, a.row.tolist(), a.pages, a.shared, a.skip,
            a.hydrate_row.tolist(), a.hydrate_pages, a.cow, a.cow_src)


def _pool_script(pool_cls, exhausted, registry):
    """One scripted sequence through a pool: admissions that share, copy
    on write, defer and evict; inserts, releases, sheds. Returns the log
    of allocations, refcounts, free lists and snapshots."""
    pool = pool_cls(pages=14, page_size=4, max_len=32, registry=registry)
    rng = np.random.default_rng(13)
    sys_a = rng.integers(0, 50, 10).astype(np.int32)    # 2 blocks + tail 2
    sys_b = rng.integers(50, 99, 16).astype(np.int32)
    prompts = {
        1: sys_a, 2: np.concatenate([sys_a, [3, 4, 5]]),       # cow
        3: sys_b, 4: np.concatenate([sys_b[:8], [7] * 9]),     # 2 shared
        5: sys_a.copy(), 6: rng.integers(0, 99, 25).astype(np.int32),
        7: np.concatenate([sys_b, [1, 2]]), 8: sys_a[:3],
        9: rng.integers(0, 99, 20).astype(np.int32),
    }
    news = {1: 5, 2: 6, 3: 3, 4: 4, 5: 2, 6: 7, 7: 3, 8: 9, 9: 12}
    script = [("admit", 1), ("insert", 1), ("admit", 2), ("admit", 3),
              ("insert", 3), ("insert", 2), ("release", 1), ("admit", 4),
              ("insert", 4), ("admit", 5), ("shed", 60, 10), ("admit", 6),
              ("release", 2), ("release", 3), ("admit", 6), ("insert", 6),
              ("release", 5), ("admit", 7), ("release", 4), ("admit", 7),
              ("insert", 7), ("admit", 8), ("release", 6), ("release", 7),
              ("admit", 9), ("insert", 9), ("release", 8), ("admit", 2),
              ("insert", 2), ("release", 9), ("release", 2), ("shed", 4, 3)]
    log = []
    for op in script:
        if op[0] == "admit":
            a = pool.try_admit(prompts[op[1]], news[op[1]], rid=op[1])
            log.append(("admit", _alloc_view(a)))
        elif op[0] == "insert":
            pool.on_inserted(op[1], prompts[op[1]])
        elif op[0] == "release":
            pool.release(op[1])
        else:
            try:
                pool.check_submit(op[1], op[2])
                log.append(("fits",))
            except exhausted as e:
                log.append(("shed", e.pages_needed, e.pages_usable,
                            e.status.value))
        log.append((op, sorted(pool.free), pool.slot_refs.tolist(),
                    pool.tree_refs.tolist(), pool.generation,
                    pool.snapshot()))
    return log, pool.registry.snapshot()


def test_pool_scripted_sequence_equals_jax():
    """Both packages' PagePools through one scripted sequence (the same
    admissions, copy-on-write, releases, evictions, defers and sheds):
    equal allocations, refcounts, free lists, snapshots and Serve/page_*
    metrics after every operation."""
    got = _pool_script(PagePool, PagePoolExhausted, MetricsRegistry())
    want = _pool_script(JaxPagePool, JaxExhausted, JaxRegistry())
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, i
    kinds = {e[0] for e in got[0] if isinstance(e[0], str)}
    snap = got[0][-1][-1]
    assert {"admit", "shed", "fits"} <= kinds
    assert snap["cow_copies"] >= 1 and snap["evictions"] > 0
    assert snap["defers"] > 0 and snap["shared_page_acquires"] > 0
    assert got[1] == want[1]


def _drive_paged(sched_cls, stats_cls, pool_cls, script):
    """Both packages' Schedulers over their own PagePools, fed the same
    script on a fake clock; returns the event log and the registry."""
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    stats = stats_cls(clock=clock)
    pool = pool_cls(pages=6, page_size=4, max_len=24,
                    registry=stats.registry)
    sched = sched_cls(slots=2, max_len=24, prefill_chunk=8, max_queue=5,
                      eos_token_id=EOS, stats=stats, ttft_deadline_s=40.0,
                      pages=pool)
    rng = np.random.default_rng(5)
    log, reqs = [], {}
    for op in script:
        if op[0] == "submit":
            try:
                r = sched.submit((np.arange(op[1]) * op[3]) % 97,
                                 max_new=op[2], seed=op[3])
                reqs[r.rid] = r
                log.append(("submit", r.rid))
            except Exception as e:
                log.append(("refused", type(e).__name__,
                            getattr(e, "pages_needed", None)))
        elif op[0] == "admit":
            r = sched.pop_next()
            if r is None:
                log.append(("admit", None))
            else:
                plan = [(c.start, c.size) for c in sched.plan(r)]
                pool.on_inserted(r.rid, r.prompt)
                if r.max_new == 1:
                    sched.complete_at_prefill(r, first_tok=op[1])
                    log.append(("complete", r.rid, plan))
                else:
                    log.append(("place", r.rid, sched.place(r, op[1]),
                                plan, _alloc_view(r.page_alloc)))
        elif op[0] == "step":
            toks = rng.integers(0, 12, sched.slots)
            log.append(("step", [(r.rid, r.status.value) for r in
                                 sched.on_step(toks, toks == EOS)]))
        elif op[0] == "cancel":
            r = sched.cancel(op[1])
            log.append(("cancel", None if r is None else r.status.value))
        elif op[0] == "expire":
            log.append(("expire", [r.rid for r in
                                   sched.expire_deadlines(op[1])]))
        elif op[0] == "nonfinite":
            log.append(("nonfinite", [r.rid for r in
                                      sched.retire_nonfinite(op[1])]))
        elif op[0] == "requeue":
            r = sched.requeue(reqs[op[1]])
            log.append(("requeue", r.rid, r.status.value))
        log.append((pool.snapshot(), sorted(pool.free)))
    return log, stats.registry.snapshot()


def test_paged_scheduler_events_equal_jax():
    """Admissions that defer on a full pool and retry only when the pool's
    generation moves, sheds of requests the pool can never hold, skip
    plans of shared prompts, and page releases on every terminal path
    (complete, cancel, deadline, non-finite, requeue of a finished
    request): the same events and pool states in both packages."""
    script = [("submit", 9, 6, 1), ("submit", 9, 3, 1), ("submit", 12, 9, 3),
              ("submit", 20, 4, 4), ("submit", 5, 1, 5),
              ("submit", 30, 30, 6),
              ("admit", 11), ("admit", 12), ("admit", 13), ("step",),
              ("step",), ("step",), ("admit", 14), ("step",),
              ("nonfinite", [0]), ("admit", 15), ("admit", 15),
              ("cancel", 2), ("admit", 16), ("step",), ("step",),
              ("submit", 9, 3, 1), ("submit", 14, 2, 2), ("expire", 35.0),
              ("admit", 17), ("step",), ("requeue", 0), ("admit", 18),
              ("step",), ("step",), ("admit", 19), ("step",), ("step",),
              ("step",), ("step",), ("admit", 20), ("step",), ("step",),
              ("admit", 21), ("step",), ("step",), ("step",)]
    got = _drive_paged(Scheduler, ServingStats, PagePool, script)
    want = _drive_paged(JaxScheduler, JaxStats, JaxPagePool, script)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert ("refused", "PagePoolExhausted", 6) in got[0]
    snap = got[0][-1][0]
    assert snap["defers"] > 0 and snap["shared_page_acquires"] > 0


# ------------------------------------------------------------------ parity
_SHARED_SHAPES = [(21, 9), (40, 6), (3, 12), (33, 7), (16, 5)]


def _shared_stream(vocab, seed):
    """A ragged stream with prefix hits and copy-on-write: two turns of a
    conversation (the second extends the first past its partial tail
    block), a repeat of a prompt, a prompt sharing one block, a 3-token
    prompt that right-pads its bucket."""
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, vocab, 21).astype(np.int32)
    t2 = np.concatenate([t1, rng.integers(0, vocab, 19).astype(np.int32)])
    other = rng.integers(0, vocab, 33).astype(np.int32)
    return [(t1, 9, 0), (t2, 6, 1), (rng.integers(0, vocab, 3)
                                     .astype(np.int32), 12, 2),
            (other, 7, 3), (np.concatenate([t1[:PS], other[:8]]), 5, 4),
            (t1.copy(), 8, 5), (t2.copy(), 4, 6)]


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("name,max_len", [("tiny_test", M),
                                          ("llama2_tiny", M),
                                          ("bloom_tiny", 128),
                                          ("mixtral_tiny", M)])
def test_greedy_paged_tokens_equal_jax_serving_engine(name, max_len,
                                                      kv_bits):
    """The same weights and stream through both packages' paged
    ServingEngines, greedy, fp32, fp and int8 KV: identical tokens, prefix
    hits and copy-on-write included, and the same pool snapshot. The int8
    oracle is the JAX engine's actual tokens."""
    jm, jparams, tm, tparams = make_pair(name)
    serving = {"slots": 3, "max_len": max_len, "prefill_chunk": 16,
               "greedy": True, "page_size": PS, "kv_quant_bits": kv_bits}
    reqs = _shared_stream(tm.cfg.vocab_size, seed=17)
    args = [list(a) for a in zip(*reqs)]
    je = jds.init_inference(jm, jparams, {"dtype": "float32"})
    jsrv = jds.serving.ServingEngine(je, serving)
    want = jsrv.serve_batch(*args)
    te = dt.init_inference(tm, tparams, {"dtype": "float32"}, device="cpu")
    srv = ServingEngine(te, serving)
    got = srv.serve_batch(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"req {i}")
    snap = srv.pool.snapshot()
    assert snap == jsrv.pool.snapshot()
    assert snap["cow_copies"] >= 1 and snap["prefix_hit_rate"] > 0


def test_paged_serving_parity_and_slot_churn(setup):
    """Paged fp serving == contiguous serving, bit for bit, across a
    ragged mix with slot reuse; the same workload again rides the prefix
    tree (tokens saved) and still matches."""
    cfg, eng = setup
    reqs = _requests([(5, 9), (16, 12), (23, 6), (37, 10), (8, 4), (30, 3)],
                     seed=0)
    _, base = _serve(eng, reqs)
    srv, outs = _serve(eng, reqs, {"page_size": PS, "pool_pages": 64})
    for i, (a, b) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"req {i}")
    args = [list(a) for a in zip(*reqs)]
    for _ in range(2):
        for i, (a, b) in enumerate(zip(base, srv.serve_batch(*args))):
            np.testing.assert_array_equal(a, b, err_msg=f"shared req {i}")
    assert srv.captures == 0
    snap = srv.metrics_snapshot()["pages"]
    assert snap["prefill_tokens_saved"] > 0 and snap["prefix_hit_rate"] > 0
    assert snap["live_requests"] == 0
    g = srv.stats.registry.snapshot()["gauges"]
    assert g["Serve/page_pool_free"] >= 0
    assert g["Serve/page_prefix_hit_rate"] > 0


def test_paged_cow_multiturn_parity(setup):
    """Turn 2 extends turn 1's prompt past a partial tail block: the COW
    path copies the donor page into a fresh private page, and both turns
    equal the contiguous engine's tokens."""
    cfg, eng = setup
    rng = np.random.default_rng(3)
    t1 = rng.integers(0, 256, (21,)).astype(np.int32)
    t2 = np.concatenate([t1, rng.integers(0, 256, (9,)).astype(np.int32)])
    reqs = [(t1, 6, 11), (t2, 6, 12)]
    srv, outs = _serve(eng, reqs, {"page_size": PS, "pool_pages": 64},
                       slots=1)
    _, base = _serve(eng, reqs, slots=1)
    np.testing.assert_array_equal(outs[0], base[0])
    np.testing.assert_array_equal(outs[1], base[1])
    assert srv.pool.snapshot()["cow_copies"] == 1


@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny"])
def test_paged_idle_slot_past_max_len_writes_only_scratch(name):
    """Requests one at a time over three paged slots: each slot idles past
    max_len with its row on scratch, its writes clipped onto scratch; the
    served tokens equal the contiguous engine's and the pool's live pages
    hold no idle row's write."""
    _, _, tm, tparams = make_pair(name)
    eng = dt.init_inference(tm, tparams, {"dtype": "float32"}, device="cpu")
    serving = {"slots": 3, "max_len": 32, "prefill_chunk": 8, **SAMPLING}
    paged = ServingEngine(eng, {**serving, "page_size": PS})
    flat = ServingEngine(eng, serving)
    reqs = _requests([(4, 24), (6, 25), (3, 28), (5, 26), (4, 27)], seed=8,
                     vocab=tm.cfg.vocab_size)
    for p, n, s in reqs:
        a = paged.serve_batch([p], [n], [s])[0]
        np.testing.assert_array_equal(a, flat.serve_batch([p], [n], [s])[0])
    assert int(paged.state.cache.length.max()) > 64
    # the last retirement's cleared row reaches the device at the next
    # step, before any device work of it
    assert not paged._table.any()
    paged.step()
    assert int(paged.state.cache.page_table.abs().sum()) == 0


def _expire_while_admitting(eng, extra):
    """Request A decodes in slot 0 until its total deadline passes; in the
    iteration that expires it, one-chunk request B is admitted, prefilled
    and seated in slot 1 (on the pool, onto the pages A just freed: the
    free list is LIFO), and the decode step runs. Returns (A's tokens, B's
    tokens, the engine)."""
    t = {"now": 0.0}
    srv = ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 16,
                              **SAMPLING, **extra}, clock=lambda: t["now"])
    rng = np.random.default_rng(12)
    a = srv.submit(rng.integers(0, 256, (20,)).astype(np.int32), 20, seed=1,
                   total_deadline_s=100.0)
    while 0 not in srv.sched.running or len(srv.sched.running[0].tokens) < 8:
        srv.step()
    b = srv.submit(rng.integers(0, 256, (16,)).astype(np.int32), 12, seed=2)
    t["now"] = 200.0
    srv.step()
    assert srv.results[a].status is RequestStatus.TIMEOUT
    assert srv.sched.running[1].rid == b
    srv.drain()
    return srv.results[a].tokens, srv.results[b].tokens, srv


def test_paged_deadline_expiry_clears_row_before_admission(setup):
    """A running slot's deadline expires in the iteration that admits a
    one-chunk request onto the pages it freed: the expired slot's row is
    cleared before that iteration's flush, so its decode write lands on
    scratch and the new request's prompt KV is untouched. Both requests'
    tokens equal the contiguous engine's in the same scenario."""
    cfg, eng = setup
    a0, b0, _ = _expire_while_admitting(eng, {})
    a1, b1, srv = _expire_while_admitting(
        eng, {"page_size": PS, "pool_pages": 16, "prefix_sharing": False})
    np.testing.assert_array_equal(a1, a0)
    np.testing.assert_array_equal(b1, b0)
    assert len(a0) == 8 and len(b0) == 12
    assert srv.pool.snapshot()["free_pages"] == srv.pool.usable


def test_pool_exhaustion_shed_and_defer_fake_clock(setup):
    """A request the pool can never hold sheds typed at submit
    (PagePoolExhausted, status SHED); a transient shortage defers at the
    queue head and admits after a retirement frees pages; every page
    returns."""
    cfg, eng = setup
    t = {"now": 0.0}

    def clock():
        t["now"] += 0.01
        return t["now"]

    srv = ServingEngine(eng, {
        "slots": 2, "max_len": M, "prefill_chunk": 16, "greedy": True,
        "page_size": PS, "pool_pages": 6, "prefix_sharing": False},
        clock=clock)
    rng = np.random.default_rng(1)
    r1 = srv.submit(rng.integers(0, 256, (20,)).astype(np.int32), 12,
                    seed=1)                              # 4 pages
    r2 = srv.submit(rng.integers(0, 256, (18,)).astype(np.int32), 8,
                    seed=2)                              # 4 pages: defers
    with pytest.raises(PagePoolExhausted) as ei:
        srv.submit(rng.integers(0, 256, (41,)).astype(np.int32), 7)
    assert ei.value.status is RequestStatus.SHED
    assert ei.value.pages_needed == 6 and ei.value.pages_usable == 5
    seen = {}
    for _ in range(400):
        for req in srv.step():
            seen[req.rid] = req
        if len(seen) == 2:
            break
    assert seen[r1].ok and seen[r2].ok
    assert srv.pool.defers > 0
    assert srv.pool.snapshot()["free_pages"] == srv.pool.usable
    snap = srv.stats.registry.snapshot()
    assert snap["counters"]["Serve/page_defers"] >= 1
    assert snap["counters"]["Serve/shed"] == 1


def test_paged_guards_release_every_page(setup):
    """Cancel in the prefill lane (a copy-on-write pin held), cancel in a
    slot, a deadline, a requeue and a drain: afterwards every page is
    free or held by the tree alone, no allocation is live, and the
    surviving requests equal the contiguous engine's tokens."""
    cfg, eng = setup
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    extra = {"page_size": PS, "pool_pages": 20}
    srv = ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 8,
                              **SAMPLING, **extra}, clock=clock)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, 13).astype(np.int32)
    reqs = [(base, 6, 1), (np.concatenate([base, [9] * 20]), 8, 2),
            (rng.integers(0, 256, 9).astype(np.int32), 12, 3),
            (np.concatenate([base, [4] * 6]), 10, 4)]
    srv.serve_batch([base], [3], [0])        # the donor, in the tree
    rids = [srv.submit(p, n, seed=s) for p, n, s in reqs]
    srv.step()
    srv.step()                               # request 1 in its prefill
    assert srv._prefill[0].rid == rids[1]
    assert srv._prefill[0].page_alloc.cow
    assert srv.cancel(rids[1]).status is RequestStatus.CANCELLED
    while srv.sched.occupancy < 2:
        srv.step()
    assert srv.cancel(rids[0]).status is RequestStatus.CANCELLED
    late = srv.submit(reqs[2][0], 12, seed=5, total_deadline_s=3.0)
    done = srv.drain()
    assert done[late].status is RequestStatus.TIMEOUT
    srv.end_drain()
    req = srv.pop_result(rids[2])
    srv.requeue(req)
    srv.drain()
    assert req.ok and req.attempts == 1
    _, want = _serve(eng, [reqs[2], reqs[3]], slots=2,
                     sampling={**SAMPLING})
    np.testing.assert_array_equal(req.tokens, want[0])
    np.testing.assert_array_equal(done[rids[3]].tokens, want[1])
    snap = srv.pool.snapshot()
    assert snap["live_requests"] == 0
    assert snap["free_pages"] + snap["tree_held_pages"] == snap["usable_pages"]
    assert int(np.sum(srv.pool.slot_refs)) == 0


@pytest.mark.parametrize("serving,match", [
    ({"page_size": 7}, "page_size"),
    ({"page_size": 32}, "page_size"),            # does not divide 48
    ({"page_size": 8, "pool_pages": 1}, "pool_pages"),
    ({"page_size": 8, "kv_quant_bits": 4}, "kv_quant_bits"),
    ({"kv_quant_bits": 8}, "paged"),
])
def test_paged_config_validation(setup, serving, match):
    cfg, eng = setup
    with pytest.raises(ValueError, match=match):
        ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 16,
                            **serving})
    with pytest.raises(ValueError, match=match):
        InferenceConfig.from_any({"serving": {"slots": 2, "max_len": M,
                                              "prefill_chunk": 16,
                                              **serving}})


@pytest.mark.parametrize("serving,pool_pages", [
    ({"page_size": 8}, 1 + 3 * 6),                # auto: no sharing needed
    ({"page_size": 16, "pool_pages": 2}, 2),      # overcommit is legal
    ({"page_size": 8, "prefix_sharing": False, "kv_quant_bits": 8}, 19),
])
def test_paged_config_accepts_the_jax_keys(setup, serving, pool_pages):
    """The four keys of the JAX config are accepted and built: the pool's
    size (auto = 1 + slots * max_len / page_size), sharing, int8 KV."""
    cfg, eng = setup
    sc = ServingConfig.from_any({"slots": 3, "max_len": M,
                                 "prefill_chunk": 16, **serving})
    assert sc.pool_pages == pool_pages
    srv = ServingEngine(eng, sc)
    assert srv.pool.pages == pool_pages
    assert (srv.pool.tree is not None) == sc.prefix_sharing
    assert srv.state.cache.k.dtype == (torch.int8 if sc.kv_quant_bits
                                       else torch.float32)
    assert srv.metrics_snapshot()["pages"]["usable_pages"] == pool_pages - 1
