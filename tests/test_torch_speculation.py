"""deepspeed_tpu_torch's self-speculative decoding (inference/speculation.py,
the ServingEngine's draft / verify / commit lane, Scheduler.on_spec_step and
PagePool.truncate) against the JAX package's, on the CPU in fp32.

Oracles (``tests/unit/test_speculation.py``'s, held against both packages):
- the n-gram drafter: ``NGramTable`` extend / predict / draft equal the JAX
  table's on seeded random streams, a draft is a pure read, and
  ``acceptance_stats`` equals JAX's;
- greedy spec-on serving tokens equal the JAX engine's spec-on tokens and
  the port's own spec-off tokens, bit for bit: contiguous, paged, paged
  with int8 KV, multi-turn paged sessions with prefix sharing, WOQ int8 and
  int4 (``woq_kernel`` on: the kernels' plain versions on the CPU), a tiny
  Mixtral (held to JAX's spec-on run: its T > 1 verify routes through the
  training dispatch); the speculation readout equals JAX's;
- the verify forward's logits at each position are within 1e-5 of max
  |logit| of the plain step's, teacher-forced from one state;
- ``PagePool.truncate``: pages freed, rows, refcounts, free list and
  generation equal to JAX's pool after the same calls;
- with the host KV tier (a one-request pool, every resume restored):
  spec-on tokens equal spec-off's and JAX's spec-on tokens;
- speculation off: no readout, no ``speculation`` key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.speculation import NGramTable as JaxTable
from deepspeed_tpu.inference.speculation import \
    SpeculationConfig as JaxSpecConfig
from deepspeed_tpu.inference.speculation import \
    acceptance_stats as jax_acceptance_stats
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.serving import PagePool as JaxPagePool
from deepspeed_tpu_torch.inference.config import (InferenceConfig,
                                                  ServingConfig)
from deepspeed_tpu_torch.inference.speculation import (NGramTable,
                                                       SpeculationConfig,
                                                       acceptance_stats)
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.models import tiny_test
from deepspeed_tpu_torch.serving import PagePool, ServingEngine
from deepspeed_tpu_torch.serving.pages import _SCRATCH

from torch_one_thread import one_torch_thread  # noqa: F401

M = 64          # slot capacity
PS = 8          # page size
EOS = 7
SPEC = {"ngram": 3, "max_draft": 4}
LOGIT_SHARE = 1e-5


def _traffic(seed=0, n=6, vocab=256):
    """JAX's ``_traffic``: half motif-tiled (n-gram-predictable) prompts
    with room for the drafter to learn the model's own output loop, half
    random, so drafts are mostly accepted and mostly rejected."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            p = np.tile(rng.integers(0, 32, (4,)).astype(np.int32), 5)
            mn = int(rng.integers(10, 16))
        else:
            p = rng.integers(0, min(vocab, 256),
                             (int(rng.integers(5, 24)),)).astype(np.int32)
            mn = int(rng.integers(4, 12))
        reqs.append((p, mn, 100 + i))
    return reqs


def _serving(extra=None, slots=3):
    return {"slots": slots, "max_len": M, "prefill_chunk": 16,
            "greedy": True, **(extra or {})}


def _serve(srv, reqs):
    return srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                           [s for _, _, s in reqs])


# name -> (preset, args, overrides) of both packages; the 32000-token
# vocabularies cut to 256, where a random tiny model falls into the output
# loops the drafter learns (at 32000 its streams draft nothing)
MODELS = {
    "tiny_test": ("tiny_test", (), {"max_seq": M}),
    "llama2_tiny": ("llama2", ("tiny",), {"max_seq": M, "vocab_size": 256}),
    "bloom_tiny": ("bloom", ("tiny",), {}),
    "opt_tiny": ("opt", ("tiny",), {"vocab_size": 256}),
    "mixtral_tiny": ("mixtral", ("tiny",), {"max_seq": M,
                                            "vocab_size": 256}),
}
_PAIRS: dict = {}


def _engines(name, conf=None):
    """(JAX InferenceEngine, port InferenceEngine) on one JAX init of
    ``name``, converted for the port; eos 7, fp32."""
    key = (name, tuple(sorted((conf or {}).items())))
    if key not in _PAIRS:
        fn, args, kw = MODELS[name]
        jm = jax_build(getattr(jax_presets, fn)(*args, dtype=jnp.float32,
                                                **kw))
        tcfg = getattr(torch_presets, fn)(*args, dtype=torch.float32, **kw)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        c = {"dtype": "float32", "eos_token_id": EOS, **(conf or {})}
        _PAIRS[key] = (
            jds.init_inference(jm, jax.tree.map(jnp.asarray, tree), c),
            dt.init_inference(build_model(tcfg), params_from_jax(tree, tcfg),
                              c, device="cpu"))
    return _PAIRS[key]


def _assert_streams_equal(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: request {i}")


# ------------------------------------------------------------ the drafter
def test_ngram_table_extend_predict_draft():
    for cls in (NGramTable, JaxTable):
        tab = cls(2)
        assert tab.predict() is None            # context not yet full
        tab.extend([1, 2, 3, 1, 2])
        assert tab.predict() == 3               # (1, 2) -> 3
        tab.extend([9])                         # (2, 9): unseen context
        assert tab.predict() is None
        tab2 = cls(2)
        tab2.extend([1, 2, 3, 1, 2, 4, 1, 2])
        assert tab2.predict() == 4              # the latest occurrence wins
    with pytest.raises(ValueError, match="ngram"):
        NGramTable(0)


def test_ngram_draft_chains_and_is_pure():
    tab = NGramTable(2)
    tab.extend([5, 6, 7, 5, 6, 7, 5, 6])
    d = tab.draft(4)
    assert d == [7, 5, 6, 7]                    # the period-3 loop
    assert tab.draft(2) == [7, 5]               # the cap holds
    assert tab.draft(4) == d                    # a pure read
    assert tab.predict() == 7 and len(tab) == 3
    tab3 = NGramTable(2)
    tab3.extend([1, 2, 3])
    assert tab3.draft(4) == [] and tab3.draft(0) == []


@pytest.mark.parametrize("ngram", [1, 2, 3, 4])
def test_ngram_tables_equal_jax_on_random_streams(ngram):
    """Fed the same seeded streams in the same pieces, the port's table
    predicts and drafts what JAX's does after every piece."""
    rng = np.random.default_rng(20 + ngram)
    for _ in range(20):
        toks = rng.integers(0, 6, int(rng.integers(1, 80))).tolist()
        a, b = NGramTable(ngram), JaxTable(ngram)
        cuts = sorted(rng.integers(0, len(toks) + 1, 3).tolist())
        for lo, hi in zip([0] + cuts, cuts + [len(toks)]):
            a.extend(toks[lo:hi])
            b.extend(toks[lo:hi])
            assert a.predict() == b.predict()
            for k in (1, 4, 7):
                assert a.draft(k) == b.draft(k)
            assert len(a) == len(b)


def test_acceptance_stats_equals_jax():
    rng = np.random.default_rng(11)
    for _ in range(60):
        toks = rng.integers(0, 12, (int(rng.integers(2, 60)),)).tolist()
        for n in (1, 3):
            assert acceptance_stats(toks, n) == jax_acceptance_stats(toks, n)
    st = acceptance_stats([1, 2, 1, 2, 1, 2, 1], 2)
    assert st["scored"] == 5 and st["hits"] == st["predicted"] == 3
    assert acceptance_stats([1, 2, 3], 3) is None


# -------------------------------------------------------------- the config
def test_speculation_config_validation():
    cfg = SpeculationConfig.from_any({"ngram": 2, "max_draft": 6})
    assert (cfg.ngram, cfg.max_draft, cfg.enabled) == (2, 6, True)
    jcfg = JaxSpecConfig.from_any({"ngram": 2, "max_draft": 6})
    assert (cfg.ngram, cfg.max_draft, cfg.enabled) == \
        (jcfg.ngram, jcfg.max_draft, jcfg.enabled)
    assert SpeculationConfig.from_any(cfg) is cfg
    with pytest.raises(ValueError, match="ngram"):
        SpeculationConfig.from_any({"ngram": 0})
    with pytest.raises(ValueError, match="max_draft"):
        SpeculationConfig.from_any({"max_draft": 0})
    with pytest.raises(ValueError, match="unknown speculation"):
        SpeculationConfig.from_any({"ngrams": 3})
    with pytest.raises(TypeError):
        SpeculationConfig.from_any(3)
    # the serving key is accepted, in both config shapes
    s = ServingConfig.from_any({"slots": 2, "speculation": SPEC})
    assert isinstance(s.speculation, SpeculationConfig)
    assert s.speculation.max_draft == 4
    c = InferenceConfig.from_any({"serving": {"speculation": {"ngram": 2}}})
    assert c.serving.speculation.ngram == 2
    assert ServingConfig.from_any({"speculation": None}) == ServingConfig()


def test_spec_requires_greedy_and_dense_attention():
    model = build_model(tiny_test(max_seq=128, dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    eng = dt.init_inference(model, params, {"dtype": "float32"},
                            device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 16,
                            "temperature": 0.8, "speculation": SPEC})
    # temperature 0 is greedy
    ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 16,
                        "temperature": 0.0, "speculation": SPEC})
    flashy = dt.init_inference(model, params, {"dtype": "float32",
                                               "flash_decode": True},
                               device="cpu")
    with pytest.raises(ValueError, match="flash"):
        ServingEngine(flashy, {"slots": 2, "max_len": 128,
                               "prefill_chunk": 16, "greedy": True,
                               "speculation": SPEC})
    # disabled: the plain lane, and no refusal
    off = ServingEngine(flashy, {"slots": 2, "max_len": 128,
                                 "prefill_chunk": 16, "temperature": 0.5,
                                 "speculation": {"enabled": False}})
    assert off.spec_snapshot() is None


# ------------------------------------------------------------------ parity
LAYOUTS = {"contiguous": {}, "paged": {"page_size": PS},
           "paged_kv8": {"page_size": PS, "kv_quant_bits": 8}}
PARITY = [("tiny_test", "contiguous"), ("tiny_test", "paged"),
          ("tiny_test", "paged_kv8"), ("llama2_tiny", "paged"),
          ("bloom_tiny", "contiguous"), ("opt_tiny", "paged")]


@pytest.mark.parametrize("name,layout", PARITY,
                         ids=[f"{n}-{lay}" for n, lay in PARITY])
def test_spec_greedy_tokens_equal_jax_and_spec_off(name, layout):
    """Port spec-on == JAX spec-on == port spec-off, bit for bit, on one
    stream of repetitive and random requests; the readouts agree; a paged
    pool ends with every page free or held by the tree (the rejected
    drafts' tail leaked no page)."""
    je, te = _engines(name)
    reqs = _traffic(seed=1, vocab=te.model.cfg.vocab_size)
    spec = _serving({**LAYOUTS[layout], "speculation": SPEC})
    jsrv = jds.serving.ServingEngine(je, spec)
    want = _serve(jsrv, reqs)
    srv = ServingEngine(te, spec)
    got = _serve(srv, reqs)
    _assert_streams_equal(got, want, "spec-on vs JAX spec-on")
    _assert_streams_equal(
        _serve(ServingEngine(te, _serving(LAYOUTS[layout])), reqs), got,
        "spec-off vs spec-on")
    snap = srv.spec_snapshot()
    assert snap == jsrv.spec_snapshot()
    assert snap["verify_steps"] > 0 and snap["accepted_tokens"] > 0
    assert snap["accepted_tokens_per_step"] > 1.0
    assert srv.metrics_snapshot()["speculation"] == snap
    assert srv.verify_captures == 0 and srv.captures == 0   # the CPU
    if srv.pool is not None:
        ps = srv.pool.snapshot()
        assert ps["free_pages"] + ps["tree_held_pages"] == ps["usable_pages"]
        assert ps == jsrv.pool.snapshot()


@pytest.mark.parametrize("bits", [8, 4])
def test_spec_woq_tokens_equal_jax_and_spec_off(bits):
    """WOQ int8 / int4 weights, every projection and the head through
    ``woq_dot(use_kernel=True)`` (the plain versions on the CPU), paged."""
    je, te = _engines("tiny_test", {"quantize": True, "quant_bits": bits,
                                     "quant_group_size": 32,
                                     "woq_kernel": True})
    assert te.model.woq_kernel
    reqs = _traffic(seed=5)
    spec = _serving({"page_size": PS, "speculation": SPEC})
    want = _serve(jds.serving.ServingEngine(je, spec), reqs)
    srv = ServingEngine(te, spec)
    got = _serve(srv, reqs)
    _assert_streams_equal(got, want, "spec-on vs JAX spec-on")
    _assert_streams_equal(
        _serve(ServingEngine(te, _serving({"page_size": PS})), reqs), got,
        "spec-off vs spec-on")
    assert srv.spec_snapshot()["accepted_tokens"] > 0


def test_spec_multiturn_paged_sessions_parity():
    """Turn t + 1 replays turn t's whole conversation (the prompt grows by
    the engine's own reply): prefix sharing hits, the drafter tracks the
    adopted prefix, and the rollback keeps the tree reusable. Port spec-on
    equals port spec-off and JAX spec-on every turn."""
    je, te = _engines("tiny_test")

    def run(make, extra, jax_side):
        srv = make({"slots": 2, "max_len": M, "prefill_chunk": 16,
                    "greedy": True, "page_size": PS, **extra})
        rng = np.random.default_rng(4)
        toks = []
        for s in range(2):                          # two sessions
            hist = np.tile(rng.integers(0, 32, (4,)).astype(np.int32), 3) \
                if s == 0 else rng.integers(0, 256, (9,)).astype(np.int32)
            for t in range(3):                      # three turns each
                kw = {"session_id": f"s{s}"} if jax_side else {}
                rid = srv.submit(hist, 8, seed=10 * s + t, **kw)
                out = None
                for _ in range(10_000):
                    out = srv.pop_result(rid)
                    if out is not None:
                        break
                    srv.step()
                toks.append(list(out.tokens))
                hist = np.concatenate([hist,
                                       np.asarray(out.tokens, np.int32)])
        return srv, toks

    _, want = run(lambda c: jds.serving.ServingEngine(je, c),
                  {"speculation": SPEC}, True)
    srv, got = run(lambda c: ServingEngine(te, c), {"speculation": SPEC},
                   False)
    _, off = run(lambda c: ServingEngine(te, c), {}, False)
    assert got == want and got == off
    assert srv.spec_snapshot()["verify_steps"] > 0
    ps = srv.pool.snapshot()
    assert ps["prefix_hit_rate"] > 0
    assert ps["free_pages"] + ps["tree_held_pages"] == ps["usable_pages"]


def test_spec_parity_with_host_kv_restore():
    """``tests/unit/test_speculation.py``'s tier composition: two sessions
    alternating on a one-request pool, so each retirement's prefix is
    evicted into the host tier and every resume restores from it; a paged
    retirement off a verify step truncates, then demotes. Rejection-heavy
    traffic (2-gram drafts off a barely repetitive stream): nearly every
    verify truncates. Spec-on tokens equal spec-off's and JAX's spec-on
    tokens, with >= 2 restores."""
    je, te = _engines("tiny_test")
    pool = 1 + (20 + 10 - 1 + PS - 1) // PS

    def cycle(make, extra):
        srv = make({"slots": 2, "max_len": M, "prefill_chunk": 16,
                    "greedy": True, "page_size": PS, "pool_pages": pool,
                    "host_pool_bytes": 8 << 20, **extra})
        rng = np.random.default_rng(6)
        A = np.tile(rng.integers(0, 32, (4,)).astype(np.int32), 5)
        B = rng.integers(0, 256, (20,)).astype(np.int32)
        toks = []
        for r in range(3):
            for s, p in enumerate((A, B)):
                rid = srv.submit(p, 10, seed=100 * s + r)
                out = None
                for _ in range(100_000):
                    out = srv.pop_result(rid)
                    if out is not None:
                        break
                    srv.step()
                toks.append(list(out.tokens))
        return srv, toks

    spec = {"speculation": {"ngram": 2, "max_draft": 4}}
    _, base = cycle(lambda c: ServingEngine(te, c), {})
    srv, outs = cycle(lambda c: ServingEngine(te, c), spec)
    _, want = cycle(lambda c: jds.serving.ServingEngine(je, c), spec)
    assert base == outs and outs == want
    assert srv.tier_snapshot()["restores"] >= 2
    assert srv.spec_snapshot()["proposed_tokens"] > 0
    ps = srv.pool.snapshot()
    assert ps["free_pages"] + ps["tree_held_pages"] == ps["usable_pages"]


def test_spec_moe_tokens_equal_jax_spec_on():
    """A tiny Mixtral: at T > 1 the verify takes the training dispatch, not
    the T = 1 step's one-group dispatch (as JAX), so its tokens are held
    to JAX's spec-on run."""
    je, te = _engines("mixtral_tiny")
    reqs = _traffic(seed=3, n=4)
    spec = _serving({"page_size": PS, "speculation": SPEC}, slots=2)
    jsrv = jds.serving.ServingEngine(je, spec)
    want = _serve(jsrv, reqs)
    srv = ServingEngine(te, spec)
    _assert_streams_equal(_serve(srv, reqs), want, "MoE spec-on vs JAX")
    assert srv.spec_snapshot() == jsrv.spec_snapshot()
    assert srv.spec_snapshot()["verify_steps"] > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_logits_equal_the_plain_steps(layout):
    """From one state with every slot decoding, max_draft + 1 plain slot
    steps, then (the state reset) one verify forward fed the plain lane's
    own next tokens as drafts: the verify's logits at position j are the
    plain step j's within 1e-5 of max |logit|, and its winners are the
    plain lane's tokens."""
    _, te = _engines("llama2_tiny")
    K = SPEC["max_draft"]
    srv = ServingEngine(te, _serving({**LAYOUTS[layout],
                                      "speculation": SPEC}))
    rng = np.random.default_rng(8)
    for i in range(3):
        srv.submit(rng.integers(0, 256, 10 + 7 * i).astype(np.int32), 30,
                   seed=i)
    while srv.sched.occupancy < 3:
        srv.step()
    st = srv.state
    marks = (st.cache.length.clone(), st.tok.clone(), st.done.clone())
    carry = st.tok.clone()
    plain, toks = [], []
    for _ in range(K + 1):
        lg, _ = srv.slot_step(graphed=False)
        plain.append(lg[:, 0].clone())
        toks.append(st.tok.clone())
    with torch.inference_mode():
        for t, m in zip((st.cache.length, st.tok, st.done), marks):
            t.copy_(m)
    assert torch.equal(st.tok, carry)
    drafts = torch.stack(toks[:K], dim=1)
    lg, back = srv.verify_step(drafts.numpy(), graphed=False)
    want = torch.stack(plain, dim=1)
    assert lg.shape == want.shape == (3, K + 1, te.model.cfg.vocab_size)
    assert (lg - want).abs().max() <= LOGIT_SHARE * want.abs().max()
    assert torch.equal(back[:, :-1], torch.stack(toks, dim=1))
    assert bool(back[:, -1].all())
    assert torch.equal(st.cache.length, marks[0] + K + 1)


def test_idle_rows_past_the_cache_write_no_live_row():
    """Idle slots' lengths keep growing past max_len (as in JAX); at
    T = max_draft + 1 their clamped writes land on one position of their
    own row (contiguous) or on scratch (paged), raise nothing, and leave
    the live rows' tokens equal to a spec-off run's."""
    _, te = _engines("tiny_test")
    reqs = _traffic(seed=1)[:1] + [(np.tile(np.arange(3, dtype=np.int32),
                                            6), 12, 5)]
    for layout in ("contiguous", "paged"):
        srv = ServingEngine(te, _serving({**LAYOUTS[layout],
                                          "speculation": SPEC}))
        with torch.inference_mode():
            srv.state.cache.length.fill_(M + 3)     # every slot idle, past
        got = _serve(srv, reqs)
        want = _serve(ServingEngine(te, _serving(LAYOUTS[layout])), reqs)
        _assert_streams_equal(got, want, layout)
        assert srv.spec_snapshot()["verify_steps"] > 0


# --------------------------------------------------------- paged rollback
def _pool_view(pool, rids):
    return ([(r, pool._alloc[r].row.tolist(), pool._alloc[r].pages,
              pool._alloc[r].shared) for r in rids if r in pool._alloc],
            pool.slot_refs.tolist(), pool.tree_refs.tolist(),
            sorted(pool.free), pool.generation)


def test_truncate_frees_whole_pages_and_keeps_mid_block_tail():
    pools = [cls(pages=16, page_size=4, max_len=32)
             for cls in (PagePool, JaxPagePool)]
    for pool in pools:
        a = pool.try_admit(np.arange(12, dtype=np.int32), 9, rid=1)
        assert a.pages == 5                 # ceil((12 + 9 - 1) / 4)
        gen = pool.generation
        assert pool.truncate(1, 8) == 3 and a.pages == 2
        assert all(int(p) == _SCRATCH for p in a.row[2:5])
        assert pool.generation == gen + 1
        # a mid-block tail: 7 tokens keep ceil(7 / 4) = 2 pages
        assert pool.truncate(1, 7) == 0 and a.pages == 2
    assert _pool_view(pools[0], [1]) == _pool_view(pools[1], [1])
    for pool in pools:
        pool.release(1)
        assert len(pool.free) + int(np.sum(pool.tree_refs)) == pool.usable
    assert _pool_view(pools[0], [1]) == _pool_view(pools[1], [1])


def test_truncate_never_drops_shared_prefix_pages():
    pools = [cls(pages=16, page_size=4, max_len=32)
             for cls in (PagePool, JaxPagePool)]
    p = np.arange(8, dtype=np.int32)
    for pool in pools:
        pool.try_admit(p, 5, rid=1)
        pool.on_inserted(1, p)
        pool.release(1)                     # 2 full blocks into the tree
        a2 = pool.try_admit(p, 5, rid=2)
        assert a2.shared == 2 and a2.pages == 3
        shared = [int(x) for x in a2.row[:2]]
        assert pool.truncate(2, 0) == 1     # only the private page frees
        assert a2.pages == 2
        for pg in shared:
            assert pool.slot_refs[pg] == 1 and pool.tree_refs[pg]
    assert _pool_view(pools[0], [2]) == _pool_view(pools[1], [2])
    for pool in pools:
        pool.release(2)
        assert len(pool.free) + int(np.sum(pool.tree_refs)) == pool.usable
    assert _pool_view(pools[0], [2]) == _pool_view(pools[1], [2])


def test_truncate_then_append_round_trip_refcounts():
    """Rollback then regrow: truncated rows reacquire pages through the
    admission path with refcounts equal to JAX's at every step."""
    pools = [cls(pages=16, page_size=4, max_len=32)
             for cls in (PagePool, JaxPagePool)]
    for r in range(3):
        for pool in pools:
            assert pool.try_admit(np.arange(10, dtype=np.int32), 7,
                                  rid=r) is not None
            pool.truncate(r, 10 - r)        # varying committed extents
        assert _pool_view(pools[0], [r]) == _pool_view(pools[1], [r])
        for pool in pools:
            pool.release(r)
            assert len(pool.free) + int(np.sum(pool.tree_refs)) \
                == pool.usable
        assert _pool_view(pools[0], [r]) == _pool_view(pools[1], [r])
    for pool in pools:
        assert pool.truncate(99, 4) == 0    # an unknown rid: nothing


# ---------------------------------------------------------- off by default
def test_spec_off_engine_reports_no_speculation():
    je, te = _engines("tiny_test")
    srv = ServingEngine(te, _serving())
    _serve(srv, _traffic(seed=3, n=2))
    assert srv.spec_snapshot() is None
    assert "speculation" not in srv.metrics_snapshot()
    assert srv.verify_graph is None and srv.verify_captures == 0
    assert srv._decode_emitted == srv._decode_slot_steps > 0

