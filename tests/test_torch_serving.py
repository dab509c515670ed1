"""deepspeed_tpu_torch's ServingEngine (serving/: slots, scheduler, engine)
against the JAX package's, and against the port's own solo generate().

Oracles, on the CPU in fp32:
- chunk plans and scheduler event sequences (admission, placement,
  retirement, statuses, Serve/* values under a fake clock) equal the JAX
  package's;
- greedy serving tokens equal the JAX ServingEngine's on the same weights
  and stream (learned positions, RoPE with GQA, ALiBi; right-padded final
  buckets among the prompts);
- sampled serving equals the port's solo ``generate(request_seeds=[s],
  cache_len=max_len)`` token for token (``jax.random``'s bits cannot be
  reproduced, so this oracle stays inside the port);
- the JAX serving oracles of ``tests/unit/test_serving.py`` and the guard
  oracles of ``tests/unit/test_resilience.py``, run against the port;
- an idle slot whose length runs past ``max_len`` changes no live row.

Chunked prefill is held to the whole prefill at 1e-5 absolute on the cache
(fp32, matmuls of other shapes sum in another order; observed 0 to ~1e-7).
"""

from functools import partial

import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.observability.tracing import ServingStats as JaxStats
from deepspeed_tpu.resilience.guards import QueueFullError as JaxQueueFullError
from deepspeed_tpu.serving import Scheduler as JaxScheduler
from deepspeed_tpu.serving import plan_chunks as jax_plan_chunks
from deepspeed_tpu_torch.inference.config import (_SERVING_LATER,
                                                  InferenceConfig,
                                                  ServingConfig)
from deepspeed_tpu_torch.inference.decode import (cache_layout,
                                                  forward_with_cache,
                                                  init_cache, prefill_tokens)
from deepspeed_tpu_torch.inference.sampling import (per_request_generators,
                                                    sample_logits)
from deepspeed_tpu_torch.models import build_model, tiny_test
from deepspeed_tpu_torch.observability.tracing import ServingStats
from deepspeed_tpu_torch.resilience.guards import (QueueFullError,
                                                   RequestStatus)
from deepspeed_tpu_torch.serving import (Scheduler, ServingEngine,
                                         init_slots, insert_request,
                                         plan_chunks)

from test_torch_model import make_pair  # a test module of this directory
from torch_one_thread import one_torch_thread  # noqa: F401

M = 48          # slot capacity used across these tests
EOS = 7
CACHE_ATOL = 1e-5
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


def _solo(eng, prompt, max_new, seed, cache_len=M):
    """The oracle: one request through the public generate() with its
    seed and the serving cache length."""
    return eng.generate(prompt[None], max_new, request_seeds=[seed],
                        cache_len=cache_len, **SAMPLING)[0].numpy()


def _check_parity(eng, reqs, outs, cache_len=M):
    for (p, mn, s), got in zip(reqs, outs):
        want = _solo(eng, p, mn, s, cache_len)
        n = len(got)
        assert 1 <= n <= mn
        np.testing.assert_array_equal(got, want[:n])
        # serving stops at eos; the solo row's tail must be pure eos
        assert np.all(want[n:] == EOS)
        if n < mn:
            assert got[-1] == EOS


def _requests(shapes, seed, vocab=256, seed0=100):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (P,)).astype(np.int32), N, seed0 + i)
            for i, (P, N) in enumerate(shapes)]


def _fake_clock():
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    return t, clock


# ------------------------------------------------------------- chunk plans
@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_plan_chunks_equal_jax(chunk):
    """Every prompt length 1-300: the same chunks as the JAX planner."""
    prompt = np.arange(1, 301, dtype=np.int32)
    for P in range(1, 301):
        got = plan_chunks(prompt[:P], chunk)
        want = jax_plan_chunks(prompt[:P], chunk)
        assert len(got) == len(want), P
        for g, w in zip(got, want):
            assert (g.start, g.final, g.last_index, g.true_len) == \
                (w.start, w.final, w.last_index, w.true_len), (P, chunk)
            np.testing.assert_array_equal(g.ids, w.ids)


def test_plan_chunks_buckets():
    p = np.arange(1, 24, dtype=np.int32)       # P=23, chunk 8
    plans = plan_chunks(p, 8)
    assert [c.size for c in plans] == [8, 8, 8]      # 2 full + residual 7→8
    assert [c.start for c in plans] == [0, 8, 15]    # overlap rewinds to 15
    assert plans[-1].final and plans[-1].true_len == 23
    assert plans[-1].last_index == 7
    np.testing.assert_array_equal(plans[-1].ids, p[15:23])
    short = plan_chunks(np.arange(1, 6, dtype=np.int32), 8)   # P=5 → pad
    assert len(short) == 1 and short[0].size == 8
    assert short[0].last_index == 4 and short[0].true_len == 5
    assert np.all(short[0].ids[5:] == 0)
    with pytest.raises(ValueError, match="empty"):
        plan_chunks(np.zeros(0, np.int32), 8)


# ------------------------------------------------------------------ parity
def test_ragged_workload_parity(setup):
    """Every request's sampled tokens == solo generate() with the same
    seed, across prompt-length regimes (pad bucket, one chunk, overlap,
    multi-chunk) and interleaved admissions/retirements."""
    cfg, eng = setup
    srv = ServingEngine(eng, {"slots": 3, "max_len": M, "prefill_chunk": 16,
                              **SAMPLING})
    reqs = _requests([(5, 9), (16, 12), (23, 6), (37, 10), (8, 4), (30, 3),
                      (12, 17), (19, 8)], seed=0)
    outs = srv.serve_batch(*map(list, zip(*reqs)))
    _check_parity(eng, reqs, outs)
    # a second mix on the same engine: the CPU never graphs
    rev = [(p, n, s + 50) for p, n, s in reqs][::-1]
    _check_parity(eng, rev, srv.serve_batch(*map(list, zip(*rev))))
    assert srv.captures == 0 and srv.graph is None
    snap = srv.metrics_snapshot()
    assert snap["retired"] == 16 and snap["submitted"] == 16
    assert snap["ttft_s"]["count"] == 16


def test_slot_reuse_no_stale_kv(setup):
    """One slot, sequential requests: each reuses the retired slot and
    still matches its solo run; an insert overwrites the slot's FULL cache
    extent and nothing else."""
    cfg, eng = setup
    srv = ServingEngine(eng, {"slots": 1, "max_len": M, "prefill_chunk": 16,
                              **SAMPLING})
    reqs = _requests([(20, 8), (6, 10), (33, 5)], seed=3, seed0=7)
    _check_parity(eng, reqs, srv.serve_batch(*map(list, zip(*reqs))))

    state = init_slots(cfg, 2, M, torch.float32)
    state.cache.k.fill_(1e9)
    state.cache.v.fill_(-1e9)
    smp = partial(sample_logits, **SAMPLING)
    with torch.no_grad():
        pf = prefill_tokens(eng.model, eng.params,
                            torch.as_tensor(reqs[0][0][None]).long(),
                            per_request_generators([1], "cpu"), max_new=4,
                            sampler=smp, eos_token_id=EOS, cache_len=M)
    insert_request(state, 1, pf)
    assert torch.equal(state.cache.k[:, 1], pf.cache.k[:, 0])
    assert torch.equal(state.cache.v[:, 1], pf.cache.v[:, 0])
    assert int(state.cache.length[1]) == 20
    assert state.tok[1] == pf.tok[0] and state.rng[1] is pf.rng[0]
    # the untouched slot keeps its (poisoned) bytes — insert is slot-local
    assert float(state.cache.k[:, 0].max()) == 1e9


def test_chunked_prefill_matches_whole(setup):
    """Replaying a prompt through the bucket-shaped chunk plan gives the
    whole-prompt prefill's cache (within CACHE_ATOL) and first token."""
    cfg, eng = setup
    rng = np.random.default_rng(5)
    smp = partial(sample_logits, **SAMPLING)
    for P in (5, 16, 23, 37):           # pad, exact, overlap, multi-chunk
        prompt = rng.integers(0, 256, (P,)).astype(np.int32)
        with torch.no_grad():
            whole = prefill_tokens(eng.model, eng.params,
                                   torch.as_tensor(prompt[None]).long(),
                                   per_request_generators([42], "cpu"),
                                   max_new=4, sampler=smp, eos_token_id=EOS,
                                   cache_len=M)
            cache = init_cache(cfg, 1, M, torch.float32)
            gens = per_request_generators([42], "cpu")
            for ch in plan_chunks(prompt, 16):
                cache = cache._replace(length=torch.tensor(ch.start,
                                                           dtype=torch.int32))
                logits, cache = forward_with_cache(
                    eng.model, eng.params,
                    torch.as_tensor(ch.ids[None]).long(), cache,
                    last_token_head=True,
                    last_index=ch.last_index if ch.final else None)
            tok = smp(logits[:, -1], gens)
        # the LIVE extent [0, P): a right-padded bucket leaves pad KV at
        # positions >= P, masked and later overwritten
        np.testing.assert_allclose(cache.k[:, :, :, :P].numpy(),
                                   whole.cache.k[:, :, :, :P].numpy(),
                                   atol=CACHE_ATOL, rtol=0,
                                   err_msg=f"chunked cache drift, P={P}")
        np.testing.assert_allclose(cache.v[:, :, :, :P].numpy(),
                                   whole.cache.v[:, :, :, :P].numpy(),
                                   atol=CACHE_ATOL, rtol=0)
        assert int(tok[0]) == int(whole.tok[0]), f"first token drift, P={P}"


@pytest.mark.parametrize("name,max_len", [("tiny_test", M),
                                          ("llama2_tiny", M),
                                          ("bloom_tiny", 128),
                                          ("mixtral_tiny", 128)])
def test_greedy_tokens_equal_jax_serving_engine(name, max_len):
    """The same weights and ragged stream through both packages'
    ServingEngines, greedy: identical tokens. Prompts of 3 and 5 tokens
    right-pad their final bucket. At max_len 128 the port serves once more
    with flash_decode on: its decode through the decode-attention wrapper
    (the plain version on the CPU)."""
    jm, jparams, tm, tparams = make_pair(name)
    je = jds.init_inference(jm, jparams, {"dtype": "float32"})
    serving = {"slots": 3, "max_len": max_len, "prefill_chunk": 16,
               "greedy": True}
    reqs = _requests([(5, 9), (19, 6), (3, 12), (33, 7), (16, 5)], seed=11,
                     vocab=tm.cfg.vocab_size)
    args = [list(a) for a in zip(*reqs)]
    want = jds.serving.ServingEngine(je, serving).serve_batch(*args)
    for flash in (False, True) if max_len % 128 == 0 else (False,):
        te = dt.init_inference(tm, tparams, {"dtype": "float32",
                                             "flash_decode": flash},
                               device="cpu")
        got = ServingEngine(te, serving).serve_batch(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- scheduler
def test_scheduler_fake_clock():
    """Admission/retirement order and Serve/* accounting, no device."""
    t, clock = _fake_clock()
    stats = ServingStats(clock=clock)
    sched = Scheduler(slots=2, max_len=32, prefill_chunk=8, stats=stats)
    r1 = sched.submit(np.arange(4), max_new=3, seed=1)
    r2 = sched.submit(np.arange(6), max_new=1, seed=2)
    r3 = sched.submit(np.arange(5), max_new=2, seed=3)
    assert sched.queue_depth == 3
    assert sched.pop_next() is r1
    assert sched.place(r1, first_tok=11) == 0
    assert sched.pop_next() is r2
    sched.complete_at_prefill(r2, first_tok=9)     # max_new=1: never a slot
    assert r2.finished and r2.tokens == [9]
    assert sched.pop_next() is r3
    assert sched.place(r3, first_tok=12) == 1
    assert sched.pop_next() is None                # no slots free
    fin = sched.on_step(np.array([21, 22]), np.array([False, False]))
    assert fin == [r3] and sched.free == [1]
    fin = sched.on_step(np.array([7, 0]), np.array([True, False]))
    assert fin == [r1] and sorted(sched.free) == [0, 1]
    assert r1.tokens == [11, 21, 7]
    snap = stats.snapshot()
    assert (snap["submitted"], snap["admitted"], snap["retired"],
            snap["completed_tokens"]) == (3, 3, 3, 6)
    assert snap["ttft_s"]["count"] == 3 and snap["ttft_s"]["p50"] >= 1.0
    with pytest.raises(ValueError, match="exceeds the slot capacity"):
        sched.submit(np.arange(30), max_new=10, seed=0)
    with pytest.raises(ValueError, match="max_new"):
        sched.submit(np.arange(3), max_new=0, seed=0)


def _drive(sched_cls, stats_cls, full_error, script):
    """Run one scripted stream through a scheduler on a fake clock; return
    its event log and its Serve/* registry snapshot."""
    _, clock = _fake_clock()
    stats = stats_cls(clock=clock)
    sched = sched_cls(slots=3, max_len=40, prefill_chunk=8, max_queue=6,
                      eos_token_id=EOS, stats=stats, ttft_deadline_s=30.0,
                      total_deadline_s=60.0)
    log, reqs = [], {}
    rng = np.random.default_rng(21)
    for op in script:
        if op[0] == "submit":
            try:
                r = sched.submit(np.arange(op[1]), max_new=op[2], seed=op[3])
                reqs[r.rid] = r
                log.append(("submit", r.rid, r.deadline_ttft,
                            r.deadline_total))
            except full_error as e:
                log.append(("shed", e.queue_depth, e.status.value))
            except ValueError as e:
                log.append(("refused", str(e)))
        elif op[0] == "admit":
            r = sched.pop_next()
            if r is None:
                log.append(("admit", None))
            elif r.max_new == 1:
                sched.complete_at_prefill(r, first_tok=op[1])
                log.append(("complete", r.rid))
            else:
                log.append(("place", r.rid, sched.place(r, op[1])))
        elif op[0] == "step":
            toks = rng.integers(0, 12, sched.slots)
            dones = toks == EOS
            log.append(("step", [(r.rid, r.slot, r.status.value)
                                 for r in sched.on_step(toks, dones)]))
        elif op[0] == "cancel":
            r = sched.cancel(op[1])
            log.append(("cancel", None if r is None else r.status.value))
        elif op[0] == "expire":
            log.append(("expire", [(r.rid, r.error) for r in
                                   sched.expire_deadlines(op[1])]))
        elif op[0] == "nonfinite":
            log.append(("nonfinite", [r.rid for r in
                                      sched.retire_nonfinite(op[1])]))
        elif op[0] == "requeue":
            r = sched.requeue(reqs[op[1]])
            log.append(("requeue", r.rid, r.attempts, r.status.value))
    log.append(("final", sorted((r.rid, r.status.value, list(r.tokens),
                                 r.finish_t) for r in reqs.values()),
                sorted(sched.free), sched.queue_depth))
    return log, stats.registry.snapshot()


def test_scheduler_events_equal_jax():
    """Both packages' Schedulers, fed the same submits and the same fake
    (tok, done) arrays on a fake clock: the same admissions, placements,
    retirements, statuses and Serve/* values."""
    script = [("submit", 5, 6, 1), ("submit", 3, 1, 2), ("submit", 7, 9, 3),
              ("submit", 30, 20, 4), ("submit", 4, 12, 5),
              ("admit", 11), ("admit", 12), ("admit", 13), ("admit", 14),
              ("step",), ("step",), ("submit", 2, 3, 6), ("submit", 2, 3, 7),
              ("submit", 2, 3, 8), ("submit", 2, 3, 9), ("submit", 2, 3, 10),
              ("submit", 2, 3, 11), ("submit", 2, 3, 12), ("cancel", 4),
              ("cancel", 99),
              ("admit", 15), ("step",), ("nonfinite", [0, 2]), ("step",),
              ("admit", 16), ("admit", 17), ("expire", 40.0), ("step",),
              ("requeue", 0), ("admit", 18), ("step",), ("step",),
              ("expire", 75.0), ("admit", 19), ("step",), ("step",),
              ("admit", 20), ("step",), ("step",), ("step",)]
    got = _drive(Scheduler, ServingStats, QueueFullError, script)
    want = _drive(JaxScheduler, JaxStats, JaxQueueFullError, script)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_serving_config_validation(setup):
    cfg, eng = setup
    with pytest.raises(ValueError, match="power of two"):
        ServingEngine(eng, {"slots": 2, "max_len": 32, "prefill_chunk": 12})
    with pytest.raises(ValueError, match="unknown serving config"):
        ServingEngine(eng, {"slotz": 2})
    with pytest.raises(ValueError, match="learned-position"):
        ServingEngine(eng, {"slots": 2, "max_len": 128, "prefill_chunk": 16})
    c = InferenceConfig.from_any({"serving": {"slots": 4, "max_len": 64}})
    assert c.serving.slots == 4 and c.serving.max_len == 64
    # the engine reads its InferenceConfig's serving section by default
    model = build_model(tiny_test(max_seq=64, dtype=torch.float32))
    e2 = dt.init_inference(model, eng.params, {
        "dtype": "float32", "serving": {"slots": 2, "max_len": 32,
                                        "prefill_chunk": 8}}, device="cpu")
    assert ServingEngine(e2).state.tok.shape == (2,)
    flashy = dt.init_inference(model, eng.params, {
        "dtype": "float32", "flash_decode": True}, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        ServingEngine(flashy, {"slots": 2, "max_len": 48, "prefill_chunk": 8})
    with pytest.raises(NotImplementedError, match="item 6"):
        ServingEngine(eng, {"slots": 2, "max_len": 32}, programs={})


@pytest.mark.parametrize("key", sorted(_SERVING_LATER))
def test_deferred_serving_keys_raise_naming_their_item(key):
    default, item = _SERVING_LATER[key]
    value = {"enabled": True} if default is None else \
        (not default) if isinstance(default, bool) else default + 1
    # an item split into parts (6(c): the fleet) names its part too
    named = f"item {item} " if isinstance(item, int) else \
        rf"item {item[0]} .*part {item[0]}\({item[1]}\) "
    with pytest.raises(NotImplementedError, match=named):
        ServingConfig.from_any({"slots": 2, key: value})
    with pytest.raises(NotImplementedError, match=named):
        InferenceConfig.from_any({"serving": {key: value}})
    # the JAX default is accepted, so a JAX config ports as it is
    assert ServingConfig.from_any({key: default}) == ServingConfig()


# --------------------------------------------------- decode_chunk and seeds
def test_decode_chunk_early_stop_parity(setup):
    """generate() with decode_chunk > 0: identical tokens; the max_new ==
    1 edge with per-request seeds too."""
    cfg, eng = setup
    ids = np.random.default_rng(1).integers(0, 256, (2, 8))
    chunked = dt.init_inference(eng.model, eng.params, {
        "dtype": "float32", "eos_token_id": EOS, "decode_chunk": 4},
        device="cpu")
    assert torch.equal(chunked.generate(ids, 12, greedy=True),
                       eng.generate(ids, 12, greedy=True))
    assert torch.equal(
        chunked.generate(ids, 1, temperature=0.7, request_seeds=[4, 5]),
        eng.generate(ids, 1, temperature=0.7, request_seeds=[4, 5]))


def test_per_request_seeds_batch_invariant(setup):
    """The same request samples identically alone and in a static batch
    when keyed by request_seeds."""
    cfg, eng = setup
    ids = np.random.default_rng(2).integers(0, 256, (3, 10))
    full = eng.generate(ids, 6, request_seeds=[31, 32, 33], **SAMPLING)
    for i, s in enumerate([31, 32, 33]):
        solo = eng.generate(ids[i:i + 1], 6, request_seeds=[s], **SAMPLING)
        assert torch.equal(full[i], solo[0])
    with pytest.raises(ValueError, match="request_seeds"):
        eng.generate(ids, 4, request_seeds=[1, 2])


def test_cache_layout_single_source(setup):
    cfg, eng = setup
    shape, dtype = cache_layout(cfg, 5, 32)
    assert shape == (cfg.n_layer, 5, cfg.kv_heads, 32, cfg.head_dim)
    one = init_cache(cfg, 5, 32)
    state = init_slots(cfg, 5, 32)
    assert one.k.shape == state.cache.k.shape == shape
    assert one.k.dtype == state.cache.k.dtype == dtype
    assert state.cache.length.shape == (5,) and one.length.shape == ()
    assert state.done.all() and len(state.rng) == 5


# -------------------------------------------------------------- idle slots
@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny"])
def test_idle_slot_past_max_len_changes_no_live_row(name):
    """Requests one at a time over three slots: each slot idles through
    two other requests' decodes, more than ``max_len`` steps, its length
    running past the cache and (learned positions) past the position
    table. Its writes clamp to the last position; every live request's
    tokens still equal its solo generate()."""
    _, _, tm, tparams = make_pair(name)
    eng = dt.init_inference(tm, tparams, {"dtype": "float32"}, device="cpu")
    max_len = 32
    srv = ServingEngine(eng, {"slots": 3, "max_len": max_len,
                              "prefill_chunk": 8, **SAMPLING})
    reqs = _requests([(4, 24), (6, 25), (3, 28), (5, 26), (4, 27)], seed=8,
                     vocab=tm.cfg.vocab_size)
    outs, idle_max = [], 0
    for p, n, s in reqs:
        outs += srv.serve_batch([p], [n], [s])
        idle_max = max(idle_max, int(srv.state.cache.length.max()))
    assert idle_max > 2 * max_len
    for (p, n, s), got in zip(reqs, outs):
        want = eng.generate(p[None], n, request_seeds=[s], cache_len=max_len,
                            **SAMPLING)[0].numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- typed guards
def test_queue_full_is_typed_and_counted():
    t, clock = _fake_clock()
    stats = ServingStats(clock=clock)
    sched = Scheduler(slots=1, max_len=32, prefill_chunk=8, max_queue=2,
                      stats=stats)
    sched.submit(np.arange(3), 2)
    sched.submit(np.arange(3), 2)
    with pytest.raises(QueueFullError) as ei:
        sched.submit(np.arange(3), 2)
    assert ei.value.status is RequestStatus.SHED
    assert ei.value.queue_depth == 2 and ei.value.max_queue == 2
    assert isinstance(ei.value, RuntimeError)
    assert stats.snapshot()["shed"] == 1


def test_deadlines_fire_under_fake_clock():
    t, clock = _fake_clock()
    stats = ServingStats(clock=clock)
    sched = Scheduler(slots=1, max_len=64, prefill_chunk=8, stats=stats,
                      ttft_deadline_s=10.0, total_deadline_s=50.0)
    runner = sched.submit(np.arange(4), max_new=8, seed=1)
    waiter = sched.submit(np.arange(4), max_new=8, seed=2)
    vip = sched.submit(np.arange(4), max_new=4, seed=3,
                       ttft_deadline_s=500.0, total_deadline_s=500.0)
    assert vip.deadline_ttft == pytest.approx(vip.submit_t + 500.0)
    assert vip.deadline_total == pytest.approx(vip.submit_t + 500.0)
    assert sched.pop_next() is runner
    sched.place(runner, first_tok=11)
    assert sched.expire_deadlines(now=t["now"]) == []
    assert sched.expire_deadlines(now=waiter.submit_t + 15.0) == [waiter]
    assert waiter.status is RequestStatus.TIMEOUT and "ttft" in waiter.error
    assert sched.expire_deadlines(now=runner.submit_t + 60.0) == [runner]
    assert runner.status is RequestStatus.TIMEOUT and sched.free == [0]
    assert [r.rid for r in sched.queue] == [vip.rid]
    snap = stats.snapshot()
    assert snap["timeout"] == 2 and snap["aborted"] == 2


def test_cancel_from_queue_and_slot():
    t, clock = _fake_clock()
    sched = Scheduler(slots=1, max_len=32, prefill_chunk=8,
                      stats=ServingStats(clock=clock))
    a = sched.submit(np.arange(3), 4, seed=1)
    b = sched.submit(np.arange(3), 4, seed=2)
    sched.pop_next()
    sched.place(a, first_tok=5)
    assert sched.cancel(b.rid) is b and b.status is RequestStatus.CANCELLED
    assert sched.cancel(a.rid) is a and a.status is RequestStatus.CANCELLED
    assert sched.free == [0] and sched.idle
    assert sched.cancel(999) is None
    c = sched.submit(np.arange(3), 1, seed=3)
    sched.pop_next()
    sched.complete_at_prefill(c, first_tok=2)
    assert c.status is RequestStatus.OK and c.ok


def test_engine_guards_cancel_requeue_deadlines_and_drain(setup):
    """Through the engine: a request cancelled in its prefill and one
    cancelled in its slot leave the others' tokens unchanged; a requeued
    request reruns to its solo tokens; deadlines retire with TIMEOUT; a
    draining engine sheds; pop_result collects once."""
    cfg, eng = setup
    t, clock = _fake_clock()
    srv = ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 8,
                              **SAMPLING}, clock=clock)
    reqs = _requests([(20, 10), (6, 12), (9, 11), (5, 8)], seed=4)
    rids = [srv.submit(p, n, seed=s) for p, n, s in reqs]
    srv.step()                             # request 0: first of 3 chunks
    assert srv.cancel(rids[0]).status is RequestStatus.CANCELLED
    while srv.sched.occupancy < 2:
        srv.step()
    assert srv.cancel(rids[1]).status is RequestStatus.CANCELLED
    done = srv.drain()
    assert set(done) == set(rids)
    for (p, n, s), rid in list(zip(reqs, rids))[2:]:
        assert done[rid].ok
        np.testing.assert_array_equal(done[rid].tokens, _solo(eng, p, n, s))
    with pytest.raises(QueueFullError, match="draining"):
        srv.submit(reqs[0][0], 4)
    srv.end_drain()
    req = srv.pop_result(rids[2])
    assert req is not None and srv.pop_result(rids[2]) is None
    srv.requeue(req)
    assert req.status is RequestStatus.REQUEUED and req.attempts == 1
    srv.drain()
    assert req.ok
    np.testing.assert_array_equal(req.tokens, _solo(eng, *reqs[2]))
    srv.end_drain()
    late = srv.submit(reqs[3][0], 8, seed=1, total_deadline_s=4.0)
    srv.drain()
    assert srv.results[late].status is RequestStatus.TIMEOUT
    assert srv.metrics_snapshot()["timeout"] == 1


def test_nonfinite_row_retires_alone(setup, monkeypatch):
    """The logit guard: a NaN in one slot's logits retires that request
    with NONFINITE before its token is appended; the other slot's tokens
    stay those of its solo run."""
    cfg, eng = setup
    srv = ServingEngine(eng, {"slots": 2, "max_len": M, "prefill_chunk": 8,
                              **SAMPLING})
    reqs = _requests([(6, 10), (9, 10)], seed=6)
    rids = [srv.submit(p, n, seed=s) for p, n, s in reqs]
    while srv.sched.occupancy < 2:
        srv.step()
    forward = srv._forward_slots

    def poisoned():
        lg, ok = forward()
        lg[1] = float("nan")
        return lg, ok & torch.tensor([True, False])

    monkeypatch.setattr(srv, "_forward_slots", poisoned)
    srv.step()
    monkeypatch.setattr(srv, "_forward_slots", forward)
    done = srv.drain()
    assert done[rids[1]].status is RequestStatus.NONFINITE
    assert done[rids[0]].ok
    np.testing.assert_array_equal(done[rids[0]].tokens, _solo(eng, *reqs[0]))
