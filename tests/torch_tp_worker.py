"""The port's tensor- and expert-parallel ranks behind
``tests/test_torch_tp_dist.py``.

``spawn(world, port, out_dir)`` starts one ``gloo`` process per rank
(``device="cpu"``, one thread each); every rank runs every case of its
world through ``init_inference`` / ``ServingEngine`` with
``tensor_parallel`` / ``expert_parallel`` and writes what it saw (tokens,
prefill logits, its shard of every leaf, the speculative lane's tokens and
readouts, the KV tiers' tokens and counters) to
``<out_dir>/w<world>_rank<r>.pt``.
This module imports neither JAX nor the JAX package: the test process holds
the results against JAX.

Every case starts from fp32 weights the port draws from a seeded generator
(``initial_params``), which the test hands to the JAX engine too; the
``tp_comm_quant`` cases start from weights the test process trained
(``trained.pt`` in the output directory), as the JAX package's own
``tests/unit/test_tp_quant.py`` does.
"""

from __future__ import annotations

import os
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np
import torch

EOS = 1
M = 64              # serving max_len and the tp_comm_quant cache length
NEW = 6             # generate() tokens
GROUP = 16          # WOQ group size

# name -> (preset, args, overrides); vocabularies cut to keep the JAX
# side's tables small (ALiBi, the tied head and GQA are what they test), and
# llama2 tiny's FFN at 704 = 44 groups of 16: JAX shards a WOQ scale by
# whole groups, and 688 (43 groups) does not split over 2 or 4 devices
MODELS = {
    "tiny_test": ("tiny_test", (), {"max_seq": 64}),
    "llama2_tiny": ("llama2", ("tiny",), {"max_seq": 64, "vocab_size": 256,
                                          "d_ff": 704}),
    # the preset's 688: the port cuts w_out's rows off their groups and
    # dequantizes them at the point of use (JAX builds it at tp 1 only)
    "llama2_688": ("llama2", ("tiny",), {"max_seq": 64, "vocab_size": 256}),
    "bloom_tiny": ("bloom", ("tiny",), {"vocab_size": 256}),
    "opt_tiny": ("opt", ("tiny",), {"vocab_size": 512}),
    "parallel_rotary": ("tiny_test", (), dict(
        max_seq=64, parallel_residual=True, pos_embedding="rope",
        rotary_dim=8, activation="gelu_exact")),
    # tp 2 does not divide the vocabulary: the table and head stay whole
    "odd_vocab": ("tiny_test", (), {"max_seq": 64, "vocab_size": 257}),
    "mixtral_tiny": ("mixtral", ("tiny",), dict(
        vocab_size=256, n_layer=2, max_seq=64, moe_drop_tokens=False)),
    # test_tp_quant.py's trunks
    "tpq_tiny": ("tiny_test", (), {"max_seq": M}),
    "tpq_glu": ("tiny_test", (), {"max_seq": M, "activation": "silu_glu",
                                  "d_ff": 128}),
}

QUANT = {"dense": {},
         "int8": {"quantize": True, "quant_group_size": GROUP,
                  "woq_kernel": True},
         "int4": {"quantize": True, "quant_bits": 4,
                  "quant_group_size": GROUP, "woq_kernel": True}}

# world -> generate() cases: (model, quant, tensor_parallel, expert_parallel);
# every model dense and in one WOQ width a world, the first two in both
GEN = {
    2: [(m, q, 2, 1) for m in ("tiny_test", "llama2_tiny", "bloom_tiny",
                               "opt_tiny", "parallel_rotary")
        for q in ("dense", "int8")]
    + [(m, "int4", 2, 1) for m in ("tiny_test", "llama2_tiny")]
    + [("odd_vocab", "dense", 2, 1), ("llama2_688", "int8", 2, 1),
       ("mixtral_tiny", "dense", 1, 2)],
    4: [(m, q, 4, 1) for m in ("tiny_test", "llama2_tiny", "bloom_tiny",
                               "opt_tiny", "parallel_rotary")
        for q in ("dense", "int4")]
    + [(m, "int8", 4, 1) for m in ("tiny_test", "llama2_tiny")]
    + [("mixtral_tiny", "dense", 1, 4), ("mixtral_tiny", "dense", 2, 2),
       ("mixtral_tiny", "int8", 2, 2)],
}
# world -> the tp_comm_quant case: (model, prompts)
TPQ = {2: ("tpq_glu", 2), 4: ("tpq_tiny", 4)}
SERVING = {"slots": 3, "max_len": M, "prefill_chunk": 16}
SAMPLED = {**SERVING, "temperature": 0.9, "top_k": 30}
PAGE = 16
SPEC = {**SERVING, "greedy": True, "page_size": PAGE,
        "speculation": {"ngram": 3, "max_draft": 4}}
# the KV tiers: two sessions of TIER_PROMPT tokens alternating on a
# one-request pool, so every resume finds its prefix evicted into the tier
TIER_PROMPT = 48
TIER_NEW = 8
TIER_KINDS = ("host", "nvme")


def model_cfg(name: str):
    from deepspeed_tpu_torch.models import presets

    fn, args, kw = MODELS[name]
    return getattr(presets, fn)(*args, dtype=torch.float32, **kw)


def initial_params(name: str, seed: int = 7) -> dict:
    """The fp32 weights every side of a case starts from."""
    from deepspeed_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    return build_model(model_cfg(name)).init(gen, device="cpu",
                                              dtype=torch.float32)


def prompts(vocab: int, B: int = 2, S: int = 8, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def stream(vocab: int, n: int = 7, seed: int = 11) -> list:
    """(prompt, max_new, seed) of the ragged serving stream: prompts of
    1-40 tokens."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 41, n)
    news = rng.integers(2, 9, n)
    return [(rng.integers(0, vocab, int(P)).astype(np.int32), int(N), 70 + i)
            for i, (P, N) in enumerate(zip(lens, news))]


def spec_stream(vocab: int, n: int = 4, seed: int = 4) -> list:
    """(prompt, max_new, seed) of the speculation stream: half motif-tiled
    prompts with room for the drafter to learn the model's own output
    loop, half random (``tests/unit/test_speculation.py``'s ``_traffic``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            p = np.tile(rng.integers(0, 32, (4,)).astype(np.int32), 5)
            mn = int(rng.integers(10, 16))
        else:
            p = rng.integers(0, vocab, (int(rng.integers(5, 24)),)) \
                .astype(np.int32)
            mn = int(rng.integers(4, 12))
        out.append((p, mn, 100 + i))
    return out


def rank_page_bytes(world: int) -> int:
    """One pool page's K and V bytes on a rank of llama2 tiny at tp
    ``world`` (fp32): the rank's tier holds its own KV heads."""
    cfg = model_cfg("llama2_tiny")
    return 2 * cfg.n_layer * max(1, cfg.kv_heads // world) * PAGE * \
        cfg.head_dim * 4


def tier_serving(world: int, kind: str, path=None) -> dict:
    """The tier cases' serving config: ``host`` a host tier that holds
    everything; ``nvme`` a host tier of two rank pages over a disk rung
    under ``path``, so the host prunes spill down."""
    cfg = {**SERVING, "slots": 2, "greedy": True, "page_size": PAGE,
           "pool_pages": 1 + (TIER_PROMPT + TIER_NEW - 1 + PAGE - 1) // PAGE}
    if kind == "host":
        return {**cfg, "host_pool_bytes": 8 << 20}
    return {**cfg, "host_pool_bytes": 2 * rank_page_bytes(world),
            "nvme_pool_bytes": 64 << 20, "nvme_path": str(path)}


def tier_cycle(srv, vocab: int, rounds: int = 3, before=None) -> list:
    """Two sessions alternating, ``rounds`` turns each: the tokens of every
    request in order (the same driver for both packages' engines).
    ``before(round, session, prompt, srv)`` runs ahead of each submit."""
    rng = np.random.default_rng(21)
    sessions = [rng.integers(0, vocab, TIER_PROMPT).astype(np.int32)
                for _ in range(2)]
    toks = []
    for r in range(rounds):
        for s, p in enumerate(sessions):
            if before is not None:
                before(r, s, p, srv)
            rid = srv.submit(p, TIER_NEW, seed=10 * s + r)
            req = None
            for _ in range(100_000):
                req = srv.pop_result(rid)
                if req is not None:
                    break
                srv.step()
            toks.append(np.asarray(req.tokens, np.int32))
    return toks


def tier_cases(world, rank, out_dir: Path) -> dict:
    """The KV tiers under tensor parallelism: each rank's tier holds its
    own KV-head shard; tokens, counters and a tile's shape."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    name = "llama2_tiny"
    cfg = model_cfg(name)
    eng = dt.init_inference(build_model(cfg), initial_params(name),
                            conf("dense", world, 1), device="cpu")
    out = {}
    for kind in TIER_KINDS:
        srv = dt.ServingEngine(eng, tier_serving(
            world, kind, out_dir / f"nvme_w{world}_r{rank}"))
        toks = tier_cycle(srv, cfg.vocab_size)
        snap = srv.tier_snapshot()
        ent = next(iter(srv.hostkv.entries.values()))
        out[kind] = {"tokens": toks, "snapshot": snap,
                     "tile_shape": ent["tiles"]["k"].shape,
                     "pool_kv_heads": srv.state.cache.k.shape[2]}
        srv.close()
    # a fallback on the last rank alone: its host copy of session 0's
    # second block is corrupted before that session's first resume, so
    # its match stops a block short of the other ranks'
    srv = dt.ServingEngine(eng, tier_serving(world, "host"))
    out["host_fault"] = {
        "tokens": tier_cycle(srv, cfg.vocab_size, before=partial(
            corrupt_second_block, rank == world - 1)),
        "snapshot": srv.tier_snapshot()}
    try:
        dt.ServingEngine(eng, {**tier_serving(world, "host"),
                               "demote_ahead_idle_s": 1.0})
        out["ahead_refused"] = ""
    except NotImplementedError as e:
        out["ahead_refused"] = str(e)
    return out


def corrupt_second_block(here: bool, r: int, s: int, prompt, srv) -> None:
    """``tier_cycle``'s hook: where ``here``, flip one K value of the host
    copy of session 0's second block before its first resume."""
    from deepspeed_tpu_torch.observability.workload import token_hash

    if not (here and r == 1 and s == 0):
        return
    toks = tuple(int(t) for t in prompt[:2 * PAGE])
    ent = srv.hostkv.entries[(len(toks), token_hash(toks))]
    ent["tiles"]["k"].reshape(-1)[0] += 1.0


def psum_partials(world: int) -> list:
    """Each rank's partial for the int8_psum comparison."""
    return [(np.random.default_rng(100 + r).standard_normal((3, 3000))
             * (1 + r)).astype(np.float32) for r in range(world)]


def conf(quant: str, tp: int, ep: int, **over) -> dict:
    return {"dtype": "float32", "tensor_parallel": tp,
            "expert_parallel": ep, **QUANT[quant], **over}


def _numpy(leaf):
    if hasattr(leaf, "q"):
        return (leaf.q.numpy().copy(), leaf.scale.numpy().copy(), leaf.row0)
    return leaf.numpy().copy()


def gen_case(name, quant, tp, ep) -> dict:
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.decode import (forward_with_cache,
                                                      init_cache)
    from deepspeed_tpu_torch.models import build_model

    cfg = model_cfg(name)
    eng = dt.init_inference(build_model(cfg), initial_params(name),
                            conf(quant, tp, ep), device="cpu")
    ids = prompts(cfg.vocab_size)
    out = {"tokens": eng.generate(ids, NEW, greedy=True).numpy(),
           "shards": {k: _numpy(v) for k, v in eng.params.items()}}
    if quant == "dense":
        with torch.inference_mode():
            cache = init_cache(cfg, ids.shape[0], 16, torch.float32,
                               kv_heads=eng.layout.kv_heads)
            logits, _ = forward_with_cache(eng.model, eng.params,
                                           torch.as_tensor(ids).long(), cache)
        out["logits"] = logits.numpy()
    return out


def serve_cases(world) -> dict:
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    name = "llama2_tiny"
    cfg = model_cfg(name)
    eng = dt.init_inference(build_model(cfg), initial_params(name),
                            conf("dense", world, 1), device="cpu")
    reqs = stream(cfg.vocab_size)
    out = {}
    for key, scfg in (("contiguous", {**SERVING, "greedy": True}),
                      ("paged", {**SERVING, "greedy": True,
                                 "page_size": PAGE}),
                      ("sampled", SAMPLED)):
        srv = dt.ServingEngine(eng, scfg)
        got = srv.serve_batch([p for p, _, _ in reqs],
                              [n for _, n, _ in reqs],
                              [s for _, _, s in reqs])
        out[key] = [g.copy() for g in got]
        if key == "paged":
            out["pool_k_shape"] = tuple(srv.state.cache.k.shape)
    out["spec"] = spec_serve(eng, spec_stream(cfg.vocab_size))
    return out


def spec_serve(eng, reqs) -> dict:
    """The speculative lane over the paged pool: tokens, the readout, and
    whether every page came back."""
    import deepspeed_tpu_torch as dt

    srv = dt.ServingEngine(eng, SPEC)
    got = srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                          [s for _, _, s in reqs])
    ps = srv.pool.snapshot()
    return {"tokens": [g.copy() for g in got],
            "snapshot": srv.spec_snapshot(),
            "pages_back": ps["free_pages"] + ps["tree_held_pages"]
            == ps["usable_pages"]}


def spec_ep_case(world) -> dict:
    """The tiny Mixtral's experts over ``expert_parallel`` = world, the
    speculative lane paged."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    name = "mixtral_tiny"
    cfg = model_cfg(name)
    eng = dt.init_inference(build_model(cfg), initial_params(name),
                            conf("dense", 1, world), device="cpu")
    return spec_serve(eng, spec_stream(cfg.vocab_size))


def tpq_case(world, out_dir: Path) -> dict:
    """``tp_comm_quant: 8`` on the trained trunk, greedy, eos 1, as
    ``tests/unit/test_tp_quant.py:69-96``; the gauge of a ServingEngine."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    name, n = TPQ[world]
    saved = torch.load(out_dir / "trained.pt", weights_only=False)
    cfg = model_cfg(name)
    eng = dt.init_inference(build_model(cfg), saved[name]["params"],
                            conf("dense", world, 1, tp_comm_quant=8,
                                 eos_token_id=EOS), device="cpu")
    toks = [eng.generate(p[None], 10, greedy=True, request_seeds=[7 + i],
                         cache_len=M).numpy()
            for i, p in enumerate(saved[name]["prompts"][:n])]
    srv = dt.ServingEngine(eng, {**SERVING, "greedy": True})
    # the speculative lane: its verify (T > 1) reduces at full precision
    # while its plain steps take the int8 wire, as JAX's does
    prompts_ = [np.tile(p[:4], 5) for p in saved[name]["prompts"][:n]]
    spec = spec_serve(eng, [(p, 12, i) for i, p in enumerate(prompts_)])
    return {"tokens": toks,
            "gauge": srv.metrics_snapshot().get("tp_quant_bits"),
            "spec": spec}


def psum_case(world, rank) -> dict:
    from deepspeed_tpu_torch.comm.compressed import int8_psum
    from deepspeed_tpu_torch.platform.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(data=1, model=world))
    x = torch.from_numpy(psum_partials(world)[rank])
    return {"sum": int8_psum(x, "model", mesh=mesh).numpy()}


def _run(rank, world, port, out_dir):
    torch.set_num_threads(1)
    os.environ.setdefault("DSTPU_LOG_LEVEL", "WARNING")
    import torch.distributed as dist

    from deepspeed_tpu_torch.platform.distributed import init_distributed

    out_dir = Path(out_dir)
    res = {}
    t0 = time.perf_counter()
    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
        res["psum"] = psum_case(world, rank)
        res["gen"] = {case: gen_case(*case) for case in GEN[world]}
        res["serve"] = serve_cases(world)
        res["tpq"] = tpq_case(world, out_dir)
        res["spec_ep"] = spec_ep_case(world)
        res["tier"] = tier_cases(world, rank, out_dir)
        res["seconds"] = time.perf_counter() - t0
        print(f"tp worker w{world} r{rank}: {res['seconds']:.1f} s",
              flush=True)
    except BaseException:
        res = {"error": traceback.format_exc()}
    torch.save(res, out_dir / f"w{world}_rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(world: int, port: int, out_dir):
    """Start the ranks; returns the processes (see :func:`join`)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(r, world, port, str(out_dir)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout: float) -> None:
    """Wait for every rank; if one dies or the time runs out, stop them
    all (a dead rank leaves the others waiting in a collective)."""
    end = time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        if time.monotonic() > end or any(
                p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.join(5)
