"""One-off measurements of the serving path on an H100, outside
``chip_smoke.py``'s phases (whose helpers they reuse):

- ``paged_view_probe()``: the paged view's gather at phase 11's slot step
  as 8-byte words (``_paged_view``) against an element-wise gather, in
  turns, K and V of one layer, device time;
- ``parity_probe()``: where phase 11b's int8 served tokens part from a solo
  ``generate()`` and why: the four paths to the parting step (chunked or
  whole prefill, then slot steps at B 8 or decode steps at B 1), each
  path's top-two logit gap there against an fp32 forward's, decode
  attention's split at B 8 against B 1, and the chunked prefill against the
  whole one layer by layer and op by op;
- ``tp_graph_probe()``: what a world of one over NCCL puts on the
  device for the slot step's collectives, eager and captured in a CUDA
  graph: the profiler's device records of an in-place all-reduce and an
  all-gather, each issued eagerly and replayed, and the replay's values;
- ``profile_count_probe()``: how often phase 11's profiled window of
  graph replays misses a kernel record, traced from the window's start,
  after a discarded warm-up replay, or held open ``PROFILE_MARGIN_S`` on
  each side as phase 11's gate holds it, and where the missing record
  lies;
- ``demote_ahead_probe()``: the host milliseconds of one demote-ahead
  tick's walk (``PagePool.demote_ahead_candidates`` with the tier's
  ``holds`` as its filter) over a tree of ``chains`` idle 512-token
  prefixes, every block already staged, so the walk stages nothing, as
  in run (f)'s steps after its idle gap. Host code only.

Run on the card from the repository's root::

    python3 -c "import serve_probes as p; p.parity_probe()"
    python3 -c "import serve_probes as p; p.paged_view_probe()"
    python3 -c "import serve_probes as p; p.profile_count_probe()"
    python3 -c "import serve_probes as p; p.tp_graph_probe()"
    python3 -c "import serve_probes as p; p.demote_ahead_probe()"

Each prints JSON lines tagged ``[paged-view]`` / ``[solo-parity ...]`` /
``[prefill-ops ...]`` / ``[tp-graph]`` / ``[demote-ahead]``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from functools import partial

from chip_smoke import (PAGE_SIZE, PROFILE_MARGIN_S, SERVE_NEW, SERVE_PROMPT,
                        SERVING, _free_memory, _serve_engine, _serve_stream,
                        device_ms, log)


def paged_view_probe(slots=8, max_len=1024, H=32, hd=128, ps=PAGE_SIZE):
    """An A/B of the paged view's gather at phase 11's slot step, in turns
    (words, elements, elements, words): ``_paged_view`` (the pages moved as
    8-byte words; int8 dequantized by one fused product) against an
    element-wise gather (``pool[rows, heads]`` in the pool's dtype; int8
    dequantized by three passes through fp32), K and V of one layer,
    device time; both give the same bytes."""
    import torch

    from deepspeed_tpu_torch.inference.decode import _paged_view

    def elementwise(cp, sp, table, dtype):
        B, n = table.shape
        heads = torch.arange(cp.shape[1], device=cp.device)[None, :, None]
        rows = table.long()[:, None, :]
        g = cp[rows, heads].reshape(B, cp.shape[1], n * ps, hd)
        if sp is None:
            return g
        s = sp[rows, heads].reshape(B, cp.shape[1], n * ps)
        return (g.float() * s[..., None]).to(dtype)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n = max_len // ps
    pages = 1 + slots * n
    table = (torch.randperm(pages - 1, device=dev)[:slots * n] + 1) \
        .reshape(slots, n).to(torch.int32)
    out = {}
    for kind in ("bf16", "int8"):
        if kind == "bf16":
            pk, pv = (torch.randn((pages, H, ps, hd), generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            sk = sv = None
        else:
            pk, pv = (torch.randint(-127, 128, (pages, H, ps, hd),
                                    generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            sk, sv = (torch.rand((pages, H, ps), generator=gen,
                                 device=dev) for _ in range(2))
        fns = {"words": _paged_view, "elements": elementwise}
        same = all(torch.equal(_paged_view(p, sc, table, torch.bfloat16),
                               elementwise(p, sc, table, torch.bfloat16))
                   for p, sc in ((pk, sk), (pv, sv)))
        times = {}
        for name in ("words", "elements", "elements", "words"):
            f = fns[name]
            times.setdefault(name, []).append(device_ms(
                lambda i: (f(pk, sk, table, torch.bfloat16),
                           f(pv, sv, table, torch.bfloat16)), 1, 200))
        out[kind] = {"same_bytes": same, **times}
        log(f"[paged-view] {kind}: " + json.dumps(out[kind]))
        if not same:
            raise AssertionError(f"paged view {kind}: the two gathers differ")
    return out


def _bf16_ulp(x: float) -> float:
    """One bf16 rounding step (its ulp) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _ulps(a, b) -> dict:
    """bf16 tensors ``a`` against ``b``: the share of elements that differ
    and the largest difference in ulps of the larger magnitude of the
    pair (1.0: the two are neighbouring bf16 values)."""
    import torch

    a, b = a.float(), b.float()
    d = (a - b).abs()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(2.0 ** -126))) - 7)
    return {"differ": (d > 0).float().mean().item(),
            "max_abs": d.max().item(),
            "max_ulps": (d / ulp).max().item()}


_OPS = ("x", "y", "qkv", "o", "a", "x1", "y2", "m", "out")


def _layer_ops(model, x, p, ck, cv, length, rope):
    """``decode._layer_step`` on a contiguous cache, its ops one by one,
    every output kept: the first norm ``y``, the projections ``qkv``
    (before RoPE), attention ``o``, the output projection ``a``, the
    residual ``x1``, the second norm ``y2``, the MLP ``m`` and the layer's
    output ``out``."""
    import torch

    from deepspeed_tpu_torch.inference import decode as dec

    cfg = model.cfg
    B, T, _ = x.shape
    kern = getattr(model, "woq_kernel", False)
    r = {"x": x}
    r["y"] = y = dec._norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg.norm,
                           cfg.norm_eps)
    q, k, v = dec._qkv_proj(model, y, p)
    r["qkv"] = torch.cat([t.flatten(2) for t in (q, k, v)], -1)
    if rope is not None:
        q, k = dec._apply_rope(q, k, *rope)
    dec._append(ck, cv, k, v, length)
    r["o"] = o = dec._cache_attend(q, ck, cv, length)
    r["q"] = q
    r["a"] = a = model._maybe_bias(dec.matmul_any(
        o.reshape(B, T, -1), p["wo"], kern), p, "bo")
    r["x1"] = x1 = x + a
    r["y2"] = y2 = dec._norm(x1, p["ln2_scale"], p.get("ln2_bias"), cfg.norm,
                             cfg.norm_eps)
    r["m"] = m = model._mlp_block(y2, p)[0]
    r["out"] = x1 + m
    return r


def _prefill_ops(engine, prompt, chunk, max_len, dev) -> dict:
    """The chunked prefill (the serving engine's chunk plan) against one
    whole prefill of ``prompt``, through ``_layer_ops``:

    - ``layers``: each layer's op outputs, chunked against whole (rows
      from the chunk that last wrote them), and its cache;
    - ``first``: the first (layer, op) whose output parts;
    - ``isolated``: each op run in the chunk plan's shapes on the whole
      prefill's own inputs to it, against the whole prefill's output, worst
      over layers: what one op adds when its inputs are equal.

    Both paths' caches are checked bit-identical to ``forward_with_cache``'s
    first, so the mirror is the served path."""
    import torch

    from deepspeed_tpu_torch.inference.decode import (
        KVCache, _embed_rows, _qkv_proj, forward_with_cache, init_cache)
    from deepspeed_tpu_torch.inference import decode as dec
    from deepspeed_tpu_torch.models.transformer import (LAYER_PREFIX,
                                                        layer_params,
                                                        rope_tables)
    from deepspeed_tpu_torch.serving import plan_chunks

    model, params, mat = engine.model, engine.params, engine.materialize
    cfg = model.cfg
    if cfg.parallel_residual or cfg.pos_embedding != "rope":
        raise NotImplementedError("the probe mirrors a Llama layer")
    P = len(prompt)
    layers = layer_params(params)
    top = mat({k: v for k, v in params.items()
               if not k.startswith(LAYER_PREFIX)})
    rd = cfg.rotary_dim or cfg.head_dim

    def run(spans):
        cache = init_cache(cfg, 1, max_len, cfg.dtype, device=dev)
        rows = [{} for _ in range(cfg.n_layer)]
        for start, ids in spans:
            T = len(ids)
            ids = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
            pos = start + torch.arange(T, device=dev)[None]
            rope = (*rope_tables(pos, cfg.rope_theta, rd), rd)
            x = _embed_rows(top["tok_embed"], ids, cfg.dtype)
            length = torch.tensor(start + T, dtype=torch.int32, device=dev)
            m = min(T, P - start)
            for i in range(cfg.n_layer):
                r = _layer_ops(model, x, mat({k: w[i] for k, w in
                                              layers.items()}),
                               cache.k[i], cache.v[i], length, rope)
                x = r["out"]
                for k, t in r.items():
                    buf = rows[i].setdefault(k, t.new_zeros(
                        (P,) + t.shape[2:]))
                    buf[start:start + m] = t[0, :m]
        return rows, cache

    def reference(spans):
        cache = init_cache(cfg, 1, max_len, cfg.dtype, device=dev)
        for start, ids in spans:
            cache = KVCache(cache.k, cache.v, torch.tensor(
                start, dtype=torch.int32, device=dev))
            forward_with_cache(model, params, torch.as_tensor(
                ids, dtype=torch.long, device=dev)[None], cache,
                last_token_head=True, materialize=mat)
        return cache

    chunked = [(ch.start, ch.ids) for ch in plan_chunks(prompt, chunk)]
    whole = [(0, prompt)]
    (rc, cc), (rw, cw) = run(chunked), run(whole)
    mirror = all(torch.equal(a[..., :P, :], b[..., :P, :])
                 for c, ref in ((cc, reference(chunked)),
                                (cw, reference(whole)))
                 for a, b in ((c.k, ref.k), (c.v, ref.v)))
    out = {"prompt": P, "chunks": [[s, len(i)] for s, i in chunked],
           "mirror_is_the_path": mirror, "layers": [], "first": None}
    for i in range(cfg.n_layer):
        row = {op: _ulps(rc[i][op], rw[i][op]) for op in _OPS}
        row["cache"] = _ulps(torch.cat([cc.k[i, :, :, :P], cc.v[i, :, :, :P]]),
                             torch.cat([cw.k[i, :, :, :P], cw.v[i, :, :, :P]]))
        out["layers"].append(row)
        if out["first"] is None:
            op = next((op for op in _OPS if row[op]["differ"] > 0), None)
            if op is not None:
                out["first"] = [i, op]
    # each op alone on the whole prefill's inputs, in the chunk plan's
    # shapes (a padded row past the prompt reads zeros)
    iso = {k: [] for k in ("qkv", "o", "a", "m")}

    def pieces(t):
        for start, ids in chunked:
            T, m = len(ids), min(len(ids), P - start)
            piece = t.new_zeros((1, T) + t.shape[1:])
            piece[0, :m] = t[start:start + m]
            yield start, T, m, piece

    for i in range(cfg.n_layer):
        p = mat({k: w[i] for k, w in layers.items()})
        w = rw[i]
        ck = torch.zeros_like(cw.k[i])
        cv = torch.zeros_like(cw.v[i])
        ck[..., :P, :] = cw.k[i][..., :P, :]
        cv[..., :P, :] = cw.v[i][..., :P, :]
        got = {k: torch.empty_like(w[k]) for k in ("qkv", "o", "a", "m")}
        for start, T, m, y in pieces(w["y"]):
            got["qkv"][start:start + m] = torch.cat(
                [t.flatten(2) for t in _qkv_proj(model, y, p)], -1)[0, :m]
        for start, T, m, q in pieces(w["q"]):
            got["o"][start:start + m] = dec._cache_attend(
                q, ck, cv, torch.tensor(start + T, dtype=torch.int32,
                                        device=dev))[0, :m]
        for start, T, m, o in pieces(w["o"]):
            got["a"][start:start + m] = model._maybe_bias(dec.matmul_any(
                o.reshape(1, T, -1), p["wo"],
                getattr(model, "woq_kernel", False)), p, "bo")[0, :m]
        for start, T, m, y2 in pieces(w["y2"]):
            got["m"][start:start + m] = model._mlp_block(y2, p)[0][0, :m]
        for k, t in got.items():
            iso[k].append(_ulps(t, w[k]))
    out["isolated"] = {k: {"layers_differ": sum(u["differ"] > 0 for u in us),
                           **{x: max(u[x] for u in us) for x in us[0]}}
                       for k, us in iso.items()}
    return out


def _fp32_logits(engine, ids):
    """The last position's logits of an fp32 forward of ``ids``: the
    engine's model with its weights dequantized to fp32 layer by layer,
    every activation in fp32 (matmuls without TF32)."""
    import torch

    from deepspeed_tpu_torch.inference.decode import (forward_with_cache,
                                                      init_cache)
    from deepspeed_tpu_torch.models import build_model

    cfg32 = dataclasses.replace(engine.model.cfg, dtype=torch.float32)
    model32 = build_model(cfg32)

    def mat32(p):
        return {k: v.float() if v.is_floating_point() else v
                for k, v in engine.materialize(p).items()}

    assert not torch.backends.cuda.matmul.allow_tf32
    lg, _ = forward_with_cache(
        model32, engine.params, ids,
        init_cache(cfg32, 1, ids.shape[1], torch.float32, device=ids.device),
        last_token_head=True, materialize=mat32)
    return lg[0, -1]


def gemm_probe(d=4096, ff=11008, whole=565, ms=(64, 256), device=None):
    """Llama-2-7B's prefill GEMMs (bf16 ``x @ w``: the fused attention
    projections, the output projection, the MLP's two input projections
    and its output one) at the chunk plan's M against the whole prompt's,
    with cuBLAS's reduced-precision bf16 reduction allowed (PyTorch's
    default) and not. For each: whether the rows at M ``m`` equal the
    whole M's bit for bit, and each result against the exact product
    (fp32 operands, fp32 sums, no TF32): the share of elements more than
    one bf16 ulp of the exact value away, and the worst, in ulps, over the
    elements at least 2^-8 of their row's largest (a result that rounds
    an fp32 sum once is within one ulp)."""
    import torch

    dev = torch.device(device or "cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    mm = torch.backends.cuda.matmul
    before = mm.allow_bf16_reduced_precision_reduction
    assert not mm.allow_tf32
    out = {}

    def against(r, exact):
        e = exact.abs()
        ulp = torch.exp2(torch.floor(torch.log2(e.clamp_min(2.0 ** -126)))
                         - 7)
        keep = e >= e.amax(-1, keepdim=True) * 2.0 ** -8
        u = ((r.float() - exact).abs() / ulp)[keep]
        return {"beyond_one_ulp": (u > 1).float().mean().item(),
                "max_ulps": u.max().item()}

    try:
        for name, K, N in (("wqkv", d, 3 * d), ("wo", d, d), ("w_in", d, ff),
                           ("w_out", ff, d)):
            x = torch.randn((whole, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 / math.sqrt(K)).to(torch.bfloat16)
            exact = x.float() @ w.float()
            for flag in (True, False):
                mm.allow_bf16_reduced_precision_reduction = flag
                full = x @ w
                r = {f"m{whole}": against(full, exact)}
                for m in ms:
                    part = x[:m] @ w
                    r[f"m{m}"] = {"equal_to_whole": bool(torch.equal(
                        part, full[:m])), **against(part, exact[:m])}
                out[f"{name} reduced={flag}"] = r
                log(f"[gemm] {name} ({K} x {N}), reduced-precision "
                    f"reduction {flag}: {json.dumps(r)}")
    finally:
        mm.allow_bf16_reduced_precision_reduction = before
    return out


def parity_probe(cfg=None, *, bits=8, requests=16, checks=4,
                 serving=SERVING, prompt=SERVE_PROMPT, new=SERVE_NEW,
                 device=None) -> dict:
    """Where phase 11b's served tokens part from a solo ``generate()`` of
    the same request, and why.

    Phase 11b's stream is served as there; the ``checks`` requests with
    the fewest new tokens (phase 11's solo checks) are generated alone.
    For a pair that parts at token t, four runs replay the request to t:
    the served path (the chunk plan's prefill, then slot steps at B
    ``slots``), the solo path (one whole prefill, then B 1 decode steps)
    and the two crosses (chunked prefill + B 1; whole prefill + B
    ``slots``), so the run that first takes the served token names the
    half that parts them. At t it records each path's top-two logit gap,
    the served token's logit less the solo token's, one bf16 rounding of
    the row's largest logit, and the same for a teacher-forced forward in
    bf16 and one in fp32 (``_fp32_logits``). Beside them, per request, the
    chunked against the whole prefill layer by layer and op by op
    (``_prefill_ops``), and once, decode attention's split plan at B
    ``slots`` against B 1 and its output for one row in each."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.decode import (
        GenCarry, KVCache, decode_forward, decode_sample, forward_with_cache,
        init_cache)
    from deepspeed_tpu_torch.inference.sampling import (
        per_request_generators, sample_logits)
    from deepspeed_tpu_torch.models import llama2
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.serving import insert_request, plan_chunks

    cfg = cfg or llama2("7b")
    dev = torch.device(device or "cuda")
    tag = f"[solo-parity {'int%d' % bits if bits else 'bf16'}]"
    _free_memory(dev)
    engine = _serve_engine(cfg, bits, device)
    model, params, mat = engine.model, engine.params, engine.materialize
    max_len, slots = serving["max_len"], serving["slots"]
    greedy = partial(sample_logits, greedy=True)
    srv = dt.ServingEngine(engine, serving)
    stream = _serve_stream(cfg.vocab_size, requests, prompt=prompt, new=new)
    rids = [srv.submit(p, n, seed=s) for p, n, s in stream]
    done = srv.drain()
    del srv
    lab = dt.ServingEngine(engine, serving)

    def prefill(prompt, chunked):
        ids = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
        cache = init_cache(cfg, 1, max_len, cfg.dtype, device=dev)
        if not chunked:
            lg, cache = forward_with_cache(model, params, ids, cache,
                                           last_token_head=True,
                                           materialize=mat)
            return lg[:, -1], cache
        for ch in plan_chunks(prompt, serving["prefill_chunk"]):
            cache = KVCache(cache.k, cache.v, torch.tensor(
                ch.start, dtype=torch.int32, device=dev))
            lg, cache = forward_with_cache(
                model, params, torch.as_tensor(ch.ids[None], dtype=torch.long,
                                               device=dev), cache,
                last_token_head=True,
                last_index=ch.last_index if ch.final else None,
                materialize=mat)
        return lg[:, -1], KVCache(cache.k, cache.v, torch.tensor(
            len(prompt), dtype=torch.int32, device=dev))

    def replay(prompt, steps, chunked, batched):
        """(tokens, fp32 logits of each token's step) of one path."""
        lg0, cache = prefill(prompt, chunked)
        tok = greedy(lg0, None)
        carry = GenCarry(tok, cache, per_request_generators([0], dev),
                         torch.zeros(1, dtype=torch.bool, device=dev))
        toks, rows = [int(tok[0])], [lg0[0].float()]
        if batched:
            st = lab.state
            for t in (st.cache.length, st.tok):
                t.zero_()
            st.done.fill_(True)
            insert_request(st, 0, carry)
            for _ in range(steps - 1):
                lg, _ = lab.slot_step(graphed=False)
                toks.append(int(st.tok[0]))
                rows.append(lg[0, 0].float().clone())
        else:
            for _ in range(steps - 1):
                lg, cache = decode_forward(model, params, carry,
                                           flash_decode=engine.flash_decode)
                carry = decode_sample(carry, lg, cache, sampler=greedy)
                toks.append(int(carry.tok[0]))
                rows.append(lg[0, 0].float().clone())
        return toks, rows

    def at_step(row, a, b):
        v2 = row.topk(2).values
        return {"top_two_gap": (v2[0] - v2[1]).item(),
                "served_minus_solo": (row[a] - row[b]).item(),
                "bf16_ulp_of_max": _bf16_ulp(row.abs().max().item())}

    sms = torch.cuda.get_device_properties(0).multi_processor_count \
        if dev.type == "cuda" else 132
    H, KV, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    plans = {b: da.split_plan(b, H, KV, max_len, hd, sms)
             for b in (slots, 1)}
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((slots, 1, H, hd), generator=gen, device=dev)
    ck, cv = (torch.randn((slots, KV, max_len, hd), generator=gen,
                          device=dev).to(cfg.dtype) for _ in range(2))
    q = q.to(cfg.dtype)
    lens = torch.full((slots,), 700, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        att_b = da.decode_attention(q, ck, cv, lens)[:1]
        att_1 = da.decode_attention(q[:1].contiguous(), ck[:1].contiguous(),
                                    cv[:1].contiguous(), lens[:1])
    attention = {"plan_b": plans[slots], "plan_1": plans[1],
                 "row_bit_identical": bool(torch.equal(att_b, att_1)),
                 "max_abs_diff": (att_b.float() - att_1.float()).abs()
                 .max().item()}
    del q, ck, cv, att_b, att_1
    log(f"{tag} decode attention at B {slots} and B 1, cache {max_len}: "
        f"{json.dumps(attention)}")
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    log(f"{tag} cuBLAS reduced-precision bf16 reduction: {reduced}")
    out = {"attention": attention, "reduced_precision_reduction": reduced,
           "requests": {}}
    picks = sorted(zip(stream, rids), key=lambda x: x[0][1])[:checks]
    with torch.inference_mode():
        for (p, n, s), rid in picks:
            served = list(done[rid].tokens)
            solo = engine.generate(p[None], n, greedy=True,
                                   request_seeds=[s],
                                   cache_len=max_len)[0].tolist()
            t = next((i for i, (a, b) in enumerate(zip(served, solo))
                      if a != b), None)
            lg_c, c_c = prefill(p, True)
            lg_w, c_w = prefill(p, False)
            P = len(p)
            ops = _prefill_ops(engine, p, serving["prefill_chunk"], max_len,
                               dev)
            log(f"[prefill-ops request {rid}] {json.dumps(ops)}")
            r = {"prompt": P, "max_new": n, "parity": float(np.mean(
                np.asarray(served) == np.asarray(solo))), "parts_at": t,
                "prefill": {
                    "cache": _ulps(torch.cat([c_c.k[..., :P, :],
                                              c_c.v[..., :P, :]]),
                                   torch.cat([c_w.k[..., :P, :],
                                              c_w.v[..., :P, :]])),
                    "first_logits_max_abs_diff": (lg_c - lg_w).abs().max()
                    .item(),
                    "first_op_parting": ops["first"],
                    "isolated": ops["isolated"]}}
            if t is not None:
                runs = {"served": (True, True), "solo": (False, False),
                        "chunked_b1": (True, False),
                        "whole_b_slots": (False, True)}
                got = {k: replay(p, t + 1, *v) for k, v in runs.items()}
                ids = torch.as_tensor(np.concatenate([p, served[:t]]),
                                      dtype=torch.long, device=dev)[None]
                tf, _ = forward_with_cache(
                    model, params, ids,
                    init_cache(cfg, 1, ids.shape[1], cfg.dtype, device=dev),
                    materialize=mat)
                f32 = _fp32_logits(engine, ids)
                a, b = served[t], solo[t]
                paths = {k: {"token": toks[t],
                             "prefix_equal": toks[:t] == served[:t],
                             **at_step(lgs[t], a, b),
                             "max_abs_from_fp32": (lgs[t] - f32).abs().max()
                             .item()}
                         for k, (toks, lgs) in got.items()}
                r.update(served_token=a, solo_token=b, paths=paths,
                         teacher_forced=at_step(tf[0, -1].float(), a, b),
                         fp32=at_step(f32, a, b))
            out["requests"][rid] = r
            log(f"{tag} request {rid}: {json.dumps(r)}")
    del lab, engine
    _free_memory(dev)
    log(f"[solo-parity] {json.dumps(out)}")
    return out


def _window_kernels(fn, warmup=None, margin=0.0):
    """The device kernels' names, in start order, of one torch.profiler
    window around ``fn()``; with ``warmup``, tracing starts one step
    earlier (the profiler's schedule ``warmup=1``, its records discarded)
    around ``warmup()``; else the window is held open ``margin`` seconds
    on each side of ``fn()``."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}

    def ready(p):
        got["events"] = [e for e in p.events()
                         if e.device_type == DeviceType.CUDA]

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warmup is None:
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        ready(prof)
    else:
        with profile(activities=acts, on_trace_ready=ready,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            warmup()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = sorted(got["events"], key=lambda e: e.time_range.start)
    return [e.name for e in events]


def profile_count_probe(cfg=None, *, bits=8, windows=30, replays=4,
                        engine=None, variants=("from_start", "after_warmup",
                                               "margin")):
    """How often phase 11's profiled window of graph replays misses a
    kernel record, and where: Llama-2-7B (int8 WOQ: phase 11b), or
    ``engine`` (e.g. ``chip_smoke._moe_serve_engine(mixtral("8x7b",
    moe_drop_tokens=False))``, phase 14a's), with every slot full and its
    slot step graphed; ``windows`` windows of ``replays`` replays from the
    same state, (a) traced from the window's start, (b) after one traced
    warm-up replay whose records the profiler discards, and (c) held open
    ``PROFILE_MARGIN_S`` on each side, as phase 11's gate holds it (the
    ``variants`` run). A window whose kernel list is shorter than the
    longest one's names the kernels missing, their position and replay.
    Prints a ``[profile-count]`` JSON line."""
    import difflib

    import torch

    import chip_smoke as c
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import llama2

    if engine is None:
        cfg = cfg or llama2("7b")
        engine = _serve_engine(cfg, bits=bits)
    cfg = engine.model.cfg
    srv = dt.ServingEngine(engine, SERVING)
    lab = _serve_stream(cfg.vocab_size, SERVING["slots"], seed=1,
                        prompt=(512, 512), new=(256, 256))
    for p, n, s in lab:
        srv.submit(p, n, seed=s)
    for _ in range(64 * SERVING["slots"]):
        if srv.sched.occupancy == SERVING["slots"] and srv.captures:
            break
        srv.step()
    st = srv.state
    marks = c._slot_marks(st)

    def window():
        c._slot_reset(st, marks)
        for _ in range(replays):
            srv.slot_step(graphed=True)

    def warm():
        c._slot_reset(st, marks)
        srv.slot_step(graphed=True)

    out = {}
    for variant, wu, margin in (("from_start", None, 0.0),
                                ("after_warmup", warm, 0.0),
                                ("margin", None, PROFILE_MARGIN_S)):
        if variant not in variants:
            continue
        runs = [_window_kernels(window, wu, margin) for _ in range(windows)]
        full = max(runs, key=len)
        per = len(full) // replays
        misses = []
        for i, r in enumerate(runs):
            if len(r) == len(full):
                continue
            sm = difflib.SequenceMatcher(a=full, b=r, autojunk=False)
            for op, a0, a1, _, _ in sm.get_opcodes():
                if op != "equal":
                    misses.append({"window": i, "op": op, "at": a0,
                                   "replay": a0 // per, "in_replay": a0 % per,
                                   "names": full[a0:a1][:4]})
        counts = [sum("woq_matmul_mma_kernel<" in n for n in r)
                  for r in runs]
        out[variant] = {"windows": windows, "kernels_full": len(full),
                        "short_windows": sum(len(r) < len(full)
                                             for r in runs),
                        "woq_counts": sorted(set(counts)), "misses": misses}
        log(f"[profile-count] {variant}: {out[variant]['short_windows']} of "
            f"{windows} windows short of {len(full)} kernels; woq_matmul "
            f"counts {out[variant]['woq_counts']}")
    log("[profile-count] " + json.dumps(out))
    del srv, engine
    _free_memory(torch.device("cuda"))
    return out


def tp_graph_probe(rows=8, d=4096, vocab=32000, replays=4):
    """A world of one over NCCL: an in-place all-reduce of a (rows, d) bf16
    tensor and an all-gather of (rows, vocab) fp32 logits along the
    vocabulary (the slot step's two kinds), issued eagerly and captured in
    a CUDA graph, each profiled; prints the device records by name and
    whether the replays' values equal the eager ones."""
    import time

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)
    from deepspeed_tpu_torch.platform.mesh import build_mesh

    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        mesh = build_mesh()
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((rows, d), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        y = torch.randn((rows, vocab), generator=gen, device="cuda")

        def step():
            a = comm.all_reduce(x * 2, "model", mesh=mesh)
            b = comm.all_gather(y + 1, "model", 1, mesh=mesh)
            return a, b

        def records(fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                time.sleep(0.2)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.2)
            dev, host = {}, {}
            for e in prof.events():
                into = dev if e.device_type == DeviceType.CUDA else host
                if e.device_type == DeviceType.CUDA or "c10d" in e.name \
                        or "nccl" in e.name.lower():
                    into[e.name[:80]] = into.get(e.name[:80], 0) + 1
            return {"device": dev, "host": host}

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            want = [t.clone() for t in step()]
        torch.cuda.current_stream().wait_stream(side)
        eager = records(step)
        graph = torch.cuda.CUDAGraph()
        issued = dict(comm.issued)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = step()
        captured = {k: v - issued[k] for k, v in comm.issued.items()
                    if v != issued[k]}
        replay = records(lambda: [graph.replay() for _ in range(replays)])
        same = all(torch.equal(o, w) for o, w in zip(out, want))
        log("[tp-graph] " + json.dumps({
            "eager": eager, "replays": replays, "replay": replay,
            "captured_collectives": captured, "replay_equals_eager": same,
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
            "torch": torch.__version__}))
    finally:
        dist.destroy_process_group()


def tp_capture_probe(tries=4, modes=("thread_local", "global", "relaxed"),
                     settle_s=(0.0, 0.3)):
    """Phase 15's capture in a world of one over NCCL, at the card tests'
    size (Llama-2 tiny int8, 3 slots): a fresh ServingEngine serves a
    4-request stream ``tries`` times per capture error mode and per wait
    between the eager warm-up step and the capture (``settle_s``: the
    device synchronized, then a sleep, so ProcessGroupNCCL's watchdog has
    retired the warm-up's collectives), with the WOQ kernels on and off;
    prints which captures succeed (a ``[tp-capture]`` JSON line)."""
    import time

    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama2
    from deepspeed_tpu_torch.ops import registry
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)
    from deepspeed_tpu_torch.serving import graph as sg

    cfg = llama2("tiny", max_seq=256)
    model = dt.models.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    reqs = [(torch.randint(0, cfg.vocab_size, (P,), generator=gen).numpy(),
             N, 10 + i) for i, (P, N) in enumerate(
                 [(5, 20), (20, 20), (40, 20), (9, 10)])]
    conf = {"dtype": "bfloat16", "quantize": True, "quant_bits": 8,
            "quant_group_size": 32}
    serving = {"slots": 3, "max_len": 128, "prefill_chunk": 16,
               "greedy": True}

    def serve(eng):
        srv = dt.ServingEngine(eng, serving)
        out = srv.serve_batch([p for p, _, _ in reqs],
                              [n for _, n, _ in reqs],
                              [s for _, _, s in reqs])
        return [o.tolist() for o in out], srv

    want, _ = serve(dt.init_inference(model, params, conf))
    original = sg.SlotGraph.capture
    results = []
    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        for kernel in (True, False):
            eng = dt.init_inference(model, params,
                                    {**conf, "woq_kernel": kernel})
            for mode in modes:
                for settle in settle_s:
                    def capture(self, forward, pool=None, mode=mode,
                                settle=settle):
                        if settle:
                            torch.cuda.synchronize()
                            time.sleep(settle)
                        before = registry.launch_counts()
                        issued = dict(comm.issued)
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph, pool=pool,
                                              capture_error_mode=mode):
                            out = forward()
                        self._graph, self._out = graph, out
                        self._keep = registry.workspace_buffers()
                        after = registry.launch_counts()
                        self.captured_launches = {
                            k: n - before.get(k, 0) for k, n in after.items()
                            if n != before.get(k, 0)}
                        self.captured_collectives = {
                            k: n - issued[k] for k, n in comm.issued.items()
                            if n != issued[k]}
                        self.captures += 1

                    sg.SlotGraph.capture = capture
                    ok, same, err = 0, 0, None
                    for _ in range(tries):
                        try:
                            got, srv = serve(eng)
                            ok += 1
                            same += got == want
                        except Exception as e:   # recorded, then re-tried
                            err = f"{type(e).__name__}: {str(e)[:160]}"
                            torch.cuda.synchronize()
                    results.append({"woq_kernel": kernel, "mode": mode,
                                    "settle_s": settle, "tries": tries,
                                    "captured": ok, "tokens_equal": same,
                                    "error": err})
                    log(f"[tp-capture] {json.dumps(results[-1])}")
    finally:
        sg.SlotGraph.capture = original
        dist.destroy_process_group()
    log("[tp-capture] " + json.dumps({"results": results}))


def demote_ahead_probe(chains=20, blocks=32, ps=PAGE_SIZE, ticks=50):
    """Host ms of one demote-ahead walk over ``chains`` x ``blocks`` idle
    tree-held blocks that the host tier already holds (tiles of 64 bytes:
    the walk never reads them)."""
    import time

    import numpy as np

    from deepspeed_tpu_torch.serving.hostkv import HostKVTier
    from deepspeed_tpu_torch.serving.pages import PagePool

    now = [0.0]
    pool = PagePool(1 + 2 * chains * blocks, ps, 2 * blocks * ps,
                    clock=lambda: now[0])
    tier = HostKVTier(1 << 30, ps)
    rng = np.random.default_rng(5)
    for rid in range(chains):
        prompt = rng.integers(0, 32000, blocks * ps).astype(np.int32)
        pool.try_admit(prompt, ps, rid)
        pool.on_inserted(rid, prompt)
        pool.release(rid)
    now[0] = 10.0
    tile = {"k": np.zeros(64, np.uint8)}
    for e in pool.demote_ahead_candidates(5.0, 10 ** 9):
        tier.put(e["tokens"], dict(tile))
    staged = len(tier.entries)
    t = time.perf_counter()
    for _ in range(ticks):
        left = pool.demote_ahead_candidates(5.0, blocks, skip=tier.holds)
    ms = (time.perf_counter() - t) / ticks * 1e3
    out = {"blocks": chains * blocks, "staged": staged,
           "left_to_stage": len(left), "tick_ms": ms}
    log("[demote-ahead] " + json.dumps(out))
    return out
