"""deepspeed_tpu_torch tensor- and expert-parallel serving against the JAX
engine, on the CPU.

One ``gloo`` spawn per world (2, then 4; ``tests/torch_tp_worker.py``), set
up once for the module: every rank runs every case of its world through
``init_inference(..., {"tensor_parallel": W | "expert_parallel": W})`` and
the ``ServingEngine``, while this process runs the JAX engine of each case
on a mesh of the same shape over its first W CPU devices
(``build_mesh(MeshSpec(data=1, expert=ep, model=tp),
devices=jax.devices()[:W])``), from the same fp32 weights.

Tolerances (fp32): greedy tokens identical; the dense cases' prefill logits
within 1e-5 of max |logit| (another summation order); every rank's shard of a leaf equal
to the block JAX keeps on device r, byte for byte (WOQ q and scales too),
the fused qkv against the head-aligned slice of JAX's ``[wq | wk | wv]``
(GSPMD cuts the fused matrix in contiguous columns); ``tp_comm_quant: 8``
greedy tokens identical to JAX's run with the knob on, on briefly trained
trunks (``tests/unit/test_tp_quant.py:69-96``), and ``int8_psum``'s sum
within one int8 quantum a hop (2 · max |block| / 127) of JAX's. The
speculative lane (paged, ``tests/unit/test_speculation.py``'s traffic):
greedy tokens and the speculation readout identical to JAX's spec-on run
on the same mesh, at tp W, at ep W (the tiny Mixtral) and under
``tp_comm_quant: 8``, where the verify reduces at full precision (T > 1)
and the plain steps over the int8 wire, as in JAX. The KV tiers (two
sessions alternating on a one-request pool, every resume restored; a host
tier, and a host tier of two rank pages over a disk rung): every rank's
greedy tokens identical to JAX's tier-on run on the same mesh
(``tests/unit/test_host_kv.py:115``, ``test_nvme_kv.py:177``), every
rank restoring with no fallback from a tier that holds its own KV heads.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as ds
import torch_tp_worker as tw
from deepspeed_tpu.comm.compressed import int8_psum as jax_int8_psum
from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.inference.quantization import QuantizedTensor as JQT
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import build_model, params_to_numpy
from deepspeed_tpu_torch.runtime import random_token_dataset
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_SHARE = 1e-5
JOIN_S = 400


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cfg(name):
    fn, args, kw = tw.MODELS[name]
    return getattr(jax_presets, fn)(*args, dtype=jnp.float32, **kw)


def _jax_engine(name, params, tp, ep, conf):
    mesh = build_mesh(MeshSpec(data=1, expert=ep, model=tp),
                      devices=jax.devices()[:tp * ep])
    return ds.init_inference(jax_build(_jax_cfg(name)), params, conf,
                             mesh=mesh)


def _flat(tree) -> dict:
    return {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


def _by_device(arr, world) -> list:
    got = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [got[d] for d in jax.devices()[:world]]


def _jax_shards(eng, world) -> dict:
    """Each leaf of the engine's tree: (whole, [device r's block]) — of q
    and scale for a quantized leaf."""
    out = {}
    for k, v in _flat(eng.params).items():
        if isinstance(v, JQT):
            out[k] = tuple((np.asarray(a), _by_device(a, world))
                           for a in (v.q, v.scale))
        else:
            out[k] = (np.asarray(v), _by_device(v, world))
    return out


# cases whose layout JAX cannot shard (a dim its mesh does not divide): the
# port's result is held to JAX's at tp 1
JAX_WHOLE = ("odd_vocab", "llama2_688")


def jax_gen(world, name, quant, tp, ep) -> dict:
    if name in JAX_WHOLE:
        tp = ep = 1
    params = params_to_numpy(tw.initial_params(name))
    eng = _jax_engine(name, params, tp, ep, tw.conf(quant, tp, ep))
    ids = tw.prompts(eng.model.cfg.vocab_size)
    out = {"tokens": np.asarray(eng.generate(ids, tw.NEW, greedy=True)),
           "shards": _jax_shards(eng, tp * ep)}
    if quant == "dense":
        with eng.mesh:
            cache = jax_decode.init_cache(eng.model.cfg, ids.shape[0], 16,
                                          jnp.float32)
            logits, _ = jax.jit(lambda p, i, c: jax_decode.forward_with_cache(
                eng.model, p, i, c))(eng.params, jnp.asarray(ids), cache)
        out["logits"] = np.asarray(logits)
    return out


def _jax_spec(eng, reqs) -> dict:
    srv = JaxServingEngine(eng, tw.SPEC)
    got = srv.serve_batch([p for p, _, _ in reqs], [n for _, n, _ in reqs],
                          [s for _, _, s in reqs])
    return {"tokens": got, "snapshot": srv.spec_snapshot()}


def jax_serve(world, out_dir) -> dict:
    name = "llama2_tiny"
    cfg = tw.model_cfg(name)
    eng = _jax_engine(name, params_to_numpy(tw.initial_params(name)), world,
                      1, tw.conf("dense", world, 1))
    reqs = tw.stream(cfg.vocab_size)
    out = {}
    for key, scfg in (("contiguous", {**tw.SERVING, "greedy": True}),
                      ("paged", {**tw.SERVING, "greedy": True,
                                 "page_size": tw.PAGE})):
        out[key] = JaxServingEngine(eng, scfg).serve_batch(
            [p for p, _, _ in reqs], [n for _, n, _ in reqs],
            [s for _, _, s in reqs])
    out["spec"] = _jax_spec(eng, tw.spec_stream(cfg.vocab_size))
    out["tier"] = {kind: tw.tier_cycle(JaxServingEngine(eng, tw.tier_serving(
        world, kind, out_dir / f"jax_nvme_w{world}")), cfg.vocab_size)
        for kind in tw.TIER_KINDS}
    return out


def jax_spec_ep(world) -> dict:
    name = "mixtral_tiny"
    eng = _jax_engine(name, params_to_numpy(tw.initial_params(name)), 1,
                      world, tw.conf("dense", 1, world))
    return _jax_spec(eng, tw.spec_stream(tw.model_cfg(name).vocab_size))


def port_sampled_tp1() -> list:
    """The sampled stream on the port with no process group (tp 1)."""
    name = "llama2_tiny"
    cfg = tw.model_cfg(name)
    eng = dt.init_inference(build_model(cfg), tw.initial_params(name),
                            tw.conf("dense", 1, 1), device="cpu")
    reqs = tw.stream(cfg.vocab_size)
    return dt.ServingEngine(eng, tw.SAMPLED).serve_batch(
        [p for p, _, _ in reqs], [n for _, n, _ in reqs],
        [s for _, _, s in reqs])


def train(name, steps: int = 16) -> dict:
    """A briefly trained trunk (the port's engine, fp32): confident
    next-token margins, so the int8 wire's noise stays below the greedy
    argmax gap, as ``tests/unit/test_tp_quant.py`` trains its own."""
    cfg = tw.model_cfg(name)
    eng = dt.initialize({"train_batch_size": 8,
                         "optimizer": {"type": "adamw",
                                       "params": {"lr": 3e-3}},
                         "bf16": {"enabled": False},
                         "steps_per_print": 1000},
                        build_model(cfg), params=tw.initial_params(name),
                        device="cpu")
    data = random_token_dataset(64, 32, cfg.vocab_size, seed=4,
                                learnable=True)
    batches = [np.stack([d["input_ids"] for d in data[i * 8:(i + 1) * 8]])
               for i in range(8)]
    for i in range(steps):
        eng.train_batch({"input_ids": batches[i % len(batches)]})
    return {"params": {k: v.detach().clone() for k, v in
                       eng.fp32_params().items()},
            "prompts": [np.asarray(data[i]["input_ids"][:p], np.int32)
                        for i, p in enumerate((9, 21, 5, 14))]}


def jax_tpq(world, trained) -> dict:
    name, n = tw.TPQ[world]
    t = trained[name]
    eng = _jax_engine(name, params_to_numpy(t["params"]), world, 1,
                      tw.conf("dense", world, 1, tp_comm_quant=8,
                              eos_token_id=tw.EOS))
    prompts = [np.tile(p[:4], 5) for p in t["prompts"][:n]]
    return {"tokens": [np.asarray(eng.generate(
                jnp.asarray(p[None]), 10, greedy=True, request_seeds=[7 + i],
                cache_len=tw.M))
                for i, p in enumerate(t["prompts"][:n])],
            "spec": _jax_spec(eng, [(p, 12, i)
                                    for i, p in enumerate(prompts)])}


def jax_psum(world) -> np.ndarray:
    mesh = build_mesh(MeshSpec(data=1, model=world),
                      devices=jax.devices()[:world])
    x = jnp.asarray(np.concatenate(tw.psum_partials(world)))
    fn = jax.shard_map(lambda v: jax_int8_psum(v, "model"), mesh=mesh,
                       in_specs=P("model", None), out_specs=P(None, None),
                       check_vma=False)
    return np.asarray(jax.jit(fn)(x))


def _load(out_dir, world):
    ranks = []
    for r in range(world):
        path = out_dir / f"w{world}_rank{r}.pt"
        if not path.exists():
            pytest.fail(f"world {world} rank {r} wrote no result")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            pytest.fail(f"world {world} rank {r}:\n{res['error']}")
        ranks.append(res)
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("tp_out")
    trained = {name: train(name) for name, _ in tw.TPQ.values()}
    torch.save(trained, out / "trained.pt")
    port, jx = {}, {}
    for world in (2, 4):
        procs = tw.spawn(world, _free_port(), out)
        try:
            jx[world, "psum"] = jax_psum(world)
            for case in tw.GEN[world]:
                jx[world, case] = jax_gen(world, *case)
            jx[world, "serve"] = jax_serve(world, out)
            jx[world, "tpq"] = jax_tpq(world, trained)
            jx[world, "spec_ep"] = jax_spec_ep(world)
        finally:
            tw.join(procs, JOIN_S)
        port[world] = _load(out, world)
    return {"port": port, "jax": jx, "sampled_tp1": port_sampled_tp1()}


GEN = [(w, c) for w in (2, 4) for c in tw.GEN[w]]


def _id(case):
    return "-".join(str(x) for x in case) if isinstance(case, tuple) \
        else str(case)


@pytest.mark.parametrize("world,case", GEN, ids=[f"w{w}-{_id(c)}"
                                                 for w, c in GEN])
def test_greedy_tokens_match_jax_on_every_rank(runs, world, case):
    want = runs["jax"][world, case]["tokens"]
    for rank in runs["port"][world]:
        np.testing.assert_array_equal(rank["gen"][case]["tokens"], want)


DENSE = [(w, c) for w, c in GEN if c[1] == "dense"]


@pytest.mark.parametrize("world,case", DENSE, ids=[f"w{w}-{_id(c)}"
                                                   for w, c in DENSE])
def test_prefill_logits_match_jax(runs, world, case):
    want = runs["jax"][world, case]["logits"]
    scale = np.abs(want).max()
    for rank in runs["port"][world]:
        got = rank["gen"][case]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGIT_SHARE * scale


def _head_aligned(whole, cfg, tp, r):
    """Rank r's [wq_r | wk_r | wv_r] columns of a whole fused qkv: its
    query heads, and its KV heads (n_kv_head / tp of them, or the one its
    query heads read where tp is a multiple of n_kv_head)."""
    hd, h, kv = cfg.head_dim, cfg.n_head, cfg.kv_heads
    hl = h // tp
    kl, k0 = (kv // tp, r * kv // tp) if kv % tp == 0 \
        else (1, r * hl // (h // kv))
    qd, kvd = h * hd, kv * hd
    cols = [np.arange(r * hl * hd, (r + 1) * hl * hd)]
    for base in (qd, qd + kvd):
        cols.append(base + np.arange(k0 * hd, (k0 + kl) * hd))
    return whole[..., np.concatenate(cols)]


SHARDED = [(w, c) for w, c in GEN if c[0] not in JAX_WHOLE]


@pytest.mark.parametrize("world,case", SHARDED,
                         ids=[f"w{w}-{_id(c)}" for w, c in SHARDED])
def test_rank_shards_are_jax_device_shards(runs, world, case):
    name, quant, tp, ep = case
    cfg = tw.model_cfg(name)
    want = runs["jax"][world, case]["shards"]
    cut = 0
    for r, rank in enumerate(runs["port"][world]):
        got = rank["gen"][case]["shards"]
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            fused = k.split(".")[-1] in ("wqkv", "bqkv")
            pairs = list(zip(g[:2], w)) if isinstance(g, tuple) \
                else [(g, w)]
            if isinstance(g, tuple):
                assert g[2] == 0, (k, "row0")
            for got_a, (whole, blocks) in pairs:
                exp = _head_aligned(whole, cfg, tp, r % tp) if fused \
                    and tp > 1 else blocks[r]
                assert got_a.shape == exp.shape, (r, k)
                np.testing.assert_array_equal(got_a, exp, err_msg=f"{r} {k}")
                cut += got_a.shape != whole.shape
    assert cut > 0


def test_vocab_that_does_not_split_stays_whole(runs):
    """V = 257 at tp 2: the table stays whole on both ranks (no
    collective), the layers are cut, and the tokens are JAX's at tp 1."""
    case = ("odd_vocab", "dense", 2, 1)
    whole = runs["jax"][2, case]["shards"]
    for rank in runs["port"][2]:
        got = rank["gen"][case]["shards"]
        np.testing.assert_array_equal(got["tok_embed"],
                                      whole["tok_embed"][0])
        assert got["layers.wo"].shape[1] == whole["layers.wo"][0].shape[1] // 2


def test_row_shard_off_its_groups_dequantizes_at_use(runs):
    """llama2 tiny's w_out at int8, group 16, tp 2: 688 rows, 344 a rank,
    21.5 groups; rank 1's shard starts 8 rows into its first group (the
    JAX package's fallback shape, ``quantization.py:212-217``), and the
    tokens are JAX's at tp 1."""
    case = ("llama2_688", "int8", 2, 1)
    q, s, row0 = runs["port"][2][1]["gen"][case]["shards"]["layers.w_out"]
    assert (q.shape[1], s.shape[1], row0) == (344, 22, 8)
    q0, _, row0 = runs["port"][2][0]["gen"][case]["shards"]["layers.w_out"]
    assert (q0.shape[1], row0) == (344, 0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_serving_greedy_matches_jax(runs, world, kind):
    want = runs["jax"][world, "serve"][kind]
    for rank in runs["port"][world]:
        got = rank["serve"][kind]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world", [2, 4])
def test_sampled_serving_equals_tp1_on_every_rank(runs, world):
    """temperature 0.9, top-k 30, per-request seeds: the port at tp W
    samples what it samples at tp 1 (the logits are all-gathered before
    the seeded sampler), on every rank."""
    want = runs["sampled_tp1"]
    for rank in runs["port"][world]:
        for g, w in zip(rank["serve"]["sampled"], want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world", [2, 4])
def test_paged_pool_holds_the_rank_kv_heads(runs, world):
    cfg = tw.model_cfg("llama2_tiny")
    for rank in runs["port"][world]:
        assert rank["serve"]["pool_k_shape"][2] == cfg.kv_heads // world


@pytest.mark.parametrize("world", [2, 4])
def test_tp_comm_quant_matches_jax(runs, world):
    want = runs["jax"][world, "tpq"]["tokens"]
    for rank in runs["port"][world]:
        got = rank["tpq"]
        assert got["gauge"] == 8
        for g, w in zip(got["tokens"], want):
            np.testing.assert_array_equal(g, w)


SPEC_CASES = [(w, k) for w in (2, 4) for k in ("tp", "ep", "tp_comm_quant")]


@pytest.mark.parametrize("world,kind", SPEC_CASES,
                         ids=[f"w{w}-{k}" for w, k in SPEC_CASES])
def test_spec_serving_matches_jax_spec_on(runs, world, kind):
    """Greedy spec-on tokens and readout on every rank equal JAX's spec-on
    run on the same mesh; drafts were accepted; every page came back."""
    want = {"tp": runs["jax"][world, "serve"]["spec"],
            "ep": runs["jax"][world, "spec_ep"],
            "tp_comm_quant": runs["jax"][world, "tpq"]["spec"]}[kind]
    assert want["snapshot"]["accepted_tokens"] > 0
    for rank in runs["port"][world]:
        got = {"tp": rank["serve"]["spec"], "ep": rank["spec_ep"],
               "tp_comm_quant": rank["tpq"]["spec"]}[kind]
        assert len(got["tokens"]) == len(want["tokens"])
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w)
        assert got["snapshot"] == want["snapshot"]
        assert got["pages_back"]


@pytest.mark.parametrize("world", [2, 4])
def test_int8_psum_within_a_quantum_a_hop_of_jax(runs, world):
    want = runs["jax"][world, "psum"]
    parts = tw.psum_partials(world)
    top = max(np.abs(sum(parts)).max(), max(np.abs(p).max() for p in parts))
    for rank in runs["port"][world]:
        got = rank["psum"]["sum"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2 * top / 127
    # and the int8 wire is lossy: the exact sum is not what comes back
    assert not np.array_equal(want, sum(parts))


TIER_CASES = [(w, k) for w in (2, 4) for k in tw.TIER_KINDS]


@pytest.mark.parametrize("world,kind", TIER_CASES,
                         ids=[f"w{w}-{k}" for w, k in TIER_CASES])
def test_tier_serving_matches_jax(runs, world, kind):
    """Every rank's tokens equal JAX's tier-on run on the same mesh; every
    rank restored with no fallback (the disk rung spilled and read back),
    from a tier whose tiles hold the rank's KV heads."""
    want = runs["jax"][world, "serve"]["tier"][kind]
    for rank in runs["port"][world]:
        got = rank["tier"][kind]
        assert len(got["tokens"]) == len(want)
        for g, w in zip(got["tokens"], want):
            np.testing.assert_array_equal(g, w)
        snap = got["snapshot"]
        assert snap["restores"] >= 2 and snap["fallbacks"] == 0
        assert got["tile_shape"][1] == got["pool_kv_heads"] \
            == max(1, tw.model_cfg("llama2_tiny").kv_heads // world)
        if kind == "nvme":
            assert snap["spills"] > 0
            assert snap["nvme_tier"]["promotions"] > 0
            assert snap["nvme_tier"]["fallbacks"] == 0


@pytest.mark.parametrize("world", (2, 4))
def test_tier_one_rank_fallback_keeps_ranks_together(runs, world):
    """A corrupt host copy on the last rank alone: that rank falls back,
    every rank restores the same shorter run (the MIN over the ranks'
    matches) and recomputes the rest, and every rank's tokens equal the
    fault-free tier run's, which equal JAX's."""
    want = runs["jax"][world, "serve"]["tier"]["host"]
    ranks = runs["port"][world]
    hits = {r["tier"]["host_fault"]["snapshot"]["hits"] for r in ranks}
    assert len(hits) == 1
    for i, rank in enumerate(ranks):
        got = rank["tier"]["host_fault"]
        assert len(got["tokens"]) == len(want)
        for g, w in zip(got["tokens"], want):
            np.testing.assert_array_equal(g, w)
        snap = got["snapshot"]
        assert snap["fallbacks"] == (1 if i == world - 1 else 0)
        assert snap["restores"] >= 2
        assert snap["hits"] < rank["tier"]["host"]["snapshot"]["hits"]
        # demote-ahead reads each rank's clock: refused above one rank
        assert "demote_ahead_idle_s" in rank["tier"]["ahead_refused"]
        assert "item 4" in rank["tier"]["ahead_refused"]
