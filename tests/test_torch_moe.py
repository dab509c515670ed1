"""deepspeed_tpu_torch's MoE (``models/moe.py``, the ``mixtral`` preset and
the MoE paths of the engines) against the JAX package, on the CPU in fp32.

The same numpy-seeded inputs and the same weights (a JAX init carried
across by ``params_from_jax``) go through both packages:

- ``_capacity`` on a grid, and ``topk_gating`` on groups with exact ties:
  dispatch equal, combine and aux within 1e-6 (fp32 sums of T values in
  another order);
- a tiny Mixtral's logits, aux loss and gradients within 1e-5, with drops
  forced by a small capacity factor, dropless, top-1, and under the eval
  capacity;
- four engine steps at ZeRO 1 and 3 with the ``moe`` section (losses, grad
  norms and every master leaf within 1e-5 relative, as
  ``tests/test_torch_train.py``), then the eval step under the eval
  capacity;
- the decode step's one-group dispatch, the bf16 casts that keep the
  router fp32, WOQ expert banks byte for byte, and an MoE checkpoint.

Greedy ``generate`` and ``ServingEngine`` tokens, dense and WOQ, contiguous
and paged, are the ``mixtral_tiny`` cases of ``test_torch_generate.py``,
``test_torch_woq.py``, ``test_torch_serving.py`` and
``test_torch_paged.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import moe as jmoe
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu.runtime.dataloader import random_token_dataset
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.models import (MoETransformerLM, mixtral,
                                        params_from_jax, params_to_numpy,
                                        read_fp32_safetensors,
                                        train_state_from_jax)
from deepspeed_tpu_torch.models import moe as tmoe
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.models.transformer import param_specs
from torch_one_thread import one_torch_thread  # noqa: F401

GATE_TOL = 1e-6
LOGIT_TOL = 1e-5
STEP_TOL = 1e-5
STEPS = 4
S = 32
E = 4
# a small trunk: 2 layers of Mixtral tiny's width, a 256-token vocabulary
SMALL = dict(n_layer=2, vocab_size=256, max_seq=64)


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0))


def pair(seed=0, **over):
    """(JAX model, JAX params, port model, port state dict), fp32."""
    jcfg = jax_presets.mixtral("tiny", dtype=jnp.float32, **{**SMALL, **over})
    tcfg = mixtral("tiny", dtype=torch.float32, **{**SMALL, **over})
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tree, dt.build_model(tcfg), params_from_jax(tree, tcfg)


def ids_for(B=3, T=24, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)) \
        .astype(np.int32)


# ------------------------------------------------------------------ gating
def test_capacity_equals_jax():
    for tokens in (1, 4, 7, 64, 128, 1000):
        for experts in (2, 4, 8):
            for factor in (0.5, 1.0, 1.25, 2.0):
                for k in (1, 2):
                    for drop in (True, False):
                        args = (tokens, experts, factor, k)
                        kw = dict(min_capacity=4, drop_tokens=drop)
                        assert tmoe._capacity(*args, **kw) \
                            == jmoe._capacity(*args, **kw), (args, kw)


def _tied_logits(lead=(), T=64, seed=0):
    """Router logits on a coarse grid, so many rows hold exact ties (in the
    first and in the second choice)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, lead + (T, E)).astype(np.float32) * 0.5
    flat = x.reshape(-1, T, E)
    flat[:, :4] = 1.0                     # four rows with a 4-way tie
    flat[:, 4:8, :2] = 3.0                # a 2-way tie for the top choice
    return flat.reshape(x.shape)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [1, 8, 64])
def test_topk_gating_equals_jax(capacity, top_k):
    logits = _tied_logits()
    comb, disp, aux = tmoe.topk_gating(torch.as_tensor(logits), top_k,
                                       capacity)
    jc, jd, ja = jmoe.topk_gating(jnp.asarray(logits), top_k, capacity)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), atol=GATE_TOL,
                               rtol=0)
    assert float(aux) == pytest.approx(float(ja), abs=GATE_TOL)
    assert disp.dtype == torch.bool and comb.dtype == torch.float32
    # a slot holds one token at most, and a token no more than top_k slots
    assert int(disp.sum(dim=0).max()) <= 1
    assert int(disp.flatten(1).sum(dim=1).max()) <= top_k


def test_topk_gating_batched_equals_vmapped_jax():
    """Leading dims are independent groups, as JAX's vmap over rows."""
    logits = _tied_logits(lead=(3,), T=16, seed=1)
    comb, disp, aux = tmoe.topk_gating(torch.as_tensor(logits), 2, 6)
    jc, jd, ja = jax.vmap(lambda lg: jmoe.topk_gating(lg, 2, 6))(
        jnp.asarray(logits))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), atol=GATE_TOL,
                               rtol=0)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ja), atol=GATE_TOL,
                               rtol=0)


# -------------------------------------------------------------------- model
MODEL_CASES = {
    "default": {},
    "drops": dict(moe_capacity_factor=0.5, moe_min_capacity=1),
    "dropless": dict(moe_drop_tokens=False),
    "top1_drops": dict(moe_top_k=1, moe_capacity_factor=0.5,
                       moe_min_capacity=1),
}


@pytest.mark.parametrize("eval_mode", [False, True])
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_logits_and_aux_match_jax(name, eval_mode):
    jm, tree, tm, params = pair(**MODEL_CASES[name])
    jm.moe_eval_mode = tm.moe_eval_mode = eval_mode
    ids = ids_for()
    want, waux = jm.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                          return_aux=True)
    with torch.no_grad():
        got, aux = tm.apply(params, torch.as_tensor(ids).long(),
                            return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert float(aux) == pytest.approx(float(waux), abs=LOGIT_TOL)


def test_drops_and_eval_capacity_change_the_output():
    """The cases above are not vacuous: the small capacity drops tokens,
    which the eval capacity (2x) and the dropless trunk keep."""
    _, _, tm, params = pair(**MODEL_CASES["drops"])
    ids = torch.as_tensor(ids_for()).long()
    with torch.no_grad():
        train = tm.apply(params, ids)
        tm.moe_eval_mode = True
        ev = tm.apply(params, ids)
        free = dt.build_model(dataclasses.replace(
            tm.cfg, moe_drop_tokens=False)).apply(params, ids)
    assert (train - ev).abs().max() > 1e-3
    assert (train - free).abs().max() > 1e-3


@pytest.mark.parametrize("remat", [None, "dots_saveable", "save_names_mlp"])
def test_loss_and_grads_match_jax(remat):
    """The loss with its aux term and every gradient leaf, through
    ``_mlp_block``'s dispatch with drops; under each remat policy the port
    recomputes the same ops (``save_names_mlp`` is ``save_names`` for an
    MoE block)."""
    jm, tree, tm, params = pair(**MODEL_CASES["drops"])
    batch = {"input_ids": ids_for(B=4, T=S)}
    want, jgrads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = tm.loss(leaves, {"input_ids": torch.as_tensor(
        batch["input_ids"]).long()}, remat_policy=remat)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOGIT_TOL)
    jflat = {**{k: v for k, v in jgrads.items() if k != "layers"},
             **{f"layers.{k}": v for k, v in jgrads["layers"].items()}}
    assert set(jflat) == set(leaves)
    for k, t in leaves.items():
        ref = np.asarray(jflat[k])
        scale = max(np.abs(ref).max(), 1e-6)
        assert np.abs(t.grad.numpy() - ref).max() <= 1e-5 * scale + 1e-7, k


def test_param_shapes_specs_and_init_scales_match_jax():
    jm, tree, tm, _ = pair()
    flat = {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}
    assert tm.param_shapes() == {k: v.shape for k, v in flat.items()}
    assert "layers.w_in" in flat and flat["layers.w_in"].ndim == 4
    drawn = tm.init(torch.Generator().manual_seed(1))
    for k, v in flat.items():
        assert drawn[k].std().item() == pytest.approx(float(np.std(v)),
                                                      rel=0.1, abs=1e-7), k
    jspecs = jm.param_specs()["layers"]
    specs = param_specs(tm.cfg)
    for name in ("router", "w_in", "w_gate", "w_out"):
        want = tuple(() if e is None else (e,) for e in jspecs[name])
        assert specs[f"layers.{name}"] == want, name
    assert tm.fp32_param_names() == jm.fp32_param_names() == ("router",)


@pytest.mark.parametrize("size", ["tiny", "8x7b"])
def test_param_count_and_flops_match_jax(size):
    jcfg, tcfg = jax_presets.mixtral(size), mixtral(size)
    for kw in ({}, {"non_embedding": True}, {"active_only": True}):
        assert tcfg.param_count(**kw) == jcfg.param_count(**kw), kw
    assert tcfg.flops_per_token() == jcfg.flops_per_token()
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name != "dtype"} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "dtype"}


def test_converter_refuses_a_dense_tree_for_an_moe_config():
    jm, tree, tm, _ = pair()
    no_router = dict(tree, layers={k: v for k, v in tree["layers"].items()
                                   if k != "router"})
    with pytest.raises(ValueError, match="router"):
        params_from_jax(no_router, tm.cfg)
    dense = jax.tree.map(np.asarray, jax_build(jax_presets.llama2(
        "tiny", **SMALL)).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(dense, tm.cfg)


# ----------------------------------------------------------------- training
def config(stage, **over):
    # Adam's eps at 1e-6 (as the MoE case of tests/torch_zero_worker.py):
    # at 1e-8 its first step turns an element's rounding-level grad into a
    # +-lr step, which no fp32 oracle can hold at 1e-5
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 3e-3, "weight_decay": 0.01,
                                    "eps": 1e-6}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"warmup_num_steps": 2,
                                    "total_num_steps": 10}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
           "remat": {"enabled": True, "policy": "dots_saveable"},
           "bf16": {"enabled": False}, "mesh": {"data": 1},
           # GShard training: drops at capacity 1.0; eval at 2.0 keeps more
           "moe": {"enabled": True, "num_experts": E, "top_k": 2,
                   "capacity_factor": 1.0, "eval_capacity_factor": 2.0,
                   "min_capacity": 1, "aux_loss_weight": 0.05},
           "steps_per_print": 1000}
    cfg.update(over)
    return cfg


def batches(seed=0):
    data = random_token_dataset(8 * STEPS, S, 256, seed=seed)
    return [{"input_ids": np.stack([d["input_ids"]
                                    for d in data[8 * i:8 * i + 8]])}
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    """ONE JAX engine (one device, ZeRO 1) and the port's at ZeRO 1 and 3
    (one process: every leaf whole, as JAX's stages on one device), from
    the same fp32 master: STEPS steps, then an eval step. Then the JAX
    ``TrainState`` carried into a fresh port engine, and one more step on
    both sides."""
    jm, _, _, _ = pair()
    mesh = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = ds.initialize(config(1), jm, mesh=mesh, seed=0)
    master0 = jax.tree.map(np.asarray, jeng.fp32_params())
    tcfg = mixtral("tiny", dtype=torch.float32, **SMALL)
    data, ev = batches(), batches(seed=9)[0]
    out = {"jax": [{k: float(v) for k, v in jeng.train_batch(dict(b)).items()}
                   for b in data],
           "jax_eval": float(jeng.eval_batch(dict(ev))),
           "jax_model_cfg": jeng.model.cfg, "eval_batch": ev,
           "jax_master": jax.tree.map(np.asarray, jeng.fp32_params())}
    for stage in (1, 3):
        teng = dt.initialize(config(stage), dt.build_model(
            tcfg, attention_fn=dt.make_flash_attention()),
            params=params_from_jax(master0, tcfg), device="cpu")
        out[stage] = dict(
            port=[{k: float(v) for k, v in teng.train_batch(dict(b)).items()}
                  for b in data],
            port_eval=teng.eval_batch(dict(ev)), port_engine=teng,
            port_master=params_to_numpy(teng.fp32_params()))
    st = jax.tree.map(np.asarray, jeng.state)
    carried = dt.initialize(config(1), dt.build_model(tcfg), seed=5,
                            device="cpu")
    train_state_from_jax(st, carried)
    nxt = batches(seed=4)[0]
    out["carried"] = dict(state=st, engine=carried,
                          jax=float(jeng.train_batch(dict(nxt))["loss"]),
                          port=float(carried.train_batch(dict(nxt))["loss"]))
    return out


@pytest.mark.parametrize("stage", [1, 3])
def test_engine_steps_match_jax(runs, stage):
    r = runs[stage]
    for j, t in zip(runs["jax"], r["port"]):
        assert t["loss"] == pytest.approx(j["loss"], rel=STEP_TOL)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=STEP_TOL)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12)
    flat = lambda t: {**{k: v for k, v in t.items() if k != "layers"},  # noqa
                      **{f"layers.{k}": v for k, v in t["layers"].items()}}
    want, got = flat(runs["jax_master"]), flat(r["port_master"])
    assert set(want) == set(got)
    errs = {k: rel_norm(got[k], want[k]) for k in want}
    assert max(errs.values()) <= STEP_TOL, errs


@pytest.mark.parametrize("stage", [1, 3])
def test_moe_section_and_eval_capacity_match_jax(runs, stage):
    """The ``moe`` section set the model's knobs as JAX's engine sets
    them; the eval step ran under the eval capacity (its loss is JAX's, and
    not the training capacity's) and left the flag down."""
    r = runs[stage]
    eng = r["port_engine"]
    for f in ("moe_top_k", "moe_capacity_factor", "moe_eval_capacity_factor",
              "moe_min_capacity", "moe_drop_tokens", "moe_aux_loss_weight"):
        assert getattr(eng.model.cfg, f) == getattr(runs["jax_model_cfg"],
                                                    f), f
    assert r["port_eval"] == pytest.approx(runs["jax_eval"], rel=STEP_TOL)
    assert eng.model.moe_eval_mode is False
    b = {k: torch.as_tensor(v).long() for k, v in runs["eval_batch"].items()}
    with torch.no_grad():
        train_cap = float(eng.model.loss(
            {k: v.float() for k, v in eng.master.items()}, b))
    assert abs(train_cap - r["port_eval"]) > 1e-6


def test_moe_section_mismatch_raises_like_jax():
    conf = config(1, moe={"enabled": True, "num_experts": 8})
    jm, _, tm, _ = pair()
    with pytest.raises(ValueError, match="num_experts"):
        ds.initialize(conf, jm, mesh=build_mesh(
            MeshSpec(data=1), devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="num_experts"):
        dt.initialize(conf, tm, device="cpu")
    with pytest.raises(NotImplementedError, match="item 4"):
        dt.initialize(config(1, mesh={"expert": 2}, zero_optimization={
            "stage": 3, "mics_shard_size": 2}), tm, device="cpu")


def test_eval_flag_is_restored_when_the_loss_raises(monkeypatch):
    _, _, tm, params = pair()
    eng = dt.initialize(config(1), tm, params=params, device="cpu")

    def boom(*a, **k):
        assert tm.moe_eval_mode is True
        raise RuntimeError("boom")

    monkeypatch.setattr(tm, "loss", boom)
    with pytest.raises(RuntimeError, match="boom"):
        eng.eval_batch(batches()[0])
    assert tm.moe_eval_mode is False


def test_bf16_compute_keeps_the_router_fp32():
    """The training engine's compute cast and the inference engine's cast
    leave the router in fp32; every other weight takes bf16."""
    _, _, tm, params = pair()
    eng = dt.initialize(config(1, bf16={"enabled": True}), tm, params=params,
                        device="cpu")
    cp, _, _ = eng._cast_compute()
    assert all(t.dtype == torch.float32 for t in cp["layers.router"])
    assert all(t.dtype == torch.bfloat16 for t in cp["layers.w_in"])
    assert cp["tok_embed"].dtype == torch.bfloat16
    assert np.isfinite(float(eng.train_batch(batches()[0])["loss"]))
    ie = dt.init_inference(tm, params, {"dtype": "bf16"}, device="cpu")
    assert ie.params["layers.router"].dtype == torch.float32
    assert ie.params["layers.w_in"].dtype == torch.bfloat16
    assert ie.model.moe_eval_mode is True and tm.moe_eval_mode is False


# --------------------------------------------------------------- inference
def test_decode_dispatch_equals_the_training_dispatch_when_dropless():
    """``_mlp_block_infer`` (one group, C = B·T) equals ``_mlp_block``
    (a group a row) wherever the latter drops nothing."""
    _, _, tm, params = pair(moe_drop_tokens=False)
    p = {k[len("layers."):]: v[0] for k, v in params.items()
         if k.startswith("layers.")}
    y = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (5, 3, tm.cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        a, _ = tm._mlp_block(y, p)
        b, _ = tm._mlp_block_infer(y, p)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_decode_step_logits_match_jax():
    """A prefill under the eval capacity (drops on), then a T = 1 step
    through the one-group dispatch: fp32 logits within 1e-5 of JAX's."""
    jm, tree, tm, params = pair(moe_capacity_factor=0.5, moe_min_capacity=1)
    je = ds.init_inference(jm, jax.tree.map(jnp.asarray, tree),
                           {"dtype": "float32"})
    te = dt.init_inference(tm, params, {"dtype": "float32"}, device="cpu")
    ids = ids_for(B=3, T=10)
    jc = jax_decode.init_cache(je.model.cfg, 3, 16, jnp.float32)
    jl0, jc = jax_decode.forward_with_cache(je.model, je.params,
                                            jnp.asarray(ids), jc)
    step = np.asarray(jnp.argmax(jl0[:, -1:], axis=-1)).astype(np.int32)
    jl1, _ = jax_decode.forward_with_cache(je.model, je.params,
                                           jnp.asarray(step), jc)
    tc = decode.init_cache(te.model.cfg, 3, 16, torch.float32)
    with torch.no_grad():
        tl0, tc = decode.forward_with_cache(te.model, te.params,
                                            torch.as_tensor(ids).long(), tc)
        tl1, _ = decode.forward_with_cache(te.model, te.params,
                                           torch.as_tensor(step).long(), tc)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=LOGIT_TOL,
                               rtol=0)


jquantize = jax.jit(jq.quantize, static_argnames=("group_size", "bits"))


@pytest.mark.parametrize("bits", [8, 4])
def test_woq_expert_banks_are_jax_bytes_and_the_router_stays_fp32(bits):
    """The stacked (L, E, d, f) banks quantize to the JAX engine's bytes and
    scales; ``[i]`` is layer i's (E, d, f) bank, which ``dequantize`` takes
    whole (the decode step's per-use dequant); the router is not
    quantized."""
    conf = {"dtype": "float32", "quantize": True, "quant_bits": bits,
            "quant_group_size": 64}
    jm, tree, tm, params = pair()
    je = ds.init_inference(jm, jax.tree.map(jnp.asarray, tree), conf)
    te = dt.init_inference(tm, params, conf, device="cpu")
    for name in ("w_in", "w_gate", "w_out"):
        got, want = te.params[f"layers.{name}"], je.params["layers"][name]
        assert isinstance(got, tq.QuantizedTensor)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                      np.asarray(want.scale).view(np.uint32))
        ref = jquantize(jnp.asarray(tree["layers"][name]), group_size=64,
                        bits=bits)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
        layer = got[1]
        assert tuple(layer.shape) == tuple(tree["layers"][name].shape[1:])
        np.testing.assert_array_equal(
            tq.dequantize(layer, torch.float32).numpy(),
            np.asarray(jq.dequantize(jax.tree.map(lambda a: a[1], want),
                                     jnp.float32)))
    router = te.params["layers.router"]
    assert isinstance(router, torch.Tensor) and router.dtype == torch.float32
    assert not isinstance(je.params["layers"]["router"], jq.QuantizedTensor)
    np.testing.assert_array_equal(router.numpy(), tree["layers"]["router"])


# ------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_of_an_moe_state(tmp_path):
    """Save after a step, load into a fresh engine: the same master,
    moments and the same next step; the fp32 converter's output reads back
    through ``read_fp32_safetensors``."""
    from deepspeed_tpu_torch.runtime.checkpoint import to_fp32

    _, _, tm, params = pair()
    tcfg = tm.cfg
    make = lambda: dt.initialize(config(1), dt.build_model(tcfg),  # noqa
                                 params=params, device="cpu")
    a = make()
    data = batches()
    a.train_batch(dict(data[0]))
    a.save_checkpoint(tmp_path)
    b = make()
    b.load_checkpoint(tmp_path)
    for g in ("master", "mu", "nu"):
        src = a.master if g == "master" else getattr(a.opt_state, g)
        dst = b.master if g == "master" else getattr(b.opt_state, g)
        for k, v in src.items():
            assert torch.equal(v, dst[k]), (g, k)
    assert float(a.train_batch(dict(data[1]))["loss"]) \
        == float(b.train_batch(dict(data[1]))["loss"])
    to_fp32.main([str(tmp_path), "latest", str(tmp_path / "out")])
    back = read_fp32_safetensors(tmp_path / "out" / "model_fp32.safetensors",
                                 tcfg)
    assert set(back) == set(a.master)
    assert back["layers.w_in"].shape == (2, E, 256, 512)


def test_jax_moe_train_state_continues_in_the_port(runs):
    """A JAX ``TrainState`` of an MoE model (router and 4-D banks, their
    moments) carries into the port, which takes the next step as JAX."""
    c = runs["carried"]
    teng, st = c["engine"], c["state"]
    assert teng.opt_state.mu["layers.w_in"].shape == (2, E, 256, 512)
    assert int(st.step) == STEPS and teng.step == STEPS + 1
    assert c["port"] == pytest.approx(c["jax"], rel=STEP_TOL)


def test_build_model_and_exports():
    assert isinstance(dt.build_model(mixtral("tiny")), MoETransformerLM)
    assert torch_presets.mixtral("8x7b").num_experts == 8
    assert hasattr(dt.models, "mixtral") and hasattr(dt.models,
                                                     "MoETransformerLM")
