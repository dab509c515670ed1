"""deepspeed_tpu_torch training vs the JAX engine.

For each case, one JAX ``ds.initialize(config, model)`` engine is built
(module-scoped: JAX engines whose attention runs interpret-mode Pallas
compile slowly) and its fp32 master goes into the port's
``initialize(config, model, params=params_from_jax(master))`` on the CPU.
Both then take 4 ``train_batch`` steps on the same ``random_token_dataset``
batches: losses, ``grad_norm``, ``lr`` and the master params after the
steps are compared.

Tolerances:
- fp32 (``bf16: {"enabled": False}``): losses and grad norms within 1e-5
  relative, lr within 1e-6 relative (both schedules compute in fp32),
  master params within 1e-5 relative in norm (||Δ|| / ||p|| per leaf). Both
  sides compute in fp32; sums run in another order. The norm, not the max
  element: Adam divides each grad by its own running rms, so an element
  whose grad is tiny (a rare token's embedding row) takes a step of ~lr
  whatever its grad's relative error, and a single such element can stand
  far out in a max.
- bf16: losses within 2e-3 relative, grad norms within 2e-2 relative,
  master params within 2e-2 relative in norm. The compute params,
  activations and grads are bf16 on both sides, rounded at the same points
  but summed in another order, and Adam's first steps scale small grad
  differences up to ~lr.
- ``layers.bk`` is left out of the master comparison: a key bias shifts
  every score of a softmax row by the same q·bk, so its gradient is 0 in
  exact arithmetic and both sides step on rounding noise, which Adam scales
  up to ±lr per step. Its loss and grad-norm effects are in the gates above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.ops.flash_attention import make_flash_attention as jax_flash
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu.runtime.dataloader import random_token_dataset
from deepspeed_tpu_torch.models import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.ops import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

STEPS = 4
S = 32
TOL = {"float32": dict(loss=1e-5, gnorm=1e-5, master=1e-5),
       "bfloat16": dict(loss=2e-3, gnorm=2e-2, master=2e-2)}


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| (want 0 counts as 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0))


def config(dtype, **over):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"warmup_num_steps": 2,
                                    "total_num_steps": 10}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
           "remat": {"enabled": True, "policy": "dots_saveable"},
           "bf16": {"enabled": dtype == "bfloat16"}, "mesh": {"data": 1},
           "steps_per_print": 1000}
    cfg.update(over)
    return cfg


BERT_HF = dict(vocab_size=320, max_seq=64, post_ln=True, embed_norm=True,
               mlm_transform=True, lm_head_bias=True, fused_xent=True)

# name: (preset, args, overrides, dtype, JAX flash attention?, batch kind:
# False plain ids, True with padding and loss masks, "mlm" an MLM batch)
CASES = {
    "gpt2_like_fp32": ("tiny_test", (), dict(max_seq=64), "float32", True,
                       False),
    "llama_like_fp32": ("llama2", ("tiny",), dict(vocab_size=256, n_layer=2,
                                                  max_seq=64),
                        "float32", False, False),
    "bloom_like_fp32": ("bloom", ("tiny",), dict(vocab_size=256), "float32",
                        True, False),
    "gpt2_like_bf16": ("tiny_test", (), dict(max_seq=64), "bfloat16", True,
                       False),
    "masked_fp32": ("tiny_test", (), dict(max_seq=64), "float32", True,
                    True),
    # the fused softmax-xent head (the JAX kernels in interpret mode)
    "gpt2_like_fused_fp32": ("tiny_test", (), dict(max_seq=64,
                                                   fused_xent=True),
                             "float32", True, True),
    # BERT's MLM objective, Hugging Face layout, fused head with its bias;
    # the JAX encoder takes its dense attention, the port the bidirectional
    # flash function
    "bert_mlm_fused_fp32": ("bert", ("tiny",), BERT_HF, "float32", False,
                            "mlm"),
    "bert_mlm_unfused_fp32": ("bert", ("tiny",),
                              dict(BERT_HF, fused_xent=False, tiled_head=4),
                              "float32", False, "mlm"),
}


def batches(vocab, masked, seed=0):
    data = random_token_dataset(8 * STEPS, S, vocab, seed=seed)
    out = []
    for i in range(STEPS):
        ids = np.stack([d["input_ids"] for d in data[8 * i:8 * i + 8]])
        b = {"input_ids": ids}
        if masked:
            att = np.ones((8, S), np.int32)
            att[1, :5] = 0            # left padding: query rows 0-4 see no key
            att[6, :9] = 0
            loss = att.copy()
            loss[3, 20:] = 0
            b.update(attention_mask=att, loss_mask=loss)
        if masked == "mlm":
            rng = np.random.default_rng(seed + 100 + i)
            att = np.ones((8, S), np.int32)
            att[2, 25:] = 0           # right padding
            att[5, 12:] = 0
            picked = (rng.random((8, S)) < 0.15).astype(np.int32) * att
            picked[:, 0] = 1
            b.update(labels=rng.integers(0, vocab, (8, S)).astype(np.int32),
                     loss_mask=picked, attention_mask=att)
        out.append(b)
    return out


def run_case(name):
    fn, args, kw, dtype, flash, masked = CASES[name]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jcfg = getattr(jax_presets, fn)(*args, dtype=jdt, **kw)
    tcfg = getattr(torch_presets, fn)(*args, dtype=tdt, **kw)
    jm = jax_build(jcfg, attention_fn=jax_flash(block=16, interpret=True)
                   if flash else None)
    # one device: the world size the port runs at
    mesh = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = ds.initialize(config(dtype), jm, mesh=mesh, seed=0)
    master0 = jeng.fp32_params()
    teng = dt.initialize(config(dtype),
                         dt.build_model(tcfg, attention_fn=dt.make_flash_attention(
                             causal=tcfg.causal)),
                         params=params_from_jax(master0, tcfg), device="cpu")
    jm_, tm_ = [], []
    for b in batches(tcfg.vocab_size, masked):
        jm_.append({k: float(v) for k, v in jeng.train_batch(dict(b)).items()})
        tm_.append({k: float(v) for k, v in teng.train_batch(dict(b)).items()})
    return dict(dtype=dtype, jax=jm_, port=tm_,
                jax_master=jax.tree.map(np.asarray, jeng.fp32_params()),
                port_master=params_to_numpy(teng.fp32_params()))


@pytest.fixture(scope="module")
def results():
    return {}


def case(results, name):
    if name not in results:
        results[name] = run_case(name)
    return results[name]


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(results, name):
    r = case(results, name)
    want = np.array([m["loss"] for m in r["jax"]])
    got = np.array([m["loss"] for m in r["port"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL[r["dtype"]]["loss"])


@pytest.mark.parametrize("name", list(CASES))
def test_grad_norm_lr_and_scale_match_jax(results, name):
    r = case(results, name)
    for j, t in zip(r["jax"], r["port"]):
        assert t["grad_norm"] == pytest.approx(
            j["grad_norm"], rel=TOL[r["dtype"]]["gnorm"])
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12)
        assert t["loss_scale"] == j["loss_scale"] == 1.0
        assert t["skipped"] == j["skipped"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_master_params_match_jax_after_steps(results, name):
    r = case(results, name)
    want, got = r["jax_master"], r["port_master"]
    flat = lambda t: {**{k: v for k, v in t.items() if k != "layers"},  # noqa
                      **{f"layers.{k}": v for k, v in t["layers"].items()}}
    want, got = flat(want), flat(got)
    assert set(want) == set(got)
    tol = TOL[r["dtype"]]["master"]
    errs = {k: rel_norm(got[k], want[k])
            for k in sorted(set(want) - {"layers.bk"})}
    assert max(errs.values()) <= tol, errs


# (preset, args, overrides): tied and untied heads, fused_xent None / False /
# True, fp16, a width past the xent kernels' tiles, a head-less objective
XENT_CASES = [("gpt2", ("1.5b",), {}),
              ("gpt2", ("1.5b",), dict(fused_xent=False)),
              ("gpt2", ("1.5b",), dict(fused_xent=True)),
              ("llama2", ("7b",), {}),
              ("bloom", ("tiny",), dict(dtype="float16")),
              ("gpt2", ("125m",), dict(d_model=8192, n_head=64)),
              ("gpt2", ("125m",), dict(objective="feature"))]


@pytest.mark.parametrize("accelerator", [True, False])
@pytest.mark.parametrize("case", XENT_CASES,
                         ids=lambda c: "-".join([c[0], *c[1], *map(str, c[2].items())]))
def test_fused_xent_decision_matches_jax(monkeypatch, case, accelerator):
    """The port's loss takes its fused xent kernels exactly where the JAX
    package would take its own: on its accelerator (a TPU there, the card
    here) or off it."""
    fn, args, kw = case
    jkw, tkw = dict(kw), dict(kw)
    if "dtype" in kw:
        jkw["dtype"], tkw["dtype"] = jnp.dtype(kw["dtype"]), getattr(
            torch, kw["dtype"])
    jm = jax_build(getattr(jax_presets, fn)(*args, **jkw))
    tm = dt.build_model(getattr(torch_presets, fn)(*args, **tkw))
    monkeypatch.setattr(jax, "default_backend",
                        lambda: "tpu" if accelerator else "cpu")
    assert tm._fused_xent_active(accelerator) \
        == jm._fused_xent_active(batch_size=4)


# ------------------------------------------------ the port against itself
def port_engine(cfg_over=None, model_over=None, seed=3):
    tcfg = torch_presets.tiny_test(dtype=torch.float32, max_seq=64,
                                   **(model_over or {}))
    return dt.initialize(config("float32", **(cfg_over or {})),
                         dt.build_model(tcfg,
                                        attention_fn=dt.make_flash_attention()),
                         seed=seed, device="cpu")


def test_gas_2_equals_one_large_batch():
    """gas 2 × micro 4 and gas 1 × micro 8 over the same 8 rows: the same
    mean loss and the same step (fp32, sums in another order)."""
    b = batches(256, False)[:2]
    e2 = port_engine()
    e1 = port_engine({"train_micro_batch_size_per_gpu": 8,
                      "gradient_accumulation_steps": 1})
    for x in b:
        m2, m1 = e2.train_batch(dict(x)), e1.train_batch(dict(x))
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
        assert float(m2["grad_norm"]) == pytest.approx(
            float(m1["grad_norm"]), rel=1e-5)
    for k, v in e1.master.items():
        if k != "layers.bk":             # rounding noise (module docstring)
            assert rel_norm(e2.master[k], v) <= 1e-5, k


def test_remat_grads_equal_no_remat():
    """The same steps with remat (dots_saveable, selective checkpoint) and
    without: recomputation repeats the same ops, so equal results."""
    b = batches(256, True)[:2]
    on = port_engine()
    off = port_engine({"remat": {"enabled": False}})
    full = port_engine({"remat": {"enabled": True, "policy": "full"}})
    for x in b:
        a, c, f = (e.train_batch(dict(x)) for e in (on, off, full))
        assert float(a["loss"]) == float(c["loss"]) == float(f["loss"])
        assert float(a["grad_norm"]) == pytest.approx(float(c["grad_norm"]),
                                                      rel=1e-6)
    for k, v in off.master.items():
        torch.testing.assert_close(on.master[k], v, atol=1e-7, rtol=0)
        torch.testing.assert_close(full.master[k], v, atol=1e-7, rtol=0)


@pytest.mark.parametrize("policy", ["save_names", "save_names_mlp"])
@pytest.mark.parametrize("model_over", [dict(fused_xent=True),
                                        dict(activation="silu_glu",
                                             parallel_residual=True)],
                         ids=["fused_head", "glu_parallel"])
def test_segmented_remat_equals_no_remat(policy, model_over):
    """``save_names`` / ``save_names_mlp`` cut each layer into checkpointed
    segments; the recomputation repeats the same ops, so the losses equal
    the run without remat exactly. ``save_names_mlp`` forms the residual
    ``x + attn_out`` in two segments, so the gradient reaches x and
    attn_out as a sum of two paths taken in another order: masters within
    1e-6 absolute after two Adam steps (1e-7 where the ops are the same),
    and ``layers.bk``, whose gradient is rounding noise (module docstring),
    is left out."""
    b = batches(256, True)[:2]
    on = port_engine({"remat": {"enabled": True, "policy": policy}},
                     model_over)
    off = port_engine({"remat": {"enabled": False}}, model_over)
    assert on.remat_policy == policy and off.remat_policy is None
    for x in b:
        a, c = on.train_batch(dict(x)), off.train_batch(dict(x))
        assert float(a["loss"]) == float(c["loss"])
        assert float(a["grad_norm"]) == pytest.approx(float(c["grad_norm"]),
                                                      rel=1e-6)
    for k, v in off.master.items():
        if k != "layers.bk":
            torch.testing.assert_close(
                on.master[k], v, rtol=0,
                atol=1e-6 if policy == "save_names_mlp" else 1e-7)


def test_eval_batch_takes_an_mlm_batch():
    tcfg = torch_presets.bert("tiny", dtype=torch.float32, **BERT_HF)
    eng = dt.initialize(config("float32"), dt.build_model(tcfg), seed=1,
                        device="cpu")
    b = batches(tcfg.vocab_size, "mlm")[0]
    first = eng.eval_batch(dict(b))
    for _ in range(3):
        eng.train_batch(dict(b))
    assert np.isfinite(first) and eng.eval_batch(dict(b)) < first


def test_fp16_loss_scale_skips_overflow_steps():
    eng = port_engine({"bf16": {"enabled": False},
                       "fp16": {"enabled": True, "initial_scale_power": 200,
                                "hysteresis": 1}})
    m = eng.train_batch(dict(batches(256, False)[0]))
    assert m["skipped"] == 1 and eng.loss_scale.scale == 2.0 ** 199
    assert eng.skipped_steps == 1 and eng.step == 1


def test_learnable_data_loss_falls():
    eng = port_engine({"optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
                       "scheduler": None})
    data = random_token_dataset(8, S, 256, seed=1, learnable=True)
    b = {"input_ids": np.stack([d["input_ids"] for d in data])}
    losses = [float(eng.train_batch(dict(b))["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0] - 1.0


def test_cpu_training_launches_no_kernel():
    from deepspeed_tpu_torch.ops import xent as txe

    fns = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv, txe.xent_fwd,
           txe.xent_bwd)
    before = [f.launches for f in fns]
    port_engine(model_over=dict(fused_xent=True)).train_batch(
        dict(batches(256, False)[0]))
    assert [f.launches for f in fns] == before
