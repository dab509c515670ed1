"""deepspeed_tpu_torch TransformerLM vs the JAX TransformerLM.

The same weights (a JAX init with every bias and norm parameter perturbed
from a numpy seed, so the biases are not all zero) and the same token ids
go through ``TransformerLM.apply`` of both packages, in fp32 on the CPU.
Tolerance 1e-4 absolute on logits of magnitude ~1: fp32 on both sides,
matmul sums taken in another order (observed gaps are ~2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jax_engine
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.models.transformer import TransformerLM

LOGIT_ATOL = 1e-4

# preset, args, overrides — built by both packages' presets
CASES = {
    "tiny_test": ("tiny_test", (), {}),
    "llama2_tiny": ("llama2", ("tiny",), {"max_seq": 64}),
    "opt_tiny": ("opt", ("tiny",), {}),
    "bloom_tiny": ("bloom", ("tiny",), {}),
    "parallel_rotary": ("tiny_test", (), dict(
        parallel_residual=True, pos_embedding="rope", rotary_dim=8,
        activation="gelu_exact")),
    "shared_ln_untied": ("tiny_test", (), dict(
        parallel_residual=True, parallel_shared_ln=True, pos_embedding="rope",
        rotary_dim=8, tie_embeddings=False, lm_head_bias=True,
        embed_norm=True, n_kv_head=1, norm="rmsnorm", norm_eps=1e-6)),
}


def make_pair(name, seed=0):
    """(jax model, jax params, torch model, torch state dict) for a case."""
    fn, args, kw = CASES[name]
    jcfg = getattr(jax_presets, fn)(*args, dtype=jnp.float32, **kw)
    tcfg = getattr(torch_presets, fn)(*args, dtype=torch.float32, **kw)
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(name, a):
        if name.endswith("_scale"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name.endswith("_bias") or name in ("bq", "bk", "bv", "bo",
                                              "b_in", "b_out"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = {k: ({lk: perturb(lk, lv) for lk, lv in v.items()}
                if k == "layers" else perturb(k, v)) for k, v in tree.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    return jm, jparams, build_model(tcfg), params_from_jax(tree, tcfg)


def ids_for(cfg, B=2, S=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax_apply(name):
    jm, jparams, tm, tparams = make_pair(name)
    ids = ids_for(jm.cfg)
    want = np.asarray(jm.apply(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm.apply(tparams, torch.as_tensor(ids, dtype=torch.long))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["llama2_tiny", "shared_ln_untied"])
def test_param_shapes_and_init_scales_match_jax(name):
    jm, jparams, tm, _ = make_pair(name)
    jtree = jm.init(jax.random.PRNGKey(1))
    flat = {k: v for k, v in jtree.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in jtree["layers"].items()})
    drawn = tm.init(torch.Generator().manual_seed(1))
    assert set(drawn) == set(flat)
    for k, v in flat.items():
        assert tuple(drawn[k].shape) == v.shape, k
        j_std, t_std = float(jnp.std(v)), float(drawn[k].std())
        # same distribution, different draws: stds within 10% (≥ 2048
        # samples per leaf checked, exact 0/1 constants for norms/biases)
        assert t_std == pytest.approx(j_std, rel=0.1, abs=1e-7), k


def test_fused_serving_layout_converts_back():
    """The JAX engine's fused wqkv/bqkv tree converts to the same state
    dict as the unfused training tree."""
    jm, jparams, tm, tparams = make_pair("tiny_test")
    eng = jax_engine.InferenceEngine(jm, jparams, {"dtype": "float32"})
    assert "wqkv" in eng.params["layers"] and "bqkv" in eng.params["layers"]
    fused = params_from_jax(jax.tree.map(np.asarray, eng.params), tm.cfg)
    assert set(fused) == set(tparams)
    for k in tparams:
        torch.testing.assert_close(fused[k], tparams[k], atol=0, rtol=0)


def test_bf16_tree_converts_bit_exact():
    jm, jparams, tm, _ = make_pair("tiny_test")
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    sd = params_from_jax(tree, tm.cfg)
    w = sd["layers.wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jparams["layers"]["wq"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_converter_rejects_wrong_trees():
    jm, jparams, tm, _ = make_pair("tiny_test")
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "lnf_scale"},
                        tm.cfg)
    bad = dict(tree, lnf_scale=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tm.cfg)


def test_module_forward_uses_loaded_params():
    _, _, tm, tparams = make_pair("opt_tiny")
    tm.load_params(tparams)
    assert set(tm.state_dict()) == set(tparams)
    ids = torch.as_tensor(ids_for(tm.cfg), dtype=torch.long)
    with torch.no_grad():
        torch.testing.assert_close(tm(ids), tm.apply(tparams, ids))


@pytest.mark.parametrize("override,item", [
    (dict(num_experts=4), "MoE"), (dict(post_ln=True), "training slice"),
    (dict(mlm_transform=True), "training slice"),
    (dict(tiled_head=4), "ops/tiled.py")])
def test_unported_switches_raise_with_roadmap_item(override, item):
    with pytest.raises(NotImplementedError, match=item):
        TransformerLM(torch_presets.tiny_test(**override))
