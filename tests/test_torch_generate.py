"""deepspeed_tpu_torch generate() vs the JAX package's, on the CPU in fp32.

The same weights (JAX init, converted) and prompts (numpy seed) go through
``init_inference(...).generate(greedy=True)`` of both packages: the greedy
tokens must be identical. Prefill and per-row decode logits from
``forward_with_cache`` are compared at 1e-4 absolute (fp32 both sides,
another summation order; observed ~2e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.ops import decode_attention as da

from test_torch_model import make_pair  # a test module of this directory

LOGIT_ATOL = 1e-4


def prompts(cfg, B=2, S=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def engines(name, jconf=None, tconf=None):
    jm, jparams, tm, tparams = make_pair(name)
    je = jds.init_inference(jm, jparams, {"dtype": "float32", **(jconf or {})})
    te = dt.init_inference(tm, tparams, {"dtype": "float32", **(tconf or {})},
                           device="cpu")
    return je, te


@pytest.mark.parametrize("name", ["tiny_test", "llama2_tiny", "opt_tiny",
                                  "bloom_tiny", "parallel_rotary",
                                  "shared_ln_untied"])
def test_greedy_tokens_identical_to_jax(name):
    je, te = engines(name)
    ids = prompts(te.model.cfg)
    want = np.asarray(je.generate(ids, 8, greedy=True))
    got = te.generate(ids, 8, greedy=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(cache_len=48), dict(batch=1)])
def test_cache_len_and_single_row(kw):
    je, te = engines("llama2_tiny")
    ids = prompts(te.model.cfg, B=kw.pop("batch", 2))
    want = np.asarray(je.generate(ids, 6, greedy=True, **kw))
    np.testing.assert_array_equal(te.generate(ids, 6, greedy=True, **kw)
                                  .numpy(), want)


@pytest.mark.parametrize("decode_chunk", [0, 3])
def test_eos_and_decode_chunk(decode_chunk):
    """eos forcing (and the chunked path's eos fill) matches the JAX
    engine; the eos id is the greedy token of the first row's third step,
    so that row stops mid-generation."""
    je, te = engines("tiny_test")
    ids = prompts(te.model.cfg)
    eos = int(np.asarray(je.generate(ids, 8, greedy=True))[0, 2])
    conf = {"eos_token_id": eos, "decode_chunk": decode_chunk}
    je, te = engines("tiny_test", conf, conf)
    want = np.asarray(je.generate(ids, 9, greedy=True))
    got = te.generate(ids, 9, greedy=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_prefill_and_per_row_decode_logits_match_jax():
    jm, jparams, tm, tparams = make_pair("llama2_tiny")
    te = dt.init_inference(tm, tparams, {"dtype": "float32"}, device="cpu")
    ids = prompts(tm.cfg, S=10)
    jcache = jax_decode.init_cache(jm.cfg, 2, 32, jnp.float32)
    jl, jcache = jax_decode.forward_with_cache(jm, jparams, jnp.asarray(ids),
                                               jcache)
    tcache = decode.init_cache(te.model.cfg, 2, 32, torch.float32)
    with torch.no_grad():
        tl, tcache = decode.forward_with_cache(
            te.model, te.params, torch.as_tensor(ids, dtype=torch.long), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    # one decode step with per-row lengths (row 1 three tokens behind)
    rows = np.array([10, 7], np.int32)
    step = prompts(tm.cfg, S=1, seed=1)
    jl, _ = jax_decode.forward_with_cache(
        jm, jparams, jnp.asarray(step), jcache._replace(length=jnp.asarray(rows)))
    for flash in (False, True):
        c = decode.KVCache(tcache.k.clone(), tcache.v.clone(),
                           torch.from_numpy(rows))
        with torch.no_grad():
            tl, c = decode.forward_with_cache(
                te.model, te.params, torch.as_tensor(step, dtype=torch.long),
                c, flash_decode=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert c.length.tolist() == [11, 8]


def test_flash_decode_on_cpu_runs_the_plain_version(monkeypatch):
    """flash_decode=True on the CPU: every decode step goes through the
    wrapper's plain version (once per layer per step), the CUDA launch
    counter stays 0, and the tokens still equal the JAX engine's."""
    calls = []
    plain = da.decode_attention_plain
    monkeypatch.setattr(da, "decode_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    je, te = engines("bloom_tiny", tconf={"flash_decode": True})
    assert te.flash_decode
    ids = prompts(te.model.cfg)
    launches = da.decode_attention.launches
    got = te.generate(ids, 6, greedy=True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(je.generate(ids, 6, greedy=True)))
    assert len(calls) == te.model.cfg.n_layer * 5
    assert da.decode_attention.launches == launches


def test_forward_matches_jax_engine_forward():
    je, te = engines("opt_tiny")
    ids = prompts(te.model.cfg)
    np.testing.assert_allclose(te.forward(ids).numpy(),
                               np.asarray(je.forward(ids)),
                               atol=LOGIT_ATOL, rtol=0)


def test_sampled_generate_is_reproducible_and_in_vocab():
    _, te = engines("tiny_test")
    ids = prompts(te.model.cfg)
    a = te.generate(ids, 8, temperature=0.8, top_p=0.9, request_seeds=[1, 2])
    b = te.generate(ids, 8, temperature=0.8, top_p=0.9, request_seeds=[1, 2])
    assert torch.equal(a, b)
    assert a.shape == (2, 8) and int(a.min()) >= 0 \
        and int(a.max()) < te.model.cfg.vocab_size
    with pytest.raises(ValueError, match="request_seeds"):
        te.generate(ids, 8, request_seeds=[1])
