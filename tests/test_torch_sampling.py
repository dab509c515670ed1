"""deepspeed_tpu_torch sampling vs the JAX package's.

The port cannot reproduce ``jax.random``'s bits, so sampled paths are held
by their masks (exactly JAX's: the masked logits JAX hands to
``jax.random.categorical`` are captured and compared) and by their
distribution; greedy picks are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as jax_sampling
from deepspeed_tpu_torch.inference.sampling import (mask_logits,
                                                    per_request_generators,
                                                    sample_logits)


def logits(B=3, V=50, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


def jax_masked(monkeypatch, x, **kw):
    """The masked logits the JAX sampler draws from."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", capture)
        jax_sampling.sample_logits(jnp.asarray(x), jax.random.PRNGKey(0), **kw)
    return seen["logits"]


# Every row's cumulative mass stays >= 1e-3 away from these top_p values:
# right at the threshold, the rounding order of the two cumsums decides
# the boundary token (top_p=0.999 here lands within rounding of it).
@pytest.mark.parametrize("kw", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8),
    dict(temperature=1.3, top_k=10, top_p=0.6), dict(top_p=0.95)])
def test_masks_identical_to_jax(monkeypatch, kw):
    x = logits()
    want = jax_masked(monkeypatch, x, **kw)
    got = mask_logits(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6, atol=0)


def test_draws_stay_inside_the_kept_set():
    x = torch.from_numpy(logits(B=4, V=64))
    kept = torch.isfinite(mask_logits(x, top_k=7, top_p=0.7))
    gen = torch.Generator().manual_seed(0)
    for _ in range(300):
        tok = sample_logits(x, gen, top_k=7, top_p=0.7)
        assert kept[torch.arange(4), tok].all()


def test_draws_follow_the_masked_distribution():
    """Empirical frequencies of 20000 draws within 0.02 of softmax(masked
    logits): the binomial std is <= 0.0036, so 0.02 is over 5 sigma."""
    x = torch.from_numpy(logits(B=1, V=8, seed=3)).expand(20000, 8)
    toks = sample_logits(x, torch.Generator().manual_seed(1), temperature=0.9,
                         top_k=6)
    freq = torch.bincount(toks, minlength=8).double() / toks.numel()
    p = torch.softmax(mask_logits(x[:1], temperature=0.9, top_k=6), -1)[0]
    torch.testing.assert_close(freq, p.double(), atol=0.02, rtol=0)


def test_per_request_seed_is_row_invariant():
    x = torch.from_numpy(logits(B=3))
    seeds = [7, 8, 9]
    a = sample_logits(x, per_request_generators(seeds, "cpu"), top_p=0.9)
    perm = [2, 0, 1]
    b = sample_logits(x[perm], per_request_generators([seeds[i] for i in perm],
                                                      "cpu"), top_p=0.9)
    assert torch.equal(b, a[perm])


def test_greedy_ties_go_to_the_first_index():
    x = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    got = sample_logits(x, None, greedy=True)
    want = np.asarray(jax_sampling.sample_logits(
        jnp.asarray(x.numpy()), None, greedy=True))
    assert got.tolist() == [1, 0] == want.tolist()
