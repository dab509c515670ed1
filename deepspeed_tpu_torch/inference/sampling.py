"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``deepspeed_tpu/inference/sampling.py``; the masking is
the JAX package's (``sampling.py:47-61``) step for step. The random draws
are not: a ``torch.Generator`` stands where a ``jax.random`` key stood, and
the port cannot reproduce ``jax.random``'s threefry bits. Sampled tokens
therefore agree with the JAX package in distribution, not token for token;
greedy tokens agree exactly (ties go to the first index, as ``jnp.argmax``).

The random source comes in two layouts:
- one ``torch.Generator``: a single stream for the whole batch;
- a list of B generators (:func:`per_request_generators`): row b draws
  from its own stream, so a request seeded from its own seed samples the
  same tokens whichever row of a batch it lands in.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Rng = Union[torch.Generator, Sequence[torch.Generator]]


def per_request_generators(seeds, device) -> list[torch.Generator]:
    """(B,) request seeds → one generator per row, seeded from the request
    seed (never from the row index)."""
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def mask_logits(logits, *, temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0):
    """fp32 logits / temperature with the tokens outside top-k and outside
    the smallest top-p nucleus set to -inf."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set of tokens with cumulative mass >= top_p
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1) - 1
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))


def sample_logits(logits, rng: Rng, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0, greedy: bool = False):
    """logits: (B, V) → (B,) int64 token ids, by Gumbel-max over the masked
    logits (the draw ``jax.random.categorical`` makes)."""
    if greedy or temperature == 0.0:
        return logits.argmax(dim=-1)
    masked = mask_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    if isinstance(rng, torch.Generator):
        noise = _gumbel(masked.shape, rng, masked.device)
    else:
        if len(rng) != masked.shape[0]:
            raise ValueError(f"{len(rng)} generators for {masked.shape[0]} rows")
        noise = torch.stack([_gumbel(masked.shape[-1:], g, masked.device)
                             for g in rng])
    return (masked + noise).argmax(dim=-1)
