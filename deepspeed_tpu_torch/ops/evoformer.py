"""Evoformer (DS4Science) attention: pair-biased, gated attention.

Counterpart of ``deepspeed_tpu/ops/evoformer.py``: AlphaFold-style
attention whose scores take an additive pair-representation bias and whose
output is gated by ``sigmoid(gate)``. The biased attention is the flash
kernels' bias operand (``ops/flash_attention.py``, ``csrc/
flash_attention.cuh``): all three kernels read the bias in place, so the
(B, H, S, S) scores and probabilities never exist in device memory, and
the dq kernel writes dbias, the gradient the pair representation trains
through.

The JAX module falls back to the dense path for an S that no flash block
divides and for fp16 on its TPU (Mosaic has no f16). Neither fallback is
ported: the CUDA kernels take any S, and fp16 runs through them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import causal_attention
from .flash_attention import flash_attention


def dense_biased_attention(q, k, v, bias, *, mask=None, causal: bool = False):
    """The plain attention of the trunk (``causal_attention``, whose bias
    takes every broadcast rank): it forms the (B, H, S, S) scores. The
    reference the kernel path is held against."""
    return causal_attention(q, k, v, mask=mask, causal=causal, bias=bias)


def evoformer_attention(q, k, v, *, bias: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """q/k/v: (B, S, H, hd); bias: (S, S), (H, S, S) or (B|1, H|1, S, S);
    gate: (B, S, H, hd) pre-sigmoid gating values. Returns (B, S, H, hd):
    ``softmax(q·kᵀ/√d + bias) · v``, then ``sigmoid(gate) ⊙ out``.

    The bias is learned: a full (B, H, S, S) bias gets dbias from the dq
    kernel and a broadcast one the summed cotangent
    (``bias_is_constant=False``). ``mask`` (B, S) marks live keys (padded
    residues 0); the JAX function has no such argument, and AlphaFold's
    MSA attention needs one."""
    out = flash_attention(q, k, v, mask=mask, bias=bias, causal=causal,
                          bias_is_constant=False)
    if gate is not None:
        out = out * torch.sigmoid(gate.to(out.dtype))
    return out
