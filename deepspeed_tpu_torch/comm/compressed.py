"""The quantized tensor-parallel decode collective (counterpart of
``int8_psum`` in ``deepspeed_tpu/comm/compressed.py:146``).

``int8_psum`` sums a partial over a line of the mesh with int8 payloads on
both hops (EQuARX's two-sided quantized all-reduce): the flat fp32 partial,
padded to ``world`` chunks of whole ``BLOCK``-element scale blocks
(:func:`chunk_elems`), is block-quantized (:func:`_quant_blocks`), its
codes and scales go through one ``all_to_all`` each, every rank sums its
chunk in fp32, requantizes it and the codes and scales are all-gathered.
The blocking, the padding and the rounding are the JAX package's, so both
quantize the same blocks to the same codes.

The gradient half of the JAX module (1-bit and int8 error feedback) is
ROADMAP.md queue 1 item 8(3).
"""

from __future__ import annotations

import numpy as np
import torch

from . import comm

BLOCK = 2048  # elements per quantization scale

# max(absmax, 1e-12) / 127 as the JAX package's compiled program computes
# it: XLA folds the division by the constant into a product with
# fp32(1 / 127)
_RECIPROCAL = float(np.float32(1) / np.float32(127))


def chunk_elems(n: int, world: int, block: int = BLOCK) -> int:
    """Per-rank chunk length: ceil to a whole number of scale blocks."""
    per = -(-n // world)
    return -(-per // block) * block


def _quant_blocks(xb: torch.Tensor):
    """(..., block) fp32 → symmetric int8 and a per-block fp32 scale
    (``ops/quant.py`` ``quant_blocks``). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-12) * _RECIPROCAL
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_psum(x: torch.Tensor, axis_name="model", *, mesh,
              block: int = BLOCK) -> torch.Tensor:
    """Sum-all-reduce of a partial of any shape over the line along
    ``axis_name`` with int8 payloads on both hops; returns the sum in
    ``x``'s dtype and shape. A line of one rank returns ``x``, as the JAX
    package's does (no collective)."""
    world = mesh.size(axis_name)
    if world == 1:
        return x
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    per = chunk_elems(n, world, block)
    xb = torch.nn.functional.pad(flat, (0, per * world - n)).reshape(
        world, per // block, block)
    q, s = _quant_blocks(xb)
    q = comm.all_to_all(q, axis_name, mesh=mesh)
    s = comm.all_to_all(s, axis_name, mesh=mesh)
    mine = (q.float() * s).sum(dim=0)                       # (nb, block)
    q2, s2 = _quant_blocks(mine)
    qg = comm.all_gather(q2[None], axis_name, mesh=mesh)     # (W, nb, block)
    sg = comm.all_gather(s2[None], axis_name, mesh=mesh)
    out = (qg.float() * sg).reshape(-1)[:n]
    return out.reshape(shape).to(dtype)
