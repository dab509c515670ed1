"""Tiled matmul (counterpart of ``deepspeed_tpu/ops/tiled.py``): ``x @ w``
as a loop over column tiles of ``w``, so a caller that checkpoints or
gathers per tile holds one tile's worth of the weight at a time. Wired into
the model head through ``TransformerConfig.tiled_head`` on the unfused
logits path; the fused-xent loss path never forms logits and ignores it.
The JAX version holds no kernel (a ``lax.scan`` of plain products); neither
does this one."""

from __future__ import annotations

import torch


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """x: (..., K); w: (K, N) with N divisible by ``n_tiles`` → (..., N)."""
    N = w.shape[1]
    if N % n_tiles != 0:
        raise ValueError(f"output dim {N} not divisible by n_tiles={n_tiles}")
    if n_tiles == 1:
        return x @ w
    return torch.cat([x @ wt for wt in w.split(N // n_tiles, dim=1)], dim=-1)
