"""Collectives by mesh axis name (counterpart of
``deepspeed_tpu/comm/comm.py:111-181``).

JAX names an axis inside a ``shard_map`` body and XLA emits the collective
over it. Here the axis names a line of the :class:`~..platform.mesh.Mesh`
and each call is one ``torch.distributed`` collective over that line's
process group (NCCL on the card, ``gloo`` on the CPU), on the tensors of
this rank. A tensor sharded along ``dim`` other than 0 moves that dim to
the front, contiguous, for the call and back after it. Every result is
contiguous. On a mesh with no process group (one process, no
``init_distributed``), and along a line of one rank in a larger world,
each call returns its input; a world of one with a process group runs its
collectives over that group of one rank. ``axis_name`` may name several
axes, a line of their joint ranks (``("expert", "model")``).

``issued`` counts the collectives issued, by the kind names of PyTorch's
``c10d`` ops: a CUDA graph captured over them replays them without these
calls, so ``serving/graph.py`` keeps the count of a capture.

``CommsLogger`` (``comm.py:41``) is ROADMAP queue 1 item 7 and the
gradient half of the compressed collectives (``comm/compressed.py``) item
8(3).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..platform.mesh import BATCH_AXES, Mesh

_OPS = ("sum", "mean", "max", "min")
issued = {"allreduce": 0, "allgather": 0, "reduce_scatter": 0, "alltoall": 0,
          "broadcast": 0}


def _dist():
    import torch.distributed as dist

    return dist


def _all_gather_base(out, x, group):
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_base(out, x, group):
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_reduce(x: torch.Tensor, axis_name, op: str = "sum", *,
               mesh: Mesh) -> torch.Tensor:
    """Reduce ``x`` in place over the line along ``axis_name`` (``sum``,
    ``mean``, ``max`` or ``min``); returns ``x``."""
    if op not in _OPS:
        raise ValueError(f"all_reduce: op {op!r}, one of {_OPS}")
    if mesh.solo(axis_name):
        return x
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    issued["allreduce"] += 1
    dist.all_reduce(x, op=red, group=mesh.group(axis_name))
    if op == "mean":
        n = mesh.size(axis_name)
        if n > 1:
            x.div_(n)
    return x


def all_gather(x: torch.Tensor, axis_name, dim: int = 0, *, mesh: Mesh,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate the line's ``x`` along ``dim`` in line order (JAX's
    ``all_gather(..., tiled=True)``), into ``out`` when given."""
    if mesh.solo(axis_name):
        return x if out is None else out.copy_(x)
    n = mesh.size(axis_name)
    group = mesh.group(axis_name)
    issued["allgather"] += 1
    shape = list(x.shape)
    shape[dim] *= n
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if dim == 0:
        _all_gather_base(out, x.contiguous(), group)
        return out
    moved = x.movedim(dim, 0).contiguous()
    tmp = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_base(tmp, moved, group)
    return out.copy_(tmp.movedim(0, dim))


def reduce_scatter(x: torch.Tensor, axis_name, dim: int = 0, *, mesh: Mesh,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum the line's ``x`` and keep this rank's chunk along ``dim``
    (``psum_scatter(..., tiled=True)``), into ``out`` when given."""
    if mesh.solo(axis_name):
        return x if out is None else out.copy_(x)
    n = mesh.size(axis_name)
    group = mesh.group(axis_name)
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    part = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                       dtype=x.dtype, device=x.device)
    issued["reduce_scatter"] += 1
    _reduce_scatter_base(part, moved, group)
    res = part.movedim(0, dim)
    if out is not None:
        return out.copy_(res)
    return res.contiguous()


def all_to_all(x: torch.Tensor, axis_name, *, mesh: Mesh) -> torch.Tensor:
    """Chunk ``j`` of ``x``'s dim 0 to the line's member ``j``; returns the
    chunks received, member ``j``'s at ``j``, along dim 0 (JAX's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    if mesh.solo(axis_name):
        return x
    n = mesh.size(axis_name)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    issued["alltoall"] += 1
    _dist().all_to_all_single(out, x.contiguous(),
                              group=mesh.group(axis_name))
    return out


def broadcast(x: torch.Tensor, axis_name, src: int = 0, *,
              mesh: Mesh) -> torch.Tensor:
    """``x`` of the line's member ``src`` (its index along the line) on
    every member, in place; returns ``x``."""
    if mesh.solo(axis_name):
        return x
    root = mesh.line_ranks(axis_name)[src]
    issued["broadcast"] += 1
    _dist().broadcast(x, src=root, group=mesh.group(axis_name))
    return x


def barrier(axis_name=BATCH_AXES, *, mesh: Mesh) -> None:
    """Wait for every member of the line."""
    if not mesh.solo(axis_name):
        _dist().barrier(group=mesh.group(axis_name))


def get_world_size(axis_name=None, *, mesh: Mesh) -> int:
    """Ranks along ``axis_name`` (every axis when None)."""
    return mesh.world if axis_name is None else mesh.size(axis_name)


def get_rank(axis_name=None, *, mesh: Mesh) -> int:
    """This rank's index along ``axis_name``; its global rank when None."""
    return mesh.rank if axis_name is None else mesh.index(axis_name)
