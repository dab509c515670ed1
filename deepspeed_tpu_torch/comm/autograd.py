"""Collectives that autograd can see: Megatron's tensor-parallel regions
and the expert-parallel token exchange (GSPMD inserts these in the JAX
package; there is no counterpart file).

- :func:`copy_to` is Megatron's *f*: the identity forward and, backward,
  the all-reduce over the line of the grads its column-parallel users
  produced (each rank holds part of the columns, so each holds part of
  the input's grad);
- :func:`reduce_from` is Megatron's *g*: the all-reduce of a row-parallel
  product's partials forward, the identity backward (every rank computes
  the same loss from the reduced value);
- :func:`max_from` is the all-reduce max of a vocab-parallel softmax: its
  backward sums the line's grads of the max and passes the sum to the
  ranks whose own max is the line's, as ``amax`` passes it to its arg-max
  (only rounding reaches it: the log-sum-exp's total derivative in its
  shift is 0); a use of the max that every rank repeats must enter the
  sum once, so it goes through ``reduce_from(m / n)``;
- :func:`exchange` is the all-to-all over a line, its own transpose.

Each is built on ``comm/comm.py``, so ``comm.issued`` counts what it
issues: a checkpointed region that recomputes its forward in the backward
issues its forward collectives again. Along a line of one rank in a larger
world, or with no process group, each returns its input and issues
nothing; in a world of one each runs over the group of one rank (a copy).
:func:`copy_to` does nothing where grads are off (inference).
"""

from __future__ import annotations

import torch

from . import comm


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` for an in-place collective to overwrite
    (``t`` stays as autograd, or a selective checkpoint, saved it)."""
    return t.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(_fresh(g), ctx.axes,
                               mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return comm.all_reduce(_fresh(x), axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MaxFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        out = comm.all_reduce(_fresh(x), axes, "max", mesh=mesh)
        ctx.save_for_backward(x == out)
        ctx.axes, ctx.mesh = axes, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        hit, = ctx.saved_tensors
        g = comm.all_reduce(_fresh(g), ctx.axes, mesh=ctx.mesh)
        return g * hit, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return comm.all_to_all(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g, ctx.axes, mesh=ctx.mesh), None, None


def copy_to(x: torch.Tensor, axis_name, *, mesh) -> torch.Tensor:
    """Megatron's *f* over the line along ``axis_name``."""
    if mesh.solo(axis_name) or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, axis_name, mesh)


def reduce_from(x: torch.Tensor, axis_name, *, mesh) -> torch.Tensor:
    """Megatron's *g*: the sum of the line's ``x`` (a new tensor)."""
    if mesh.solo(axis_name):
        return x
    return _ReduceFrom.apply(x, axis_name, mesh)


def max_from(x: torch.Tensor, axis_name, *, mesh) -> torch.Tensor:
    """The line's element-wise max of ``x`` (a new tensor)."""
    if mesh.solo(axis_name):
        return x
    return _MaxFrom.apply(x, axis_name, mesh)


def exchange(x: torch.Tensor, axis_name, *, mesh) -> torch.Tensor:
    """:func:`comm.all_to_all` (chunk j of dim 0 to the line's member j),
    differentiable."""
    if mesh.solo(axis_name):
        return x
    return _Exchange.apply(x, axis_name, mesh)
