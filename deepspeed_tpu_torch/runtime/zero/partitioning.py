"""ZeRO stages as a choice of layout per leaf (counterpart of
``deepspeed_tpu/runtime/zero/partitioning.py``).

The JAX package compiles each stage into its step as sharding constraints
over the mesh's ``data`` (and hpZ / MiCS ``zero``) axes; this module makes
the same choice for every leaf, which dim is cut over which axes, and the
engine carries it out with explicit collectives (``runtime/zero/shards.py``):

- stage 0: everything whole on every rank; grads all-reduced;
- stage 1: the fp32 master and the moments cut by :meth:`master_spec`;
- stage 2: the grads reduce-scattered straight into that layout;
- stage 3: the compute params cut by :meth:`compute_spec` too, gathered
  layer by layer where they are used; leaves under
  ``param_persistence_threshold`` stay whole.

A spec is one tuple of mesh axis names per dim (``()`` for a dim that is
not cut), composed with the model's own tensor-parallel spec
(``models.transformer.param_specs``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

Spec = tuple   # one tuple of axis names per dim


def _entries(spec: Optional[Spec], rank: int) -> list:
    entries = [tuple(e) for e in spec] if spec is not None else []
    return entries + [()] * (rank - len(entries))


def add_axis_to_spec(spec: Optional[Spec], shape: tuple, mesh_shape: dict,
                     axis="data", skip_dims: tuple = ()) -> Spec:
    """Cut one more dim of ``shape`` over ``axis`` (a mesh axis name or a
    tuple of names cut jointly), composing with ``spec``: the largest free
    (uncut, divisible) dim, later dims first on ties; else stacked onto a
    cut dim that still divides; else ``spec`` unchanged (whole with respect
    to ``axis``). Axes of size 1 are dropped first."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    names = tuple(a for a in names if mesh_shape[a] > 1)
    size = int(np.prod([mesh_shape[a] for a in names])) if names else 1
    entries = _entries(spec, len(shape))
    if size == 1:
        return tuple(entries)
    if any(a in e for e in entries for a in names):
        return tuple(entries)
    candidates = sorted((d for d in range(len(shape)) if d not in skip_dims),
                        key=lambda d: (bool(entries[d]), -shape[d], -d))
    for d in candidates:
        existing = int(np.prod([mesh_shape[a] for a in entries[d]]))
        if shape[d] % (existing * size) == 0:
            entries[d] = entries[d] + names
            return tuple(entries)
    return tuple(entries)


def param_size(shape: tuple) -> int:
    return int(np.prod(shape)) if shape else 1


class ZeroPartitioner:
    """The compute and master specs of a model's leaves."""

    def __init__(self, stage: int, mesh_shape: dict, *,
                 param_persistence_threshold: int = 10_000,
                 zero_hpz_partition_size: int = 1, mics_shard_size: int = 0):
        self.stage = int(stage)
        self.mesh_shape = dict(mesh_shape)
        self.threshold = int(param_persistence_threshold)
        self.has_zero_axis = self.mesh_shape.get("zero", 1) > 1
        self.hpz = self.has_zero_axis and int(zero_hpz_partition_size) > 1
        self.mics = self.has_zero_axis and int(mics_shard_size or 0) > 0

    @property
    def dp_axes(self) -> tuple:
        """Axes the ZeRO partition spans; under MiCS only the ``zero``
        subgroup (the state is whole again in every subgroup)."""
        if self.mics:
            return ("zero",)
        return ("data", "zero") if self.has_zero_axis else ("data",)

    @property
    def compute_axes(self) -> tuple:
        """Axes a stage-3 compute leaf is cut over: hpZ's secondary shard
        spans only the ``zero`` subgroup, so per-layer gathers stay in it."""
        return ("zero",) if self.hpz else self.dp_axes

    def compute_spec(self, model_spec: Optional[Spec], shape: tuple, *,
                     stacked: bool = False) -> Spec:
        """Layout of the compute (bf16) copy of a leaf."""
        base = _entries(model_spec, len(shape))
        if self.stage < 3 or param_size(shape) < self.threshold:
            return tuple(base)
        return add_axis_to_spec(base, shape, self.mesh_shape,
                                self.compute_axes,
                                skip_dims=(0,) if stacked else ())

    def master_spec(self, model_spec: Optional[Spec], shape: tuple, *,
                    stacked: bool = False) -> Spec:
        """Layout of the fp32 master and the optimizer moments."""
        base = _entries(model_spec, len(shape))
        if self.stage < 1:
            return tuple(base)
        return add_axis_to_spec(base, shape, self.mesh_shape, self.dp_axes,
                                skip_dims=(0,) if stacked else ())

    def compute_specs(self, model_specs: dict, shapes: dict,
                      stacked_fn: Callable = lambda s: False) -> dict:
        return {k: self.compute_spec(model_specs.get(k), tuple(s),
                                     stacked=stacked_fn(tuple(s)))
                for k, s in shapes.items()}

    def master_specs(self, model_specs: dict, shapes: dict,
                     stacked_fn: Callable = lambda s: False) -> dict:
        return {k: self.master_spec(model_specs.get(k), tuple(s),
                                    stacked=stacked_fn(tuple(s)))
                for k, s in shapes.items()}

    def grad_spec_tree(self, master_specs: dict) -> Optional[dict]:
        """Stage >= 2: grads take the master layout (a reduce-scatter);
        below: None (an all-reduce)."""
        return master_specs if self.stage >= 2 else None


def stacked_fn(n_layer: int) -> Callable:
    """JAX's ``stacked_fn``: a shape is layer-stacked when it has 2+ dims
    and its first is ``n_layer`` (the scan dim, never cut)."""
    return lambda shape: len(shape) >= 2 and shape[0] == n_layer
