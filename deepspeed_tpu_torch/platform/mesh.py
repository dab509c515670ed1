"""The named mesh over a ``torch.distributed`` world (counterpart of
``deepspeed_tpu/platform/mesh.py:58-135``).

JAX lays the devices out as an array with one named axis per kind of
parallelism and compiles collectives over those axes. Here a rank is one
process with one device; :func:`build_mesh` gives each rank its coordinates
in the same order (``AXIS_ORDER``, row-major over the world's ranks, as
``build_mesh`` reshapes its device list), so rank ``r`` holds what JAX
device ``r`` holds, and makes one process group per line of the ``data``,
``zero``, ``model`` and ``expert`` axes, of the joint ``("expert",
"model")`` axis (the MoE combine of expert-parallel serving) and of the
joint batch lines (``BATCH_AXES`` and its ``("data", "zero")`` and
``("data", "expert")`` parts: the loss mean and the grad reductions of a
training world whose ``model`` axis is above 1). ``pipe`` and ``seq``
above 1 raise with the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..utils.logging import log_dist
from ..utils.roadmap import later

# outermost to innermost; ``zero`` is the hpZ / MiCS sub-axis carved out of
# the data-parallel dimension (the whole data-parallel world is data x zero)
AXIS_ORDER = ("pipe", "data", "zero", "expert", "seq", "model")
# axes that partition examples: the divisor of the batch arithmetic
BATCH_AXES = ("data", "zero", "expert")
# an axis above 1 -> the ROADMAP item that ports it
_LATER = {"pipe": 8, "seq": 8}
# the lines that get a process group of their own where they are neither a
# single rank nor the whole world
_LINES = (("data",), ("zero",), ("expert",), ("model",), ("expert", "model"),
          ("data", "zero", "expert"), ("data", "zero"), ("data", "expert"))


@dataclasses.dataclass
class MeshSpec:
    """Logical parallelism degrees; ``data=-1`` absorbs the remaining
    ranks."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    zero: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"pipe": self.pipe, "data": self.data, "zero": self.zero,
                 "expert": self.expert, "seq": self.seq, "model": self.model}
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        n_auto = sum(1 for v in sizes.values() if v == -1)
        if n_auto > 1:
            raise ValueError("at most one mesh axis may be -1 (auto)")
        if n_auto == 1:
            if n_devices % fixed != 0:
                raise ValueError(f"device count {n_devices} not divisible by "
                                 f"fixed axes product {fixed}")
            auto = n_devices // fixed
            sizes = {k: (auto if v == -1 else v) for k, v in sizes.items()}
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(f"mesh {sizes} requires {total} devices but "
                             f"{n_devices} are available")
        return sizes


class Mesh:
    """This rank's place in the world: ``shape`` (axis -> size), ``rank``,
    ``coords`` (axis -> index) and the process group of each line.

    ``active`` is False when no process group is up (a single process with
    no ``init_distributed``): then every group is None, the world is 1 and
    the collectives of ``comm/comm.py`` return their input."""

    def __init__(self, shape: dict, rank: int = 0, active: bool = False,
                 groups: Optional[dict] = None):
        self.shape = {a: int(shape[a]) for a in AXIS_ORDER}
        self.rank = rank
        self.world = int(np.prod(list(self.shape.values())))
        self.active = active
        idx = np.unravel_index(rank, tuple(self.shape[a] for a in AXIS_ORDER))
        self.coords = {a: int(i) for a, i in zip(AXIS_ORDER, idx)}
        self._groups = groups or {}
        # axes as a caller names them -> AXIS_ORDER's tuple: the collectives
        # of a training step ask for a few lines hundreds of times
        self._named = {}

    def _axes(self, axes) -> tuple:
        key = axes if isinstance(axes, str) else tuple(axes)
        out = self._named.get(key)
        if out is None:
            names = (key,) if isinstance(key, str) else key
            out = self._named[key] = tuple(a for a in AXIS_ORDER
                                           if a in names)
        return out

    def size(self, axes) -> int:
        """Ranks along ``axes`` jointly (``()`` is 1)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's joint index along ``axes``, the first in
        ``AXIS_ORDER`` major (how JAX numbers the shards of a dim sharded
        over several axes)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def solo(self, axes) -> bool:
        """True where a collective along ``axes`` has nothing to do: no
        process group, or a line of this rank alone in a larger world (a
        world of one runs its collectives, over a group of one)."""
        return not self.active or (self.size(axes) == 1 and self.world > 1)

    def group(self, axes):
        """The process group of this rank's line along ``axes``: the ranks
        that share every other coordinate. None where that line is the whole
        world (the default group)."""
        axes = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if self.size(axes) == self.world:
            return None
        return self._groups[axes]

    def line_ranks(self, axes) -> list:
        """The global ranks of this rank's line along ``axes``, in the
        line's order."""
        axes = self._axes(axes)
        grid = np.arange(self.world).reshape(
            tuple(self.shape[a] for a in AXIS_ORDER))
        sel = tuple(slice(None) if a in axes else self.coords[a]
                    for a in AXIS_ORDER)
        return [int(r) for r in grid[sel].reshape(-1)]


def build_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """The mesh over the current ``torch.distributed`` world, or a world of
    one with no process group when none is up."""
    import torch.distributed as dist

    spec = spec or MeshSpec()
    active = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if active else 1
    rank = dist.get_rank() if active else 0
    sizes = spec.resolve(world)
    for axis, item in _LATER.items():
        if sizes[axis] > 1:
            raise NotImplementedError(f"mesh.{axis}={sizes[axis]} is not "
                                      f"ported yet: {later(item)}")
    mesh = Mesh(sizes, rank, active)
    if active:
        # every rank creates every line's group, in one order
        grid = np.arange(world).reshape(tuple(sizes[a] for a in AXIS_ORDER))
        made = set()
        for line_axes in _LINES:
            axes = tuple(a for a in line_axes if sizes[a] > 1)
            n = int(np.prod([sizes[a] for a in axes]))
            if not 1 < n < world or axes in made:
                continue
            made.add(axes)
            idx = [AXIS_ORDER.index(a) for a in axes]
            rest = [i for i in range(len(AXIS_ORDER)) if i not in idx]
            lines = np.transpose(grid, rest + idx).reshape(-1, n)
            for line in lines.tolist():
                g = dist.new_group(line)
                if rank in line:
                    mesh._groups[axes] = g
    log_dist(f"mesh: {sizes} over {world} rank(s)", ranks=[0])
    return mesh


def dp_world_size(mesh: Mesh) -> int:
    """Examples-parallel world size (data x zero x expert): the divisor in
    ``train_batch = micro_batch x GAS x dp_world``."""
    return mesh.size(BATCH_AXES)


def local_batch_slice(mesh: Mesh) -> tuple[int, int]:
    """(index, count) of this rank's slice of the global batch."""
    return mesh.index(BATCH_AXES), dp_world_size(mesh)
