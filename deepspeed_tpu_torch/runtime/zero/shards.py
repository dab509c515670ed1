"""The physical side of a ZeRO layout: shards, gathers, stage 3's gather on
use.

A leaf is whole on every rank, or cut along one dim (:class:`Cut`) over a
line of the mesh, rank ``index`` holding chunk ``index`` of ``n``: the
shard JAX keeps on the same device for the same spec. At a world of one
with a process group every cut leaf is one chunk of one, and each
collective below is a copy over a group of one rank.

Stage 3 (:class:`GatherSet`): each cut compute leaf enters the model
through :class:`_Gather`, an autograd function that all-gathers the shard
in its forward and, in its backward, reduce-scatters the leaf's grad into
the shard's accumulator as soon as that grad is whole (every use of the
leaf has run its backward). A stacked ``layers.*`` leaf is a
:class:`GatheredStack` whose ``[i]`` gathers layer i's slice and frees layer
i-1's (the model's trunk indexes ``v[i]`` once per layer). A freed leaf
keeps its tensor and drops its storage (``resize_(0)``): autograd's saved
tensors and a checkpointed layer's inputs refer to that tensor, so the
first backward of layer i's leaves gathers layer i-1 again before any of
its backward runs (autograd runs the node created last first, and layer
i's gathers were created after every op of layer i-1). At most two
layers' gathered leaves are alive at once, with or without remat.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...comm import comm
from .qwz import row_absmax, rowwise_dequant, rowwise_quant_int8


@dataclasses.dataclass(frozen=True)
class Cut:
    """``dim`` of a leaf cut over the mesh line along ``axes``: ``n``
    chunks, this rank's is ``index``."""
    dim: int
    axes: tuple
    n: int
    index: int

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``full`` (a view)."""
        c = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * c, c)

    def inner(self) -> "Cut":
        """The same cut on one layer of a stacked leaf."""
        return dataclasses.replace(self, dim=self.dim - 1)


def spec_cut(spec: tuple, mesh, only: Optional[tuple] = None) -> Optional[Cut]:
    """This rank's :class:`Cut` of a leaf laid out by ``spec`` (one tuple
    of axis names per dim): the dim cut over axes of more than one rank
    (of ``only`` where given: the ZeRO axes of a leaf the tensor-parallel
    layout has cut already), or None where the leaf is whole."""
    for d, entry in enumerate(spec):
        real = tuple(a for a in entry if mesh.shape[a] > 1
                     and (only is None or a in only))
        if real:
            return Cut(d, real, mesh.size(real), mesh.index(real))
    return None


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Where one leaf lives. ``master``: the fp32 master's and the moments'
    cut (None: whole). ``compute``: stage 3's compute shard (None: the
    compute copy is whole). ``hier``: hpZ, the compute shard is the master
    shards of this rank's ``data`` line gathered (``data_len`` of them), so
    a gather over ``zero`` yields the chunks ordered (zero, data) and is
    reordered to the leaf's (data, zero). ``qwz``: the gather across
    ``data`` carries int8."""
    name: str
    shape: tuple
    layered: bool
    master: Optional[Cut] = None
    compute: Optional[Cut] = None
    hier: bool = False
    data_len: int = 1
    qwz: bool = False


def _swap_blocks(x: torch.Tensor, dim: int, a: int, b: int) -> torch.Tensor:
    """``x`` with ``dim`` read as (a, b, chunk) blocks reordered to (b, a,
    chunk), contiguous."""
    moved = x.movedim(dim, 0).contiguous()
    rest = tuple(moved.shape[1:])
    out = moved.view((a, b, moved.shape[0] // (a * b)) + rest) \
        .transpose(0, 1).reshape((moved.shape[0],) + rest)
    return out.movedim(0, dim).contiguous()


def quantize_rows(shard: torch.Tensor, dim: int, row_axes, mesh):
    """qwZ's (int8, fp32 scale) of a shard cut along ``dim``, each scale
    the max of its row over the whole leaf: where ``dim`` is the last, a
    row is split over ``row_axes`` and its max is all-reduced there first
    (every rank then holds the same, whole scales)."""
    absmax = row_absmax(shard)
    if dim == shard.dim() - 1:
        comm.all_reduce(absmax, row_axes, "max", mesh=mesh)
    return rowwise_quant_int8(shard, absmax)


def quantized_gather(shard: torch.Tensor, dim: int, gather_axes,
                     row_axes, mesh, dtype) -> torch.Tensor:
    """qwZ: ``shard`` quantized (:func:`quantize_rows`), gathered over
    ``gather_axes`` along ``dim`` as int8 and fp32 scales (scales only
    where they are cut too), dequantized to ``dtype``."""
    q, scale = quantize_rows(shard, dim, row_axes, mesh)
    q = comm.all_gather(q, gather_axes, dim, mesh=mesh)
    if dim != shard.dim() - 1:
        scale = comm.all_gather(scale, gather_axes, dim, mesh=mesh)
    return rowwise_dequant(q, scale, dtype)


def gather_compute(plan: LeafPlan, master: torch.Tensor, mesh,
                   dtype) -> torch.Tensor:
    """The whole compute copy of a leaf from this rank's master: cast, and
    all-gathered over the master's line where it is cut (as int8 under
    qwZ)."""
    cut = plan.master
    if cut is None:
        return master.to(dtype, copy=True)
    if plan.qwz:
        return quantized_gather(master, cut.dim, cut.axes, cut.axes, mesh,
                                dtype)
    return comm.all_gather(master.to(dtype), cut.axes, cut.dim, mesh=mesh)


def compute_shard(plan: LeafPlan, master: torch.Tensor, mesh,
                  dtype) -> torch.Tensor:
    """Stage 3's compute shard from this rank's master shard: the cast
    shard, or under hpZ the master shards of the ``data`` line gathered
    (as int8 under qwZ)."""
    if not plan.hier:
        return master.to(dtype, copy=True)
    if plan.qwz:
        return quantized_gather(master, plan.master.dim, ("data",),
                                plan.master.axes, mesh, dtype)
    return comm.all_gather(master.to(dtype), ("data",), plan.master.dim,
                           mesh=mesh)


def reduce_scatter_buckets(items: list, axes, mesh,
                           bucket_elems: int) -> dict:
    """Stage 2's grad reduction: ``items`` (name, whole local grad, cut
    along ``dim`` over ``axes``) packed into flat buffers of at most
    ``bucket_elems`` elements (a bigger leaf alone), each buffer
    reduce-scattered once; returns this rank's summed shard of each."""
    n = mesh.size(axes)
    buckets, cur, size = [], [], 0
    for it in items:
        k = it[1].numel()
        if cur and size + k > bucket_elems:
            buckets.append(cur)
            cur, size = [], 0
        cur.append(it)
        size += k
    if cur:
        buckets.append(cur)
    out = {}
    for bucket in buckets:
        t0 = bucket[0][1]
        m = sum(t.numel() // n for _, t, _ in bucket)
        flat = torch.empty((n, m), dtype=t0.dtype, device=t0.device)
        off = 0
        for _, t, cut in bucket:
            k = t.numel() // n
            flat[:, off:off + k].copy_(t.movedim(cut.dim, 0).reshape(n, k))
            off += k
        part = comm.reduce_scatter(flat.view(-1), axes, 0, mesh=mesh)
        off = 0
        for name, t, cut in bucket:
            k = t.numel() // n
            moved = t.movedim(cut.dim, 0)
            shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
            out[name] = part[off:off + k].view(shape).movedim(0, cut.dim) \
                .contiguous()
            off += k
    return out


# ------------------------------------------------------ stage 3 gather on use
class _Slot:
    """One gathered leaf of one micro-batch: a layer's slice of a stacked
    leaf, or a top-level leaf (``layer`` None)."""

    def __init__(self, gs: "GatherSet", key, layer: Optional[int],
                 shard: torch.Tensor, acc: torch.Tensor, cut: Cut,
                 hier: bool, data_len: int, shape: tuple):
        self.gs, self.key, self.layer = gs, key, layer
        self.shard, self.acc, self.cut = shard, acc, cut
        self.hier, self.data_len, self.shape = hier, data_len, shape
        self.alias = None          # the gathered tensor's data, no autograd
        self.alive = False

    def _fill(self, out: torch.Tensor) -> None:
        if self.hier:
            out.copy_(_swap_blocks(
                comm.all_gather(self.shard, self.cut.axes, self.cut.dim,
                                mesh=self.gs.mesh),
                self.cut.dim, self.cut.n, self.data_len))
        else:
            comm.all_gather(self.shard, self.cut.axes, self.cut.dim,
                            mesh=self.gs.mesh, out=out)

    def gather(self) -> torch.Tensor:
        full = torch.empty(self.shape, dtype=self.shard.dtype,
                           device=self.shard.device)
        self._fill(full)
        self.alias = full.data
        self._up()
        return full

    def regather(self) -> None:
        if self.alive or self.alias is None:
            return
        a = self.alias
        a.untyped_storage().resize_(a.numel() * a.element_size())
        self._fill(a)
        self._up()

    def release(self) -> None:
        if self.alive:
            self.alias.untyped_storage().resize_(0)
            self.alive = False
            self.gs._down(self.layer)

    def _up(self) -> None:
        self.alive = True
        self.gs._up(self.layer)

    def backward(self, g: torch.Tensor) -> None:
        if self.hier:
            g = _swap_blocks(g, self.cut.dim, self.data_len, self.cut.n)
        part = comm.reduce_scatter(g, self.cut.axes, self.cut.dim,
                                   mesh=self.gs.mesh)
        if self.gs.seed(self.key, self.layer):
            self.acc.copy_(part)
        else:
            self.acc.add_(part.to(self.acc.dtype))
        self.release()
        if self.layer:
            self.gs.ensure(self.layer - 1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, slot):
        ctx.slot = slot
        return slot.gather()

    @staticmethod
    def backward(ctx, g):
        ctx.slot.backward(g)
        return None, None


class GatheredStack:
    """A stacked leaf as the trunk sees it: ``[i]`` is layer i's gathered
    slice (layer i-1's is freed first)."""

    def __init__(self, slots: list):
        self.slots = slots

    def __len__(self) -> int:
        return len(self.slots)

    def __getitem__(self, i: int) -> torch.Tensor:
        if i > 0:
            self.slots[i - 1].release()
        return self.slots[i].gs.apply(self.slots[i])


class GatherSet:
    """Stage 3's gathered leaves over one optimizer step: the slots of each
    micro-batch, which accumulator slices are seeded, and the count of
    layers whose gathered leaves are alive (``peak_layers``: the most at
    once)."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.anchor = torch.empty(0, device=device, requires_grad=True)
        self._layers: dict = {}
        self._alive: dict = {}
        self._seeded: set = set()
        self.peak_layers = 0

    def _up(self, layer) -> None:
        if layer is None:
            return
        self._alive[layer] = self._alive.get(layer, 0) + 1
        self.peak_layers = max(self.peak_layers, len(self._alive))

    def _down(self, layer) -> None:
        if layer is None:
            return
        self._alive[layer] -= 1
        if not self._alive[layer]:
            del self._alive[layer]

    def seed(self, key, layer) -> bool:
        """True the first time (key, layer) reaches its accumulator this
        step: copy rather than add, as the whole-leaf path does."""
        if (key, layer) in self._seeded:
            return False
        self._seeded.add((key, layer))
        return True

    def seeded(self, key, layer) -> bool:
        return (key, layer) in self._seeded

    def apply(self, slot: _Slot) -> torch.Tensor:
        if torch.is_grad_enabled():
            return _Gather.apply(self.anchor, slot)
        return slot.gather()

    def ensure(self, layer: int) -> None:
        """Layer ``layer``'s leaves gathered again (before its backward)."""
        for s in self._layers.get(layer, ()):
            s.regather()

    def leaf(self, key, plan: LeafPlan, shard: torch.Tensor,
             acc: Optional[torch.Tensor]):
        """The model's value of one cut compute leaf for one micro-batch: a
        gathered tensor, or a :class:`GatheredStack` for a stacked one."""
        if not plan.layered:
            return self.apply(_Slot(self, key, None, shard, acc,
                                    plan.compute, plan.hier, plan.data_len,
                                    plan.shape))
        slots = []
        for i in range(plan.shape[0]):
            s = _Slot(self, key, i, shard[i],
                      None if acc is None else acc[i], plan.compute.inner(),
                      plan.hier, plan.data_len, plan.shape[1:])
            self._layers.setdefault(i, []).append(s)
            slots.append(s)
        return GatheredStack(slots)

    def release_all(self) -> None:
        """Free every gathered leaf (after a forward with no backward) and
        forget the micro-batch's slots."""
        for slots in self._layers.values():
            for s in slots:
                s.release()
        self._layers = {}
