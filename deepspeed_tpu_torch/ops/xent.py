"""Fused softmax cross-entropy over the unembedding.

Counterpart of ``deepspeed_tpu/ops/xent.py``, whose Pallas kernels
(``_fwd_kernel``, ``_dx_kernel``, ``_dw_kernel``) become CUDA kernels for
Hopper: the forward in ``csrc/xent.cu``, the backward (dx, dW and db in
one call, each logits tile formed once) in ``csrc/xent_bwd_sm90.cu``
(each header says what bounds it and how it is laid out), built by
``ops/builder.py`` and called through ctypes. No ``(T, V)`` logits tensor
reaches device memory: the forward emits the per-token NLL and logsumexp
only, the backward recomputes the logits chunk by chunk of the vocabulary
from the saved logsumexp.

The wrappers :func:`xent_fwd` and :func:`xent_bwd` launch their kernels
for CUDA tensors and take the plain PyTorch versions beside them for CPU
tensors only; on a CUDA tensor they launch or raise. Each counts its calls
in ``.launches``. :func:`fused_token_nll` wraps them in one
``torch.autograd.Function``.

On the card the kernels take bf16 with ``d % 16 == 0``; fp32 and fp16
operands raise there (fp16 never reaches them: :func:`fused_xent_eligible`).
The CPU path takes any float dtype. :func:`fused_token_nll_tp` is the
vocab-sharded wrapper of a tensor-parallel head: each rank's kernels run
on its rows of the table in ``partials`` mode and three collectives over
the ``model`` line make the global loss.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..comm import comm
from . import builder
from .registry import counted

# the TPU kernels' element budget for their (bt + bv) x d tiles and their
# smallest tile (``ops/xent.py:186-187`` of the JAX package): kept as the
# routing rule only, so both packages take the same loss path for the same
# config; the CUDA kernels pick their own tiles
_TILE_ELEM_BUDGET = (256 + 512) * 2048
_MIN_TILE = 128
_FWD_ROWS, _FWD_COLS = 128, 256       # the forward's tile (csrc/xent.cu)
# the backward's tiles (csrc/xent_bwd_sm90.cu): (a) 256 tokens x 128 vocab
# rows, (b) 256 rows x 128 columns of d
_BWD_ROWS, _BWD_COLS = 256, 128
# the backward's vocab chunk: of 1024-8192 rows the widest was the fastest
# at GPT-2 1.5B's and the 8191-token heads on an H100, within 1% of it at
# BERT-large's (PERF.md §6)
BWD_VC = 8192


def fused_xent_eligible_d(d: int) -> bool:
    """Does the feature width fit the TPU kernels' smallest tiles? Past
    d 6144 the JAX package routes the unfused loss; so does the port."""
    return (2 * _MIN_TILE) * d <= _TILE_ELEM_BUDGET


def fused_xent_eligible(cfg_dtype, compute_dtype, d_model: int,
                        on_card: bool) -> bool:
    """``fused_xent_eligible`` of the JAX package: fp16, as the trunk's
    dtype or the engine's compute dtype, never reaches the kernels on the
    accelerator, and the width must pass :func:`fused_xent_eligible_d`."""
    if on_card and torch.float16 in (cfg_dtype, compute_dtype):
        return False
    return fused_xent_eligible_d(d_model)


# ------------------------------------------------------------ plain versions
def _logits(x, w, bias):
    """fp32 (T, V) logits as the kernels form them: products of the
    storage-dtype operands summed in fp32 (never a bf16 matmul output), the
    bias rounded to x's dtype first."""
    logits = x.float() @ w.float().T
    if bias is not None:
        logits = logits + bias.to(x.dtype).float()
    return logits


def _onehot(targets, V: int):
    """(T, V) bool: column == target; a target outside [0, V) matches
    nothing."""
    cols = torch.arange(V, device=targets.device)
    return cols[None, :] == targets[:, None]


def xent_fwd_plain(x, w, bias, targets, partials: bool = False):
    """The forward kernel's function in plain tensor ops. Returns fp32
    ``(nll, lse)``, each ``(T,)``; with ``partials`` the target logit (0
    for a target outside ``[0, V)``) and ``m + log(max(s, 1e-30))``."""
    logits = _logits(x, w, bias)
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    tgt = torch.where(_onehot(targets, w.shape[0]), logits, 0.0).sum(dim=-1)
    if partials:
        return tgt, m + torch.log(s.clamp_min(1e-30))
    lse = m + torch.log(s)
    return lse - tgt, lse


def xent_bwd_plain(x, w, bias, targets, lse, g):
    """The backward kernels' function: ``(dx, dw, db)`` with dx in x's
    dtype, dw in w's and db ``(V,)`` fp32. ``dl = (exp(logits - lse) -
    onehot) * g`` in fp32 is rounded to w's dtype before both products
    (fp32 accumulation); db sums the unrounded dl."""
    logits = _logits(x, w, bias)
    p = torch.exp(logits - lse.float()[:, None])
    dl = (p - _onehot(targets, w.shape[0]).float()) * g.float()[:, None]
    dlr = dl.to(w.dtype).float()
    dx = (dlr @ w.float()).to(x.dtype)
    dw = (dlr.T @ x.float()).to(w.dtype)
    return dx, dw, dl.sum(dim=0)


def xent_bwd_plan(T: int, V: int, d: int, sms: int,
                  vc: Optional[int] = None) -> dict:
    """How the backward walks the vocabulary, from shapes alone: chunks of
    ``vc`` rows (default :data:`BWD_VC`, a multiple of 256, cut to V
    rounded up to 256 and to T * vc < 2^31), two launches each: (a) the
    chunk's dl, ``tiles_dl`` tiles of 256 tokens x 128 vocab rows; (b) its
    dW and dx products, ``tiles_prod`` tiles of 256 rows x 128 columns of
    d. Each launch runs ``min(tiles, sms)`` persistent blocks. The scratch it needs does not
    grow with V: ``dl`` (T, vc) bf16, ``dbpart`` (ceil(T / 256), vc) fp32
    and, with more than one chunk, ``dxacc`` (T, d) fp32; sizes in
    elements, and their sum in ``scratch_bytes``."""
    vc = BWD_VC if vc is None else vc
    if vc <= 0 or vc % _BWD_ROWS:
        raise ValueError(f"xent_bwd: the chunk must be a positive multiple "
                         f"of {_BWD_ROWS}, got {vc}")
    # the dl scratch's offsets are 32-bit: T * vc < 2^31
    fit = (2 ** 31 - 1) // T // _BWD_ROWS * _BWD_ROWS
    if not fit:
        raise ValueError(f"xent_bwd: T {T} passes the dl scratch's 32-bit "
                         "offsets")
    vc = min(vc, -(-V // _BWD_ROWS) * _BWD_ROWS, fit)
    chunks = [(v0, min(vc, V - v0)) for v0 in range(0, V, vc)]
    ntt, ndt = -(-T // _BWD_ROWS), -(-d // _BWD_COLS)
    tiles_dl = [ntt * -(-vw // _BWD_COLS) for _, vw in chunks]
    tiles_prod = [(-(-vw // _BWD_ROWS) + ntt) * ndt for _, vw in chunks]
    dl, dbpart = T * vc, ntt * vc
    dxacc = T * d if len(chunks) > 1 else 0
    return {"vc": vc, "chunks": chunks, "launches": 2 * len(chunks),
            "tiles_dl": tiles_dl, "tiles_prod": tiles_prod,
            "blocks_dl": [min(t, sms) for t in tiles_dl],
            "blocks_prod": [min(t, sms) for t in tiles_prod],
            "dl": dl, "dbpart": dbpart, "dxacc": dxacc,
            "scratch_bytes": 2 * dl + 4 * dbpart + 4 * dxacc}


# ------------------------------------------------------------------ kernels
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = builder.load("xent")
    if lib.dstpu_xent_fwd.argtypes is None:
        # pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit C int and cuts the pointer
        lib.dstpu_xent_fwd.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib.dstpu_xent_fwd.restype = _I
    return lib


def _bwd_lib():
    lib = builder.load("xent_bwd_sm90")
    if lib.dstpu_xent_bwd.argtypes is None:
        lib.dstpu_xent_bwd.argtypes = [_P] * 13 + [_I] * 4 + [_P]
        lib.dstpu_xent_bwd.restype = _I
    return lib


def _check(name, x, w, bias, targets, *fp32):
    """Raise on what the kernels do not take; returns the operands as the
    kernels read them: ``(T, V, d, bias in x's dtype or None, int32
    targets)``. ``fp32`` are lse and g."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit w "
                         f"{tuple(w.shape)}; want (T, d) and (V, d)")
    (T, d), V = x.shape, w.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: the CUDA kernels take bf16 x and w, got {x.dtype} and "
            f"{w.dtype} (fp32 runs on the CPU path only; fp16 takes the "
            "unfused loss)")
    if d % 16 or T == 0:
        raise ValueError(f"{name}: d must be a multiple of 16 and T > 0, "
                         f"got T {T}, d {d}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if tuple(targets.shape) != (T,) or targets.dtype not in (torch.int32,
                                                              torch.int64):
        raise ValueError(f"{name}: targets must be ({T},) int32 or int64")
    if bias is not None:
        if tuple(bias.shape) != (V,):
            raise ValueError(f"{name}: bias must be ({V},)")
        bias = bias.to(x.dtype).contiguous()
    targets = targets.to(torch.int32).contiguous()
    if any(t.dtype != torch.float32 or tuple(t.shape) != (T,) for t in fp32):
        raise ValueError(f"{name}: lse and g must be fp32 ({T},)")
    for t in (x, w, targets, *fp32) + (() if bias is None else (bias,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on "
                             "x's device")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    return T, V, d, bias, targets


def fwd_splits(T: int, V: int, sms: int) -> int:
    """Vocab splits of the forward's grid: as many as keep its blocks (one
    to an SM) within one wave over the card's ``sms`` SMs when the token
    tiles alone are fewer, none of them empty."""
    tiles_t = -(-T // _FWD_ROWS)
    tiles_v = -(-V // _FWD_COLS)
    want = max(1, min(tiles_v, sms // tiles_t))
    per = -(-tiles_v // want)
    return -(-tiles_v // per)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@counted
def xent_fwd(x, w, bias, targets, partials: bool = False):
    """Forward: fp32 ``(nll, lse)`` of ``softmax(x @ w.T + bias)`` per
    token, or with ``partials`` the shard-local ``(target logit,
    logsumexp)``. x ``(T, d)``, w ``(V, d)``, bias ``(V,)`` or None,
    targets ``(T,)`` ints."""
    if x.device.type == "cpu":
        return xent_fwd_plain(x, w, bias, targets, partials)
    T, V, d, bias, targets = _check("xent_fwd", x, w, bias, targets)
    nsplit = fwd_splits(T, V, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=x.device)
    out0, out1 = (torch.empty((T,), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    err = _lib().dstpu_xent_fwd(
        x.data_ptr(), w.data_ptr(), _ptr(bias), targets.data_ptr(),
        part.data_ptr(), out0.data_ptr(), out1.data_ptr(), T, V, d, nsplit,
        int(partials), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "xent_fwd")
    xent_fwd.launches += 1
    return out0, out1


_plans: dict = {}
_sms: dict = {}
_scratch: dict = {}


def _bwd_plan(T, V, d, device, vc) -> dict:
    key = (T, V, d, vc, device.index)
    plan = _plans.get(key)
    if plan is None:
        sms = _sms.get(device.index)
        if sms is None:
            sms = _sms[device.index] = torch.cuda.get_device_properties(
                device).multi_processor_count
        plan = _plans[key] = xent_bwd_plan(T, V, d, sms, vc)
    return plan


def _bwd_scratch(device, plan: dict):
    """The backward's scratch (dl bf16, db partials and the dx buffer
    fp32, flat; the kernels' int32 tile counter, zeroed once: every launch
    leaves it 0), cached per device and grown when a call needs more.
    Calls on one device run in stream order, so one set serves them all."""
    have = _scratch.get(device.index, {})
    if "ctr" not in have:
        have["ctr"] = torch.zeros(1, dtype=torch.int32, device=device)
    out = []
    for name, dtype in (("dl", torch.bfloat16), ("dbpart", torch.float32),
                        ("dxacc", torch.float32)):
        t = have.get(name)
        if plan[name] and (t is None or t.numel() < plan[name]):
            t = torch.empty(plan[name], dtype=dtype, device=device)
        have[name] = t
        out.append(t if plan[name] else None)
    _scratch[device.index] = have
    return out + [have["ctr"]]


@counted
def xent_bwd(x, w, bias, targets, lse, g, vc: Optional[int] = None):
    """The backward in one call: ``(dx, dw, db)``, dx ``(T, d)`` in x's
    dtype, dw ``(V, d)`` in w's, db ``(V,)`` fp32, from the saved lse and
    the cotangent g, both ``(T,)`` fp32. On the card the vocabulary is
    walked in chunks of ``vc`` rows (default :data:`BWD_VC`), two launches
    each (:func:`xent_bwd_plan`); ``.launches`` counts the calls. One
    kernel pair takes every shape the wrapper accepts."""
    if x.device.type == "cpu":
        return xent_bwd_plain(x, w, bias, targets, lse, g)
    T, V, d, bias, targets = _check("xent_bwd", x, w, bias, targets, lse, g)
    plan = _bwd_plan(T, V, d, x.device, vc)
    dl, dbpart, dxacc, ctr = _bwd_scratch(x.device, plan)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    db = torch.empty((V,), dtype=torch.float32, device=x.device)
    err = _bwd_lib().dstpu_xent_bwd(
        x.data_ptr(), w.data_ptr(), _ptr(bias), targets.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), dl.data_ptr(), dbpart.data_ptr(), _ptr(dxacc),
        ctr.data_ptr(), T, V, d, plan["vc"],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "xent_bwd")
    xent_bwd.launches += 1
    return dx, dw, db


# ------------------------------------------------------------ autograd
class _FusedNLL(torch.autograd.Function):
    """Forward saves the operands and the fp32 lse; backward runs dx, dW
    and db against it in one call."""

    @staticmethod
    def forward(ctx, x, w, bias, targets):
        nll, lse = xent_fwd(x, w, bias, targets)
        ctx.save_for_backward(x, w, bias, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, bias, targets, lse = ctx.saved_tensors
        dx, dw, db = xent_bwd(x, w, bias, targets, lse,
                              g.float().contiguous())
        dbias = None if bias is None else db.to(bias.dtype)
        return dx, dw, dbias, None


def fused_token_nll(x, w, bias: Optional[torch.Tensor], targets):
    """Per-token NLL of ``softmax(x @ w.T + bias)`` with no ``(T, V)``
    tensor, differentiable in x, w and bias.

    x: ``(T, d)`` compute dtype; w: ``(V, d)``, the unembedding in the
    embedding table's layout; bias: ``(V,)`` or None; targets: ``(T,)``
    ints in ``[0, V)`` (one outside matches nothing). Returns ``(T,)``
    fp32."""
    if x.device.type == "cuda":
        x, w = x.contiguous(), w.contiguous()
    return _FusedNLL.apply(x, w, bias, targets)


# ------------------------------------------------ tensor-parallel (vocab)
def tp_combine(tgt_p, lse_l, axis_name, mesh):
    """The global ``(nll, lse)`` from each rank's ``partials`` over the
    line along ``axis_name`` (``_fwd_tp``, ``ops/xent.py:392-402`` of the
    JAX package): ``lse = m + log(sum exp(lse_l - m))`` about the line's
    max ``m``, and the target logit summed (a foreign target's partial is
    0). Over a line of one rank ``lse`` is ``lse_l + log(1)``: exact."""
    m = comm.all_reduce(lse_l.clone(), axis_name, "max", mesh=mesh)
    s = comm.all_reduce(torch.exp(lse_l - m), axis_name, mesh=mesh)
    tgt = comm.all_reduce(tgt_p.clone(), axis_name, mesh=mesh)
    lse = m + torch.log(s)
    return lse - tgt, lse


class _FusedNLLTP(torch.autograd.Function):
    """Forward: the rank's partials, combined over the line; backward: the
    kernels against the GLOBAL lse, dx summed over the line, dW and db
    the rank's own rows. The cotangent is every rank's own (each computes
    the same loss), so nothing is rescaled by the line's size."""

    @staticmethod
    def forward(ctx, x, w_shard, bias_shard, targets, v0, axis_name, mesh):
        local = targets - v0          # a foreign target matches no row
        tgt_p, lse_l = xent_fwd(x, w_shard, bias_shard, local,
                                partials=True)
        nll, lse = tp_combine(tgt_p, lse_l, axis_name, mesh)
        ctx.save_for_backward(x, w_shard, bias_shard, local, lse)
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, bias, local, lse = ctx.saved_tensors
        dx, dw, db = xent_bwd(x, w, bias, local, lse, g.float().contiguous())
        dx = comm.all_reduce(dx, ctx.axis_name, mesh=ctx.mesh)
        dbias = None if bias is None else db.to(bias.dtype)
        return dx, dw, dbias, None, None, None, None


def fused_token_nll_tp(x, w_shard, bias_shard: Optional[torch.Tensor],
                       targets, *, v0: int, axis_name="model", mesh):
    """:func:`fused_token_nll` over a vocabulary cut along ``axis_name``
    (``fused_token_nll_tp``, ``ops/xent.py:373-435`` of the JAX package):
    ``w_shard`` ``(V / tp, d)`` holds rows ``[v0, v0 + V / tp)`` and
    ``bias_shard`` their bias; ``targets`` are GLOBAL ids. No rank forms
    its ``(T, V / tp)`` logits. Returns the global ``(T,)`` fp32 NLL on
    every rank of the line; x's grad is the line's sum, the table's and
    the bias's grads are the rank's rows."""
    if x.device.type == "cuda":
        x, w_shard = x.contiguous(), w_shard.contiguous()
    return _FusedNLLTP.apply(x, w_shard, bias_shard, targets, int(v0),
                             axis_name, mesh)


def fused_token_nll_tp_plain(x, w_shard, bias_shard, targets, *, v0: int,
                             axis_name="model", mesh):
    """The same function in plain tensor ops (logits formed, autograd
    through them): what :func:`fused_token_nll_tp` is held to."""
    from ..comm.autograd import copy_to, max_from, reduce_from

    x = copy_to(x, axis_name, mesh=mesh)
    logits = _logits(x, w_shard, bias_shard)
    local = targets - v0
    m = max_from(logits.amax(dim=-1).detach(), axis_name, mesh=mesh)
    s = reduce_from(torch.exp(logits - m[:, None]).sum(dim=-1), axis_name,
                    mesh=mesh)
    tgt = reduce_from(torch.where(_onehot(local, w_shard.shape[0]), logits,
                                  0.0).sum(dim=-1), axis_name, mesh=mesh)
    return m + torch.log(s) - tgt
