"""Flash attention, forward and backward.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``, whose Pallas
kernels (``_fwd_kernel``, ``_make_bwd_dq_kernel``, ``_make_bwd_dkv_kernel``
and their streamed long-sequence twins) become CUDA kernels for Hopper,
built by ``ops/builder.py`` and called through ctypes. For bf16 / fp16 at
hd 32-128 the forward is ``csrc/flash_fwd_sm90.cu`` and the backward pair
``csrc/flash_bwd_dq_sm90.cu`` / ``csrc/flash_bwd_dkv_sm90.cu`` (wgmma, TMA,
warp specialisation; the pair's kernels in ``csrc/flash_bwd_sm90.cuh``);
for fp32 the forward at hd 32-128 is ``csrc/flash_fwd_f32_sm90.cu`` and
the backward pair at hd 32 and 64 ``csrc/flash_bwd_dq_f32_sm90.cu`` /
``csrc/flash_bwd_dkv_f32_sm90.cu`` (3xTF32 on wgmma, the pair's kernels in
``csrc/flash_bwd_f32_sm90.cuh``, the fp32 pieces all three share in
``csrc/tf32_sm90.cuh``); the rest of fp32 and the 16-bit hd 16 ones are
the mma.sync kernels of
``csrc/flash_attention.cuh``, instantiated for bf16 / fp16 hd 16 by
``csrc/flash_attention.cu`` and for fp32 by ``csrc/flash_attention_f32.cu``
(each source's header comment says what bounds its kernels and how they
are laid out). :func:`library` routes every launch. The kernels stream
K/V (or Q/dO) through shared memory at any S, so one kernel stands for
each TPU pair.

The wrappers :func:`flash_fwd`, :func:`flash_bwd_dq` and
:func:`flash_bwd_dkv` launch their kernel for CUDA tensors and take the
plain PyTorch versions beside them for CPU tensors only; on a CUDA tensor
they launch or raise. Each counts its launches in ``.launches``.
:func:`flash_attention` wraps them in one ``torch.autograd.Function``;
:func:`make_flash_attention` is the ``attention_fn`` factory of
``TransformerLM``.

On the card the kernels take bf16, fp16 and fp32 operands (fp32
accumulation; fp32 products through 3xTF32, about fp32's accuracy) with
head dims 16, 32, 64 and 128; other head dims raise. The additive score
bias (``bias=``: (S, S), (H, S, S) or (B|1, H|1, S, S), fp32, bf16 or fp16
whatever q's dtype) is read by all three kernels through its own strides,
a broadcast dim at stride 0, and ``flash_bwd_dq`` writes its gradient for
a full (B, H, S, S) bias. The CPU path takes any float dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import builder
from .registry import counted

BIG_NEG = -2.0 ** 30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.bfloat16: 2, torch.float16: 1, torch.float32: 3}
# the kernels that take 16-bit operands only (ops/sparse_attention.py)
HALF_DTYPE_CODE = {torch.bfloat16: 2, torch.float16: 1}
_DTYPE_NAME = {torch.bfloat16: "bf16", torch.float16: "fp16",
               torch.float32: "fp32"}


# ------------------------------------------------------------ plain versions
def _acc(t):
    """``t`` in the plain versions' compute type: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _keep_mask(B, S, device, *, mask, causal, keep=None):
    """(B|1, 1, S, S) bool: key t visible to query s. ``keep`` (S, S) bool
    narrows it further (a block-sparse layout)."""
    out = torch.ones((1, 1, S, S), dtype=torch.bool, device=device)
    if causal:
        out = out & torch.ones((S, S), dtype=torch.bool, device=device).tril()
    if keep is not None:
        out = out & keep.to(device)
    if mask is not None:
        out = out & (mask.float() > 0.5)[:, None, None, :]
    return out


def bias4(bias, B, H, S):
    """``bias`` as a (B|1, H|1, S, S) view (no copy). Raises ValueError on
    any other shape."""
    if bias.ndim in (2, 3, 4):
        b4 = bias[(None,) * (4 - bias.ndim)]
        if tuple(b4.shape[2:]) == (S, S) and b4.shape[0] in (1, B) \
                and b4.shape[1] in (1, H):
            return b4
    raise ValueError(f"bias must be (S, S), (H, S, S) or (B|1, H|1, S, S) "
                     f"with B {B}, H {H}, S {S}; got {tuple(bias.shape)}")


def _scores(q, k, *, mask, alibi_slopes, causal, keep=None, bias=None):
    """fp32 (B, H, S, S) scores as the kernels form them, masked positions
    at BIG_NEG, and the keep mask. q: (B, S, H, hd); k: (B, S, KV, hd);
    ``bias`` (S, S), (H, S, S) or (B|1, H|1, S, S), upcast and added
    before ALiBi and the masks (JAX ``_masked_scores`` :114)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kr = k.repeat_interleave(G, dim=2) if G > 1 else k
    # products of storage-dtype values are exact in fp32: the fp32 matmul
    # of the upcast operands is the kernels' bf16 x bf16 -> fp32 dot
    s = torch.einsum("bshd,bthd->bhst", _acc(q), _acc(kr))
    s = s * (1.0 / math.sqrt(hd))
    if bias is not None:
        s = s + bias4(bias, B, H, S).to(s.device, s.dtype)
    if alibi_slopes is not None:
        pos = torch.arange(S, device=q.device)
        rel = (pos[None, :] - pos[:, None]).float()
        s = s + alibi_slopes.float().to(q.device)[:, None, None] * rel
    keep = _keep_mask(B, S, q.device, mask=mask, causal=causal, keep=keep)
    return torch.where(keep, s, BIG_NEG), keep


def flash_attention_fwd_plain(q, k, v, *, mask=None, alibi_slopes=None,
                              causal=True, keep=None, bias=None):
    """The forward kernel's function in plain tensor ops: masked scores at
    BIG_NEG with zero probability, p rounded to v's dtype before p·v,
    l clamped to 1e-30. Returns o (B, S, H, hd) in q's dtype and the fp32
    logsumexp (B, H, S). ``keep`` (S, S) bool is a further keep-mask (the
    block-sparse plain versions pass their layout's); ``bias`` an additive
    score bias (:func:`bias4`'s shapes)."""
    G = q.shape[2] // k.shape[2]
    vr = v.repeat_interleave(G, dim=2) if G > 1 else v
    s, keep = _scores(q, k, mask=mask, alibi_slopes=alibi_slopes,
                      causal=causal, keep=keep, bias=bias)
    m = s.amax(dim=-1, keepdim=True).clamp_min(BIG_NEG)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhst,bthd->bshd", _acc(p.to(v.dtype)), _acc(vr))
    o = acc / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _bwd_plain(q, k, v, do, lse, delta, *, mask, alibi_slopes, causal,
               keep=None, bias=None):
    """(p, ds) (B, H, S, S) fp32, recomputed from the logsumexp."""
    G = q.shape[2] // k.shape[2]
    vr = v.repeat_interleave(G, dim=2) if G > 1 else v
    s, keep = _scores(q, k, mask=mask, alibi_slopes=alibi_slopes,
                      causal=causal, keep=keep, bias=bias)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", _acc(do), _acc(vr))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, mask=None,
                       alibi_slopes=None, causal=True, keep=None, bias=None,
                       grad_bias=False):
    """dq (B, S, H, hd): ds rounded to k's dtype before ds·k, scaled once.
    With ``grad_bias`` also dbias = ds (B, H, S, S) in the bias's dtype
    (JAX :270), 0 where the causal cut or the mask hides a position:
    returns (dq, dbias)."""
    G = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(G, dim=2) if G > 1 else k
    _, ds = _bwd_plain(q, k, v, do, lse, delta, mask=mask,
                       alibi_slopes=alibi_slopes, causal=causal, keep=keep,
                       bias=bias)
    dq = torch.einsum("bhst,bthd->bshd", _acc(ds.to(k.dtype)), _acc(kr))
    dq = (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)
    return (dq, ds.to(bias.dtype)) if grad_bias else dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, mask=None,
                        alibi_slopes=None, causal=True, keep=None,
                        bias=None):
    """(dk, dv) (B, S, KV, hd), each KV head summed over its query heads in
    fp32: p rounded to dO's dtype before pᵀ·dO, ds to q's before dsᵀ·q."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    p, ds = _bwd_plain(q, k, v, do, lse, delta, mask=mask,
                       alibi_slopes=alibi_slopes, causal=causal, keep=keep,
                       bias=bias)
    dk = torch.einsum("bhst,bshd->bthd", _acc(ds.to(q.dtype)), _acc(q))
    dv = torch.einsum("bhst,bshd->bthd", _acc(p.to(do.dtype)), _acc(do))
    dk = dk.reshape(B, S, KV, H // KV, hd).sum(3) * (1.0 / math.sqrt(hd))
    dv = dv.reshape(B, S, KV, H // KV, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, mask=None,
                              alibi_slopes=None, causal=True, bias=None,
                              grad_bias=False):
    """dq, dk, dv (and then dbias, with ``grad_bias``) from the forward's
    o and lse (delta = rowsum(dO·o))."""
    delta = attention_delta(o, do)
    kw = dict(mask=mask, alibi_slopes=alibi_slopes, causal=causal, bias=bias)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, grad_bias=grad_bias,
                            **kw)
    dkv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return (dq[0], *dkv, dq[1]) if grad_bias else (dq, *dkv)


def attention_delta(o, do):
    """rowsum(dO·o) in fp32, (B, H, S), as JAX computes it outside its
    kernels (``_bwd_call`` :348)."""
    return (_acc(do) * _acc(o)).sum(-1).transpose(1, 2).contiguous()


# ------------------------------------------------------------------ kernels
# the head dims whose fp32 backward pair runs on the 3xTF32 wgmma kernels
# (csrc/flash_bwd_f32_sm90.cuh); at hd 128 no stage fits beside the unit
F32_WGMMA_HEAD_DIMS = (32, 64)
# the head dims whose fp32 forward runs on its 3xTF32 wgmma kernel
# (csrc/flash_fwd_f32_sm90.cu); at hd 128 two slots of each ring fit
F32_FWD_WGMMA_HEAD_DIMS = (32, 64, 128)


def library(kernel: str, dtype, hd: int) -> str:
    """The library whose kernel serves a launch of ``kernel`` (``flash_fwd``,
    ``flash_bwd_dq`` or ``flash_bwd_dkv``) for q's dtype and head dim: the
    wgmma / TMA kernels of ``csrc/<kernel>_sm90.cu`` (one library each) for
    16-bit operands at hd 32-128 and of ``csrc/<kernel>_f32_sm90.cu`` (3xTF32)
    for the fp32 forward at hd 32-128 and the fp32 backward pair at hd 32
    and 64; the mma.sync kernels of ``csrc/flash_attention.cuh`` for 16-bit
    hd 16 (``flash_attention.cu``) and for the rest of fp32
    (``flash_attention_f32.cu``). Fixed: a route never depends on a
    failure."""
    if dtype == torch.float32:
        wgmma = F32_FWD_WGMMA_HEAD_DIMS if kernel == "flash_fwd" \
            else F32_WGMMA_HEAD_DIMS
        return f"{kernel}_f32_sm90" if hd in wgmma else "flash_attention_f32"
    return "flash_attention" if hd == 16 else f"{kernel}_sm90"


def flash_bwd_f32_plan(kernel: str, hd: int) -> dict:
    """The tiles of the fp32 wgmma ``kernel`` (``flash_bwd_dq`` or
    ``flash_bwd_dkv``) at head dim ``hd``, as ``csrc/flash_bwd_f32_sm90.cuh``
    builds them: ``unit`` rows (queries for dq, keys for dk/dv; one consumer
    warpgroup's wgmma m64), ``step`` rows of a streamed tile, ``stages``
    slots of the ring of natural halves and ``t_stages`` of the ring of
    transposed halves, and the block's dynamic shared memory in
    ``smem_bytes``. A unit holds two fp32 tiles (hi and lo) of each of its
    two operands; a natural slot four streamed tiles (dq: K and V, dk/dv: Q
    and dO, each TMA's tile and its lo; dk/dv also the step's lse and
    delta), a transposed slot the transposed hi and lo of dq's K or of
    dk/dv's Q and dO; then 1024 bytes of alignment slack and the barriers
    (three for the unit, three a natural slot, two a transposed one)."""
    if hd not in F32_WGMMA_HEAD_DIMS or kernel not in ("flash_bwd_dq",
                                                       "flash_bwd_dkv"):
        raise ValueError(f"no fp32 wgmma {kernel} at hd {hd}")
    unit, step, t_stages = 64, 32, 2
    unit_tile, step_tile = unit * hd * 4, step * hd * 4
    if kernel == "flash_bwd_dq":
        stages = 8 if hd == 32 else 4
        nat, trans = 4 * step_tile, 2 * step_tile
    else:
        stages = 8 if hd == 32 else 3
        nat, trans = 4 * step_tile + 2 * step * 4, 4 * step_tile
    smem = (1024 + 4 * unit_tile + stages * nat + t_stages * trans
            + 8 * (3 + 3 * stages + 2 * t_stages))
    return {"unit": unit, "step": step, "stages": stages,
            "t_stages": t_stages, "smem_bytes": smem}


def flash_fwd_f32_plan(hd: int) -> dict:
    """The tiles of the fp32 wgmma forward at head dim ``hd``, as
    ``csrc/flash_fwd_f32_sm90.cu`` builds them: ``unit`` query rows (the
    consumer warpgroup's wgmma m64), ``step`` keys a streamed tile,
    ``stages`` slots of the ring of natural halves (K as TMA wrote it, its
    lo tile, V as TMA wrote it) and ``t_stages`` of the ring of transposed
    halves (V's transposed hi and lo), and the block's dynamic shared memory
    in ``smem_bytes``: Q's two tiles (hi, lo), the slots, 1024 bytes of
    alignment slack and the barriers (three for the unit, three a natural
    slot, two a transposed one). At hd 128 two slots of each ring fit in
    227 KiB; other head dims raise."""
    if hd not in F32_FWD_WGMMA_HEAD_DIMS:
        raise ValueError(f"no fp32 wgmma flash_fwd at hd {hd}")
    unit, step, t_stages = 64, 32, 2
    stages = {32: 8, 64: 4, 128: 2}[hd]
    unit_tile, step_tile = unit * hd * 4, step * hd * 4
    smem = (1024 + 2 * unit_tile + stages * 3 * step_tile
            + t_stages * 2 * step_tile + 8 * (3 + 3 * stages + 2 * t_stages))
    return {"unit": unit, "step": step, "stages": stages,
            "t_stages": t_stages, "smem_bytes": smem}

def _lib(name):
    """The loaded library ``csrc/<name>.cu``, its functions typed."""
    lib = builder.load(name)
    fns = [getattr(lib, f) for f in ("dstpu_flash_fwd", "dstpu_flash_bwd_dq",
                                     "dstpu_flash_bwd_dkv") if hasattr(lib, f)]
    if fns[0].argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit C int and cuts the pointer; the
        # bias strides as 64-bit ints
        tail = [I] * 8 + [ctypes.c_longlong] * 2 + [F, P]
        for fn in fns:
            fn.argtypes = [P] * (8 if fn.__name__ == "dstpu_flash_fwd"
                                 else 11) + tail
            fn.restype = I
    return lib


def _check(name, q, k, v, do=None, *fp32, codes=_DTYPE_CODE):
    """Raise on what the kernels do not take; returns (B, S, H, KV, hd).
    q, k, v (and dO) share a dtype of ``codes``; ``fp32`` are lse and
    delta."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[:2] != (B, S) \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if q.dtype not in codes:
        take = ", ".join(_DTYPE_NAME[d] for d in codes)
        raise ValueError(f"{name}: the CUDA kernels take "
                         f"{' or '.join(take.rsplit(', ', 1))}, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    same = (k, v) if do is None else (k, v, do)
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} is not q's shape")
    if any(t.dtype != q.dtype for t in same) \
            or any(t.dtype != torch.float32 or t.shape != (B, H, S)
                   for t in fp32):
        raise ValueError(f"{name}: q/k/v/dO dtypes must match, lse and "
                         f"delta must be fp32 ({B}, {H}, {S})")
    for t in (q, *same, *fp32):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous, "
                             "16-byte aligned and on q's device")
    return B, S, H, k.shape[2], hd


def _side(mask, slopes, B, S, H, device):
    """The kernels' mask (B, S) uint8 and slopes (H,) fp32, or None."""
    m = s = None
    if mask is not None:
        if tuple(mask.shape) != (B, S):
            raise ValueError(f"mask must be ({B}, {S}), got "
                             f"{tuple(mask.shape)}")
        m = (mask.to(device).float() > 0.5).to(torch.uint8).contiguous()
    if slopes is not None:
        s = slopes.to(device, torch.float32).contiguous()
        if tuple(s.shape) != (H,):
            raise ValueError(f"alibi_slopes must be ({H},)")
    return m, s


def _bias_arg(name, bias, B, H, S, device):
    """The kernels' bias operand: (pointer, dtype code, batch stride, head
    stride), a broadcast dim at stride 0; (None, 0, 0, 0) without one. The
    bias is read where it lies, never copied or expanded."""
    if bias is None:
        return None, 0, 0, 0
    b4 = bias4(bias, B, H, S)
    if b4.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: the bias must be fp32, bf16 or fp16, got "
                         f"{b4.dtype}")
    if b4.device != device:
        raise ValueError(f"{name}: the bias is on {b4.device}, q on {device}")
    if S > 1 and (b4.stride(3) != 1 or b4.stride(2) != S):
        raise ValueError(f"{name}: the bias must be contiguous in its last "
                         f"two dims, got strides {tuple(b4.stride())}")
    return (b4.data_ptr(), _DTYPE_CODE[b4.dtype],
            b4.stride(0) if b4.shape[0] > 1 else 0,
            b4.stride(1) if b4.shape[1] > 1 else 0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@counted
def flash_fwd(q, k, v, *, mask=None, alibi_slopes=None, causal=True,
              bias=None):
    """Forward: o (B, S, H, hd) and fp32 lse (B, H, S). q (B, S, H, hd),
    k/v (B, S, KV, hd) in the JAX layout; ``mask`` (B, S) key padding
    ({0, 1}); ``alibi_slopes`` (H,); ``bias`` an additive score bias
    ((S, S), (H, S, S) or (B|1, H|1, S, S))."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, mask=mask,
                                         alibi_slopes=alibi_slopes,
                                         causal=causal, bias=bias)
    B, S, H, KV, hd = _check("flash_fwd", q, k, v)
    m, s = _side(mask, alibi_slopes, B, S, H, q.device)
    bp, bcode, sb, sh = _bias_arg("flash_fwd", bias, B, H, S, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _lib(library("flash_fwd", q.dtype, hd)).dstpu_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m), _ptr(s), bp,
        o.data_ptr(), lse.data_ptr(), B, S, H, KV, hd, int(causal),
        _DTYPE_CODE[q.dtype], bcode, sb, sh, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


@counted
def flash_bwd_dq(q, k, v, do, lse, delta, *, mask=None, alibi_slopes=None,
                 causal=True, bias=None, grad_bias=False):
    """dq (B, S, H, hd) from dO, the forward's lse and delta (B, H, S).
    With ``grad_bias`` (a full (B, H, S, S) bias, which may be a stride-0
    expanded view) also dbias (B, H, S, S) in the bias's dtype: returns
    (dq, dbias)."""
    B, S, H = q.shape[:3]
    if grad_bias and (bias is None
                      or tuple(bias4(bias, B, H, S).shape[:2]) != (B, H)):
        raise ValueError("flash_bwd_dq: grad_bias needs a full (B, H, S, S) "
                         "bias")
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, mask=mask,
                                  alibi_slopes=alibi_slopes, causal=causal,
                                  bias=bias, grad_bias=grad_bias)
    B, S, H, KV, hd = _check("flash_bwd_dq", q, k, v, do, lse, delta)
    m, s = _side(mask, alibi_slopes, B, S, H, q.device)
    bp, bcode, sb, sh = _bias_arg("flash_bwd_dq", bias, B, H, S, q.device)
    dq = torch.empty_like(q)
    # empty, not zeros: the kernel writes every element of dbias, zeros
    # where the causal loop skips a key tile
    dbias = torch.empty((B, H, S, S), dtype=bias.dtype, device=q.device) \
        if grad_bias else None
    err = _lib(library("flash_bwd_dq", q.dtype, hd)).dstpu_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(m), _ptr(s), bp, dq.data_ptr(),
        _ptr(dbias), B, S, H, KV, hd, int(causal), _DTYPE_CODE[q.dtype],
        bcode, sb, sh, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return (dq, dbias) if grad_bias else dq


@counted
def flash_bwd_dkv(q, k, v, do, lse, delta, *, mask=None, alibi_slopes=None,
                  causal=True, bias=None):
    """(dk, dv) (B, S, KV, hd), summed over each KV head's query heads."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, mask=mask,
                                   alibi_slopes=alibi_slopes, causal=causal,
                                   bias=bias)
    B, S, H, KV, hd = _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    m, s = _side(mask, alibi_slopes, B, S, H, q.device)
    bp, bcode, sb, sh = _bias_arg("flash_bwd_dkv", bias, B, H, S, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib(library("flash_bwd_dkv", q.dtype, hd)).dstpu_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(m), _ptr(s), bp, dk.data_ptr(),
        dv.data_ptr(), B, S, H, KV, hd, int(causal), _DTYPE_CODE[q.dtype],
        bcode, sb, sh, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


# ------------------------------------------------------------ autograd
class _Flash(torch.autograd.Function):
    """Forward saves o and the fp32 lse; backward runs dq (with dbias when
    the bias takes a gradient) then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, mask, slopes, bias, causal):
        o, lse = flash_fwd(q, k, v, mask=mask, alibi_slopes=slopes,
                           causal=causal, bias=bias)
        ctx.save_for_backward(q, k, v, o, lse, mask, slopes, bias)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask, slopes, bias = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        kw = dict(mask=mask, alibi_slopes=slopes, causal=ctx.causal,
                  bias=bias)
        dbias = None
        if ctx.needs_input_grad[5]:
            dq, dbias = flash_bwd_dq(q, k, v, do, lse, delta, grad_bias=True,
                                     **kw)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, dbias, None


def flash_attention(q, k, v, *, mask: Optional[torch.Tensor] = None,
                    alibi_slopes: Optional[torch.Tensor] = None,
                    causal: bool = True, block: int = 512,
                    bias: Optional[torch.Tensor] = None,
                    bias_is_constant: bool = False):
    """Fused attention, differentiable. q: (B, S, H, hd); k/v: (B, S, KV,
    hd); returns (B, S, H, hd). ``mask`` is a (B, S) key-padding mask and
    ``alibi_slopes`` (H,) per-head slopes whose ramp the kernels build
    themselves. ``block`` is the TPU tile size, kept for the signature:
    the CUDA kernels pick their own tiles and take any S. GQA's dk/dv come
    out summed per group inside the dk/dv kernel.

    ``bias`` is an additive score bias, (S, S), (H, S, S) or (B|1, H|1, S,
    S), in fp32, bf16 or fp16 whatever q's dtype; the kernels read it in
    place. Its gradient follows the JAX function's by shape (:913-926):
    a full (B, H, S, S) bias gets dbias from the dq kernel; a broadcast
    one gets none with ``bias_is_constant=True`` and the summed cotangent
    otherwise. ``bias`` and ``alibi_slopes`` exclude each other, as in
    JAX."""
    del block
    if bias is not None and alibi_slopes is not None:
        raise ValueError("pass either bias or alibi_slopes, not both")
    if q.device.type == "cuda":
        q, k, v = (t.contiguous() for t in (q, k, v))
    if bias is not None:
        bias = bias_operand(bias, q, bias_is_constant)
    return _Flash.apply(q, k, v, mask, alibi_slopes, bias, causal)


def bias_operand(bias, q, bias_is_constant: bool):
    """The bias as :func:`flash_attention` hands it to the kernels: a
    (B|1, H|1, S, S) view, contiguous in its last two dims on the card;
    a broadcast one detached when constant, else expanded to (B, H, S, S)
    at stride 0, so that the dq kernel writes a full dbias."""
    B, S, H = q.shape[:3]
    bias = bias4(bias, B, H, S)
    if q.device.type == "cuda" and S > 1 \
            and (bias.stride(3) != 1 or bias.stride(2) != S):
        bias = bias.contiguous()          # at its own shape, not (B, H)
    if tuple(bias.shape[:2]) == (B, H):
        return bias
    if bias_is_constant:
        # JAX's stop_gradient (:917): the kernels read the broadcast at
        # stride 0 and no gradient flows back to it
        return bias.detach()
    # JAX materializes the broadcast here (jnp.broadcast_to :921) so that
    # its transpose sums dbias. The port does not: a stride-0 expanded view
    # goes to the kernels, which read it in place, the dq kernel writes a
    # full dbias, and autograd of expand sums it to the bias's shape.
    return bias.expand(B, H, S, S)


def make_flash_attention(block: int = 512, bias_is_constant: bool = True,
                         causal: bool = True):
    """``attention_fn`` factory for :class:`TransformerLM`, with the JAX
    factory's capability flags (``ops/flash_attention.py:935-957``).
    ``causal=False`` builds the bidirectional function an encoder
    (``TransformerConfig.causal=False``) needs; the model refuses a causal
    one there. ``bias_is_constant=True`` (the model path's default)
    gives a broadcast bias no gradient; a caller training through a
    broadcast bias builds the function with ``bias_is_constant=False``."""

    def attn(q, k, v, *, mask=None, bias=None, alibi_slopes=None):
        return flash_attention(q, k, v, mask=mask, bias=bias,
                               alibi_slopes=alibi_slopes, causal=causal,
                               block=block, bias_is_constant=bias_is_constant)

    # the model prefers slopes for ALiBi (models/transformer.py:422): the
    # kernels build the ramp themselves and no (H, S, S) bias is formed
    attn.accepts_bias = True
    attn.bias_is_constant = bias_is_constant
    attn.accepts_alibi_slopes = True
    attn.causal = causal
    return attn
