"""Decode attention: one query token against the KV cache.

Counterpart of ``deepspeed_tpu/ops/decode_attention.py``, whose Pallas
kernel ``_decode_kernel`` streams the cache through VMEM with an online
softmax. Here the kernel is CUDA C++ for Hopper, ``csrc/
decode_attention.cu`` (its header says what bounds it and how it is laid
out), built by ``ops/builder.py`` and called through ctypes.

:func:`decode_attention` takes the kernel for CUDA tensors and the plain
version beside it, :func:`decode_attention_plain`, for CPU tensors only:
on a CUDA tensor it launches the kernel or raises, never falls back.
``decode_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import builder

BIG_NEG = -2.0 ** 30
BLOCK = 128              # positions per online-softmax step of the plain version
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _lengths(length, B: int, device) -> torch.Tensor:
    """int32 lengths: 0-d (one length for every row) or (B,)."""
    t = torch.as_tensor(length, dtype=torch.int32, device=device)
    if t.ndim > 1 or (t.ndim == 1 and t.shape[0] != B):
        raise ValueError(f"length must be a scalar or ({B},), got "
                         f"shape {tuple(t.shape)}")
    return t


def decode_attention_plain(q, ck, cv, length, *, alibi_slopes=None):
    """The kernel's function in plain tensor ops: an fp32 online softmax
    over 128-position blocks of the cache, positions ``>= length`` masked
    with BIG_NEG and given zero weight, GQA by head index ``h // (H/KV)``,
    ALiBi as ``slope·(s − (L−1))``; a row with no live position outputs 0.

    q: (B, 1, H, hd); ck/cv: (B, KV, max_len, hd); ``length`` scalar or
    (B,); ``alibi_slopes`` (H,) fp32. Returns (B, 1, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    if T != 1:
        raise ValueError("decode attention takes one query token")
    KV, S = ck.shape[1], ck.shape[2]
    G = H // KV
    L = _lengths(length, B, q.device).reshape(-1, 1, 1, 1).float()  # (B|1,..)
    qf = q[:, 0].float().reshape(B, KV, G, hd) * (1.0 / math.sqrt(hd))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(1, KV, G, 1)
    m = torch.full((B, KV, G, 1), BIG_NEG, device=q.device)
    den = torch.zeros((B, KV, G, 1), device=q.device)
    acc = torch.zeros((B, KV, G, hd), device=q.device)
    for j in range(0, S, BLOCK):
        k = ck[:, :, j:j + BLOCK].float()
        v = cv[:, :, j:j + BLOCK].float()
        s = torch.einsum("bkgd,bksd->bkgs", qf, k)
        col = torch.arange(j, j + k.shape[2], device=q.device).float()
        if slopes is not None:
            s = s + slopes * (col - (L - 1))
        keep = col < L
        s = torch.where(keep, s, BIG_NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgs,bksd->bkgd", p, v)
        m = m_new
    out = acc / den.clamp_min(1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _kernel():
    lib = builder.load("decode_attention")
    fn = lib.dstpu_decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        # pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit C int and cuts the pointer
        fn.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return fn


def decode_attention(q, ck, cv, length, *, alibi_slopes=None):
    """q: (B, 1, H, hd) current-token queries; ck/cv: (B, KV, max_len, hd)
    one layer's cache; ``length`` scalar or (B,) live lengths (slots <
    length attended); ``alibi_slopes`` optional (H,) per-head slopes.
    Returns (B, 1, H, hd).

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch
    the CUDA kernel, which needs q/ck/cv contiguous, of one dtype (fp32,
    fp16 or bf16), on the current device, with hd <= 256 and a multiple
    of 8 — anything else raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, length,
                                      alibi_slopes=alibi_slopes)
    B, T, H, hd = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if T != 1:
        raise ValueError("decode attention takes one query token")
    if any(t.device != q.device for t in (ck, cv)):
        raise ValueError("decode_attention: q, ck and cv must share a device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {q.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if q.dtype not in _DTYPE_CODE or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise ValueError(f"decode_attention: q/ck/cv dtypes {q.dtype}, "
                         f"{ck.dtype}, {cv.dtype}; one of fp32/fp16/bf16")
    if ck.shape != (B, KV, S, hd) or cv.shape != ck.shape or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(ck.shape)} / {tuple(cv.shape)}")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"decode_attention: head dim {hd} must be a "
                         f"multiple of 8 and <= {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    lengths = _lengths(length, B, q.device).contiguous()
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
        if slopes.shape != (H,):
            raise ValueError(f"alibi_slopes must be ({H},)")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                    lengths.data_ptr(), int(lengths.ndim == 1),
                    slopes.data_ptr() if slopes is not None else None,
                    out.data_ptr(), B, H, KV, S, hd, _DTYPE_CODE[q.dtype],
                    1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
