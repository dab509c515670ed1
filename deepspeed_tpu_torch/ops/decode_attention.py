"""Decode attention: one query token against the KV cache.

Counterpart of ``deepspeed_tpu/ops/decode_attention.py``, whose Pallas
kernel ``_decode_kernel`` streams the cache through VMEM with an online
softmax. Here the kernel is CUDA C++ for Hopper, ``csrc/
decode_attention.cu`` (its header says what bounds it and how it is laid
out): the cache splits over blocks (flash-decoding), each block streams
its range through shared memory with bulk copies, and the last block of
each (row, KV head) merges the splits' partials in split order. It is
built by ``ops/builder.py`` and called through ctypes.

:func:`decode_attention` takes the kernel for CUDA tensors and the plain
version beside it, :func:`decode_attention_plain`, for CPU tensors only:
on a CUDA tensor it launches the kernel or raises, never falls back.
:func:`split_plan` sizes the split on the host, from shapes alone.
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
WARPS = 8                # warps of a kernel block
# the split plan: about this many blocks an SM (each block's fixed cost,
# its copies' first latency and the partials' merge, is paid once: on the
# H100 one block an SM at Llama-2-7B's shape beat 2-10), ranges of at most
# this many tiles (so long and ragged rows spread over the card)
BLOCKS_PER_SM = 1
MAX_TILES_PER_SPLIT = 32
MAX_SPLITS = 256         # the merging block keeps each split's (m, l) in smem
GRID_YZ_MAX = 65535


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


def lane_elements(hd: int) -> int:
    """Elements of a cache row a lane holds in the kernel (EPL)."""
    return 2 if hd <= 64 else 4 if hd <= 128 else 8


def tile_rows(hd: int) -> int:
    """Cache positions in one shared-memory stage: 8 warps x 16 / EPL."""
    return WARPS * 16 // lane_elements(hd)


def heads_per_block(G: int, hd: int) -> int:
    """Query heads of one KV head a block takes (GB): the group size rounded
    up to a power of two, at most 8 and at most 32 / EPL."""
    cap = min(8, 32 // lane_elements(hd))
    gb = 1
    while gb < G and gb < cap:
        gb *= 2
    return gb


def split_plan(B: int, H: int, KV: int, S: int, hd: int, sms: int) -> dict:
    """How the kernel splits the cache, from shapes alone (the lengths stay
    on the card: reading them would sync every layer). Blocks own (row, KV
    head, chunk of ``gb`` query heads) x a range of ``chunk`` positions,
    ``nsplit`` ranges covering [0, S); the grid is ``(nsplit, KV * chunks,
    B)``. The range is a whole number of tiles: as long as the grid still
    has about BLOCKS_PER_SM blocks an SM, at most MAX_TILES_PER_SPLIT
    tiles (more only when MAX_SPLITS ranges need them). The kernel takes
    any chunk; these choices only set its speed. Raises if the grid
    exceeds CUDA's limits."""
    G = H // KV
    gb = heads_per_block(G, hd)
    nch = -(-G // gb)
    tile = tile_rows(hd)
    tiles = -(-S // tile)
    want = max(1, BLOCKS_PER_SM * sms // (B * KV * nch))
    per = max(min(-(-tiles // want), MAX_TILES_PER_SPLIT),
              -(-tiles // MAX_SPLITS))
    chunk = per * tile
    nsplit = -(-S // chunk)
    if B > GRID_YZ_MAX or KV * nch > GRID_YZ_MAX:
        raise ValueError(f"decode_attention: grid ({nsplit}, {KV * nch}, "
                         f"{B}) exceeds CUDA's 65535 in y or z")
    return {"gb": gb, "nch": nch, "tile": tile, "chunk": chunk,
            "nsplit": nsplit}


_plans: dict = {}
_sms: dict = {}
_workspace: dict = {}


def _plan(B, H, KV, S, hd, device) -> dict:
    key = (B, H, KV, S, hd, device.index)
    plan = _plans.get(key)
    if plan is None:
        sms = _sms.get(device.index)
        if sms is None:
            sms = _sms[device.index] = torch.cuda.get_device_properties(
                device).multi_processor_count
        plan = _plans[key] = split_plan(B, H, KV, S, hd, sms)
    return plan


def _scratch(device, floats: int, tickets: int):
    """The partials' fp32 workspace and the zeroed int32 tickets, cached
    per device and grown when a call needs more. Each call leaves the
    tickets zero; calls on one device run in stream order."""
    ws, tk = _workspace.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _workspace[device.index] = (ws, tk)
    return ws, tk


def _kernel():
    lib = builder.load("decode_attention")
    fn = lib.dstpu_decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        # pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit C int and cuts the pointer
        fn.argtypes = [P] * 4 + [I, P, P, P, P] + [I] * 9 + [ctypes.c_float,
                                                           P]
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
    plan = _plan(B, H, KV, S, hd, q.device)
    ws = tk = None
    if plan["nsplit"] > 1:
        ws, tk = _scratch(q.device, B * H * plan["nsplit"] * (hd + 2),
                          B * KV * plan["nch"])
    out = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = _kernel()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                    lengths.data_ptr(), int(lengths.ndim == 1),
                    slopes.data_ptr() if slopes is not None else None,
                    out.data_ptr(), ws.data_ptr() if ws is not None else None,
                    tk.data_ptr() if tk is not None else None, B, H, KV, S,
                    hd, _DTYPE_CODE[q.dtype], plan["gb"], plan["nsplit"],
                    plan["chunk"], 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
