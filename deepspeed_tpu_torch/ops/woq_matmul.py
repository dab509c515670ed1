"""Weight-only-quantized GEMMs: int8 or int4 weights dequantized inside
the product.

Counterpart of ``deepspeed_tpu/ops/woq_matmul.py``, whose Pallas kernels
``_matmul_kernel`` (``x @ W``, W stored ``(K, N)``) and
``_matmul_t_kernel`` (``x @ W.T``, the tied head's ``(V, K)`` table)
stream the quantized tiles through VMEM. Here both are CUDA C++ for
Hopper, ``csrc/woq_matmul.cu`` (its header gives the bound and the
design), built by ``ops/builder.py`` and called through ctypes.
``x @ W.T`` has two kernels, chosen by the fixed :func:`woq_t_route`:
the tensor-core one (bulk-copied W, dequantized into ``mma.sync``
operands) for 16-bit x, and the CUDA-core one for the rest.

Layout (``inference/quantization.py``): ``group_size`` consecutive rows of
the weight's second-to-last dim share one fp32 scale row, so ``scale`` is
``(G, N)`` for a ``(K, N)`` weight. int4 packs two signed nibbles per byte
along adjacent rows: row ``2r`` in the low nibble, ``2r + 1`` in the high.

:func:`woq_matmul` and :func:`woq_matmul_t` take the plain versions
(:func:`woq_matmul_plain`, :func:`woq_matmul_t_plain`) for CPU tensors
only; on a CUDA tensor they launch the kernel or raise. ``.launches``
counts each wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import builder

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
WARPS = 8                  # warps per block of the x @ W kernel


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., R/2, C) packed bytes → (..., R, C) signed int4 values in
    int8: the low nibble sign-extended by ``(p << 4) >> 4`` (int8 shifts
    wrap), the high nibble by an arithmetic ``p >> 4``; rows interleave
    back as (low, high) pairs."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                       packed.shape[-1])


def _check_layout(q, scale, rows: int, cols: int, group_size: int,
                  bits: int, name: str) -> int:
    """The number of groups G, after checking that ``q`` / ``scale`` are a
    quantized ``(rows, cols)`` weight grouped along ``rows``."""
    if bits not in (4, 8):
        raise ValueError(f"{name}: bits must be 4 or 8, got {bits}")
    if group_size <= 0 or rows % group_size:
        raise ValueError(f"{name}: group_size {group_size} does not divide "
                         f"the grouped dim {rows}")
    if bits == 4 and group_size % 2:
        raise ValueError(f"{name}: int4 needs an even group, got {group_size}")
    G = rows // group_size
    want_q = (rows // 2, cols) if bits == 4 else (rows, cols)
    if q.dtype != torch.int8 or tuple(q.shape) != want_q:
        raise ValueError(f"{name}: q must be int8 {want_q}, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (G, cols):
        raise ValueError(f"{name}: scale must be float32 {(G, cols)}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    return G


def _int_values(q, bits: int) -> torch.Tensor:
    return unpack_int4(q) if bits == 4 else q


# --------------------------------------------------------- x @ W  (K, N)
def woq_matmul_plain(x, q, scale, *, group_size: int, bits: int = 8,
                     out_dtype=None):
    """The kernel's function in plain tensor ops, in the TPU kernel's order:
    for each group g an fp32 partial ``x[:, g] @ q[g]`` (the weight as its
    integer values), then ``acc += partial * scale[g]`` in fp32. x: (M, K)
    fp32/bf16/fp16; q: (K, N) int8, or (K/2, N) packed int4; scale:
    (G, N) fp32. Returns (M, N) in ``out_dtype`` (default x's)."""
    M, K = x.shape
    N = scale.shape[-1]
    G = _check_layout(q, scale, K, N, group_size, bits, "woq_matmul")
    qg = _int_values(q, bits).reshape(G, group_size, N).float()
    xg = x.float().reshape(M, G, group_size).transpose(0, 1)     # (G, M, gs)
    part = torch.bmm(xg, qg)                                      # (G, M, N)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc += part[g] * scale[g]
    return acc.to(out_dtype or x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers and the stream as c_void_p: without argtypes ctypes passes a
# Python int as a 32-bit C int and cuts the pointer
_ARGTYPES = {"dstpu_woq_matmul": [_P] * 5 + [_I] * 8 + [_P],
             "dstpu_woq_matmul_t": [_P] * 4 + [_I] * 7 + [_P],
             "dstpu_woq_matmul_t_mma": [_P] * 4 + [_I] * 7 + [_P]}
_loaded: dict = {}


def _kernel(name: str):
    """The C entry point, loaded (and built) at its first call. A decode
    step calls the wrappers ~160 times, so they keep their host work
    small: the function is looked up once, the stream read raw."""
    fn = _loaded.get(name)
    if fn is None:
        fn = getattr(builder.load("woq_matmul"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _loaded[name] = fn
    return fn


def _stream(x) -> int:
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _check_cuda(name: str, x, *tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: x, q and scale must share a device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x is on {x.device}, the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x dtype {x.dtype}; one of fp32/fp16/bf16")
    for label, t in (("x", x),) + tuple(zip(("q", "scale"), tensors)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             "16-byte aligned")


def _out_dtype(name: str, x, out_dtype):
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"{name}: out_dtype must be x's dtype or float32, "
                         f"got {out_dtype}")
    return out_dtype


def woq_splits(G: int) -> int:
    """Blocks that share one column tile's groups (split-K): each block
    gives its 8 warps one group each, so a tile's G groups spread over
    ceil(G / 8) blocks whose fp32 partials a second pass sums in order."""
    return -(-G // WARPS)


def woq_matmul(x, q, scale, *, group_size: int, bits: int = 8,
               out_dtype=None):
    """``x @ W`` with W stored quantized ``(K, N)``. x: (M, K); q: (K, N)
    int8 or (K/2, N) packed int4; scale: (G, N) fp32, G = K / group_size.
    Returns (M, N) in ``out_dtype`` (x's dtype or fp32) with fp32
    accumulation.

    CPU tensors take :func:`woq_matmul_plain`; CUDA tensors launch the
    kernel, which needs x/q/scale contiguous, on the current device, x in
    fp32/fp16/bf16 — anything else raises."""
    if x.device.type == "cpu":
        return woq_matmul_plain(x, q, scale, group_size=group_size,
                                bits=bits, out_dtype=out_dtype)
    if x.ndim != 2:
        raise ValueError(f"woq_matmul: x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = scale.shape[-1]
    G = _check_layout(q, scale, K, N, group_size, bits, "woq_matmul")
    _check_cuda("woq_matmul", x, q, scale)
    out_dtype = _out_dtype("woq_matmul", x, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = woq_splits(G)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = _kernel("dstpu_woq_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, K, N, group_size, bits,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], splits, _stream(x))
    if err != 0:
        raise RuntimeError(f"woq_matmul kernel launch failed: CUDA error {err}")
    woq_matmul.launches += 1
    return out


woq_matmul.launches = 0


# ------------------------------------------------------ x @ W.T  (V, K)
def woq_matmul_t_plain(x, q, scale, *, group_size: int, bits: int = 8,
                       out_dtype=None):
    """The kernel's function in plain tensor ops, in the TPU kernel's order:
    the table dequantized in fp32 (``q * scale[g(v)]``), ROUNDED to x's
    dtype, then contracted with x in fp32. x: (M, K); q: (V, K) int8 or
    (V/2, K) packed int4; scale: (G, K) fp32 grouped along V. Returns
    (M, V) in ``out_dtype`` (default x's)."""
    K = x.shape[-1]
    V = q.shape[0] * (2 if bits == 4 else 1)
    G = _check_layout(q, scale, V, K, group_size, bits, "woq_matmul_t")
    w = _int_values(q, bits).float().reshape(G, group_size, K) * scale[:, None]
    w = w.reshape(V, K).to(x.dtype).float()
    return (x.float() @ w.T).to(out_dtype or x.dtype)


MMA_MAX_K = 8192     # x's 8 rows in shared memory beside the ring
MMA_TILE_ROWS = 16   # rows of W a tile of the tensor-core kernel holds


def woq_t_route(x_dtype, K: int, V: int, group_size: int) -> str:
    """The kernel that serves ``woq_matmul_t`` for x's dtype and the
    table's shape: ``"mma"``, the tensor-core kernel
    (``dstpu_woq_matmul_t_mma``), for fp16 / bf16 x whose rows are whole
    16-byte pieces of the bulk copies (``K % 16 == 0``, K up to
    MMA_MAX_K), whose 16-row tiles each lie in one scale group (one group,
    or ``group_size % 16 == 0``); ``"simt"``, the CUDA-core kernel
    (``dstpu_woq_matmul_t``), for the rest: fp32 x, a ragged K, a K whose x
    rows do not fit beside the ring. Of the presets' decode heads (16-bit,
    d_model a multiple of 16) only Bloom-176B's (d_model 14336) takes the
    second. Fixed: a route never depends on a failure."""
    if x_dtype not in (torch.float16, torch.bfloat16) or K % 16 \
            or K > MMA_MAX_K:
        return "simt"
    if V // group_size > 1 and group_size % MMA_TILE_ROWS:
        return "simt"
    return "mma"


def woq_matmul_t(x, q, scale, *, group_size: int, bits: int = 8,
                 out_dtype=None):
    """``x @ W.T`` with W stored quantized ``(V, K)`` — the tied embedding
    table read as the unembedding, never transposed in memory. x: (M, K);
    q: (V, K) int8 or (V/2, K) packed int4; scale: (G, K) fp32 with
    G = V / group_size (G = 1 for a vocab the group does not divide).
    Returns (M, V) in ``out_dtype`` (x's dtype or fp32).

    CPU tensors take :func:`woq_matmul_t_plain`; CUDA tensors launch the
    kernel :func:`woq_t_route` names, or raise, as :func:`woq_matmul`."""
    if x.device.type == "cpu":
        return woq_matmul_t_plain(x, q, scale, group_size=group_size,
                                  bits=bits, out_dtype=out_dtype)
    if x.ndim != 2:
        raise ValueError(f"woq_matmul_t: x must be (M, K), got "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    V = q.shape[0] * (2 if bits == 4 else 1)
    _check_layout(q, scale, V, K, group_size, bits, "woq_matmul_t")
    _check_cuda("woq_matmul_t", x, q, scale)
    out_dtype = _out_dtype("woq_matmul_t", x, out_dtype)
    out = torch.empty((M, V), dtype=out_dtype, device=x.device)
    entry = ("dstpu_woq_matmul_t_mma"
             if woq_t_route(x.dtype, K, V, group_size) == "mma"
             else "dstpu_woq_matmul_t")
    err = _kernel(entry)(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K,
        V, group_size, bits, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        _stream(x))
    if err != 0:
        raise RuntimeError(f"woq_matmul_t kernel launch failed: CUDA error "
                           f"{err}")
    woq_matmul_t.launches += 1
    return out


woq_matmul_t.launches = 0
