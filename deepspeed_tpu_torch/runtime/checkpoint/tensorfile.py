"""The port's tensor file: the safetensors layout, with no dependency.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
header, then the tensors' raw little-endian bytes, back to back with no
gap. The header maps each name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the data region) and may hold a
``"__metadata__"`` dict of strings; it is padded with spaces so that the
data starts 8-byte aligned. The ``safetensors`` package reads these files
and this module reads its files; the card's machine has no such package.

bf16 is written and read from its bits, since numpy has no bf16. Every
leaf is stored whole under its name, so a file does not depend on how
many ranks held the tensor.

Writes go through :func:`write_file`: header and payload by ``os.pwrite``
(from several threads at once if asked), then ``fsync`` before returning,
so a manifest written after it covers bytes that are on the disk.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
          torch.int32: "I32", torch.int64: "I64", torch.uint8: "U8"}
TORCH_DTYPES = {v: k for k, v in DTYPES.items()}
_CHUNK = 1 << 28          # bytes a read or write system call moves at most

if sys.byteorder != "little":   # pragma: no cover - every supported host
    raise ImportError("tensorfile: the layout is little-endian and so must "
                      "the host be")


class Entry:
    """One tensor of a file: dtype, shape and byte range in the data."""

    __slots__ = ("dtype", "shape", "begin", "end")

    def __init__(self, dtype: torch.dtype, shape: tuple, begin: int,
                 end: int):
        self.dtype, self.shape, self.begin, self.end = dtype, shape, begin, end


class Layout:
    """Where each tensor of a file lies: ``entries`` by name, the header's
    bytes and the data's size. Built from ``(dtype, shape)`` specs by
    :meth:`of` (widest element first, then by name, as the safetensors
    writer orders them, so every tensor starts aligned to its element), or
    parsed from a file by :func:`read_layout`."""

    def __init__(self, entries: dict, header: bytes, data_bytes: int,
                 metadata: Optional[dict] = None):
        self.entries = entries
        self.header = header
        self.data_bytes = data_bytes
        self.metadata = metadata or {}

    @property
    def file_bytes(self) -> int:
        return len(self.header) + self.data_bytes

    @classmethod
    def of(cls, specs: Mapping[str, tuple],
           metadata: Optional[dict] = None) -> "Layout":
        """``specs``: name → ``(torch dtype, shape)``."""
        for name, (dtype, _) in specs.items():
            if dtype not in DTYPES:
                raise ValueError(f"tensorfile: {name} has dtype {dtype}; the "
                                 f"format holds {sorted(DTYPES.values())}")
        entries, head, off = {}, {}, 0
        for name in sorted(specs, key=lambda k: (-specs[k][0].itemsize, k)):
            dtype, shape = specs[name]
            shape = tuple(int(s) for s in shape)
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            entries[name] = Entry(dtype, shape, off, off + n)
            head[name] = {"dtype": DTYPES[dtype], "shape": list(shape),
                          "data_offsets": [off, off + n]}
            off += n
        if metadata:
            head["__metadata__"] = {str(k): str(v)
                                    for k, v in metadata.items()}
        text = json.dumps(head, separators=(",", ":")).encode()
        text += b" " * (-(8 + len(text)) % 8)
        header = struct.pack("<Q", len(text)) + text
        return cls(entries, header, off, metadata)

    def views(self, data: torch.Tensor) -> dict:
        """Each entry as a tensor view into ``data``, a uint8 tensor of
        ``data_bytes`` (on any device)."""
        return {name: data[e.begin:e.end].view(e.dtype).view(e.shape)
                for name, e in self.entries.items()}


def read_layout(path: Path | str) -> Layout:
    """Parse a file's header (either writer's)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"tensorfile: {path} is shorter than its header "
                             "length")
        (n,) = struct.unpack("<Q", raw)
        text = f.read(n)
    if len(text) != n:
        raise ValueError(f"tensorfile: {path} is truncated in its header")
    head = json.loads(text)
    metadata = head.pop("__metadata__", None)
    entries, end = {}, 0
    for name, h in head.items():
        if h["dtype"] not in TORCH_DTYPES:
            raise ValueError(f"tensorfile: {path}: {name} has dtype "
                             f"{h['dtype']}, not one of "
                             f"{sorted(TORCH_DTYPES)}")
        b, e = (int(x) for x in h["data_offsets"])
        entries[name] = Entry(TORCH_DTYPES[h["dtype"]],
                              tuple(int(s) for s in h["shape"]), b, e)
        end = max(end, e)
    size = os.path.getsize(path)
    if size != 8 + n + end:
        raise ValueError(f"tensorfile: {path} holds {size} bytes, its header "
                         f"names {8 + n + end}")
    return Layout(entries, struct.pack("<Q", n) + text, end, metadata)


def _as_bytes(data: torch.Tensor) -> memoryview:
    """A CPU uint8 tensor's bytes, without a copy."""
    return memoryview(data.numpy()).cast("B")


def write_file(path: Path | str, layout: Layout, data: torch.Tensor,
               threads: int = 1) -> int:
    """Write ``layout``'s header then ``data`` (a contiguous CPU uint8 tensor
    of ``layout.data_bytes``) to ``path``, ``fsync`` it, and return the
    bytes written. ``threads`` > 1 writes that many contiguous ranges of
    the data at once (``os.pwrite``; the calls release the GIL). Any error
    propagates."""
    if data.numel() != layout.data_bytes:
        raise ValueError(f"tensorfile: {path}: {data.numel()} data bytes for "
                         f"a layout of {layout.data_bytes}")
    head = len(layout.header)
    payload = _as_bytes(data)
    step = -(-len(payload) // max(1, threads))

    def put(buf: memoryview, at: int) -> None:
        off = 0
        while off < len(buf):
            off += os.pwrite(fd, buf[off:off + _CHUNK], at + off)

    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        put(memoryview(layout.header), 0)
        ranges = [(payload[i:i + step], head + i)
                  for i in range(0, len(payload), step)] if step else []
        if len(ranges) > 1:
            with ThreadPoolExecutor(max_workers=len(ranges)) as ex:
                for f in [ex.submit(put, *r) for r in ranges]:
                    f.result()
        elif ranges:
            put(*ranges[0])
        os.fsync(fd)
    finally:
        os.close(fd)
    return layout.file_bytes


def read_data(path: Path | str, layout: Layout, data: torch.Tensor) -> None:
    """Read ``path``'s data region into ``data`` (a contiguous CPU uint8
    tensor of at least ``layout.data_bytes``)."""
    out = _as_bytes(data)
    with open(path, "rb", buffering=0) as f:
        f.seek(len(layout.header))
        off = 0
        while off < layout.data_bytes:
            k = f.readinto(out[off:min(off + _CHUNK, layout.data_bytes)])
            if not k:
                raise ValueError(f"tensorfile: {path} ended after {off} of "
                                 f"{layout.data_bytes} data bytes")
            off += k


def read_entry(path: Path | str, layout: Layout, name: str) -> torch.Tensor:
    """One tensor of ``path`` (its byte range only), as a CPU tensor."""
    e = layout.entries[name]
    data = torch.empty(e.end - e.begin, dtype=torch.uint8)
    out = _as_bytes(data)
    with open(path, "rb", buffering=0) as f:
        f.seek(len(layout.header) + e.begin)
        off = 0
        while off < len(out):
            k = f.readinto(out[off:off + _CHUNK])
            if not k:
                raise ValueError(f"tensorfile: {path} ended inside {name}")
            off += k
    return data.view(e.dtype).view(e.shape)


def save_tensors(path: Path | str, tensors: Mapping[str, torch.Tensor],
                 metadata: Optional[dict] = None) -> int:
    """Write a dict of tensors (any device) to one file; returns its bytes."""
    layout = Layout.of({k: (v.dtype, tuple(v.shape))
                        for k, v in tensors.items()}, metadata)
    data = torch.empty(layout.data_bytes, dtype=torch.uint8)
    for name, view in layout.views(data).items():
        view.copy_(tensors[name])
    return write_file(path, layout, data)


def load_tensors(path: Path | str) -> dict:
    """Every tensor of a file, as CPU tensors (views of one buffer)."""
    layout = read_layout(path)
    data = torch.empty(layout.data_bytes, dtype=torch.uint8)
    read_data(path, layout, data)
    return layout.views(data)
