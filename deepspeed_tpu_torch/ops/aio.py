"""Async file I/O over the native worker pool of ``csrc/aio.cpp``
(counterpart of ``deepspeed_tpu/ops/aio.py``).

``AsyncIOHandle`` submits reads and writes of numpy buffers to the
library's worker threads and waits on their tickets; ``AIOFileStore`` is
one directory of files behind a handle, the seam the KV tiers' disk rung
(``serving/tiering.py``) writes and reads through. The library is built
with g++ from the checkout at first use (``ops/builder.py``); there is no
Python I/O path: a missing g++ or a failed build raises
:class:`~.builder.KernelBuildError`.

Where the caller asks for ``O_DIRECT``, each descriptor records whether
the filesystem granted it at open, and the handle counts the descriptors
that lost it to an unaligned transfer (``o_direct()``). A pinned torch
buffer is page-aligned; a numpy buffer may not be, and its transfer then
runs buffered. The handle keeps every submitted buffer referenced until
its ticket is waited.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import builder

__all__ = ["AsyncIOHandle", "AIOFileStore", "native_available"]


def _lib() -> ctypes.CDLL:
    lib = builder.load("aio")
    if not getattr(lib, "_sigs_set", False):
        lib.ds_aio_create.restype = ctypes.c_void_p
        lib.ds_aio_create.argtypes = [ctypes.c_int, ctypes.c_int64]
        lib.ds_aio_destroy.argtypes = [ctypes.c_void_p]
        lib.ds_aio_open.restype = ctypes.c_int
        lib.ds_aio_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.ds_aio_is_direct.restype = ctypes.c_int
        lib.ds_aio_is_direct.argtypes = [ctypes.c_int]
        lib.ds_aio_close.argtypes = [ctypes.c_int]
        for f in (lib.ds_aio_submit_read, lib.ds_aio_submit_write):
            f.restype = ctypes.c_int64
            f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_int64]
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for f in (lib.ds_aio_errors, lib.ds_aio_direct_drops):
            f.restype = ctypes.c_int64
            f.argtypes = [ctypes.c_void_p]
        lib._sigs_set = True
    return lib


class AsyncIOHandle:
    """Submit / wait file reads and writes of numpy buffers on the native
    worker pool. ``wait(ticket)`` returns once every ticket up to it is
    done, and raises ``OSError`` if a transfer failed since the last
    wait."""

    def __init__(self, n_threads: int = 4, block_size: int = 1 << 20,
                 use_direct: bool = True):
        self.block_size = block_size
        self.use_direct = use_direct
        self._lib = _lib()
        self._h = ctypes.c_void_p(self._lib.ds_aio_create(n_threads,
                                                          block_size))
        self._fds: dict[str, int] = {}
        self._held: dict[int, np.ndarray] = {}   # ticket -> its buffer
        self._errors_seen = 0
        self.direct_granted = 0     # descriptors opened with O_DIRECT
        self.opened = 0

    # ------------------------------------------------------------------ fds
    def _fd(self, path: str, for_write: bool) -> int:
        key = f"{path}|{int(for_write)}"
        if key not in self._fds:
            fd = self._lib.ds_aio_open(path.encode(), int(for_write),
                                       int(self.use_direct))
            if fd < 0:
                raise OSError(f"aio open failed: {path}")
            self.opened += 1
            self.direct_granted += self._lib.ds_aio_is_direct(fd)
            self._fds[key] = fd
        return self._fds[key]

    # --------------------------------------------------------------- submit
    def _submit(self, fn, path: str, buf: np.ndarray, offset: int,
                for_write: bool) -> int:
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous")
        t = fn(self._h, self._fd(path, for_write),
               buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes, offset)
        self._held[t] = buf
        return t

    def submit_write(self, path: str, buf: np.ndarray, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_submit_write, path, buf, offset,
                            True)

    def submit_read(self, path: str, buf: np.ndarray, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_submit_read, path, buf, offset,
                            False)

    # ----------------------------------------------------------------- wait
    def wait(self, ticket: int) -> None:
        self._lib.ds_aio_wait(self._h, ticket)
        for t in [t for t in self._held if t <= ticket]:
            del self._held[t]
        errors = self._lib.ds_aio_errors(self._h)
        if errors > self._errors_seen:
            self._errors_seen = errors
            raise OSError("aio: a transfer failed")

    def sync_write(self, path: str, buf: np.ndarray, offset: int = 0) -> None:
        self.wait(self.submit_write(path, buf, offset))

    def sync_read(self, path: str, buf: np.ndarray, offset: int = 0) -> None:
        self.wait(self.submit_read(path, buf, offset))

    def o_direct(self) -> dict:
        """Whether O_DIRECT was asked for, on how many of the descriptors
        opened the filesystem granted it, and how many transfers then lost
        it to alignment (each drop makes its descriptor buffered)."""
        return {"requested": bool(self.use_direct), "opened": self.opened,
                "granted": self.direct_granted,
                "dropped": int(self._lib.ds_aio_direct_drops(self._h))
                if self._h else 0}

    def forget(self, path: str) -> None:
        """Close and drop the cached descriptors of ``path``: call it when
        the file is unlinked or replaced (the cache is keyed by path, so a
        stale descriptor would keep serving the deleted inode)."""
        for w in (0, 1):
            fd = self._fds.pop(f"{path}|{w}", None)
            if fd is not None:
                self._lib.ds_aio_close(fd)

    def close(self) -> None:
        if self._h:
            # the destructor joins the workers after the queue drains
            self._lib.ds_aio_destroy(self._h)
            self._h = None
        self._held.clear()
        for fd in self._fds.values():
            self._lib.ds_aio_close(fd)
        self._fds.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AIOFileStore:
    """One directory of files behind one :class:`AsyncIOHandle`: names to
    paths, descriptor hygiene (``unlink`` closes the cached descriptors
    before removing the file) and an ``errors`` count of failed submits
    and waits. Integrity checks stay with the caller."""

    def __init__(self, directory: str, n_threads: int = 4,
                 block_size: int = 1 << 20, use_direct: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.aio = AsyncIOHandle(n_threads=n_threads, block_size=block_size,
                                 use_direct=use_direct)
        self.errors = 0

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    # ---------------------------------------------------------- submit/wait
    def submit_write(self, name: str, buf: np.ndarray, offset: int = 0) -> int:
        try:
            return self.aio.submit_write(self.path(name), buf, offset)
        except OSError:
            self.errors += 1
            raise

    def submit_read(self, name: str, buf: np.ndarray, offset: int = 0) -> int:
        try:
            return self.aio.submit_read(self.path(name), buf, offset)
        except OSError:
            self.errors += 1
            raise

    def wait(self, ticket: int) -> None:
        try:
            self.aio.wait(ticket)
        except OSError:
            self.errors += 1
            raise

    def sync_write(self, name: str, buf: np.ndarray, offset: int = 0) -> None:
        self.wait(self.submit_write(name, buf, offset))

    def sync_read(self, name: str, buf: np.ndarray, offset: int = 0) -> None:
        self.wait(self.submit_read(name, buf, offset))

    # ------------------------------------------------------------ lifecycle
    def unlink(self, name: str) -> None:
        p = self.path(name)
        self.aio.forget(p)
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def close(self) -> None:
        self.aio.close()


def native_available() -> bool:
    """Whether the native library builds and loads here (a probe: no
    caller falls back when it does not)."""
    try:
        _lib()
    except builder.KernelBuildError:
        return False
    return True
