"""Build the port's CUDA kernels with nvcc, and its host C++ with g++, and
load them with ctypes.

Every ``ops/csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, ``build/lib<name>-<hash>.so`` at the repository root
(``build/`` is git-ignored). The hash covers the source, every ``.cuh``
beside it and the flags, so an edited kernel rebuilds at its first use and
an unchanged one loads from disk. Sources build in parallel, one nvcc
process each. A missing nvcc or a failed build raises with the compiler's
output. ``torch.utils.cpp_extension`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.

Every ``ops/csrc/<name>.cpp`` is host code (the async file I/O of the KV
tiers' disk rung, ``aio.cpp``) and builds the same way with ``g++`` and
``GXX_FLAGS``, hashed by its source and those flags. There is no
``-march=native``: a library cached on one host must not fault on
another. Host code has no fallback either: a missing g++ or a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, ``$PATH`` or ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(NVCC_DEFAULT)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of deepspeed_tpu_torch are "
        "compiled at first use and need the CUDA toolkit")


def find_gxx() -> str:
    """g++ from ``$PATH``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError(
            "g++ not found on $PATH: the host C++ of deepspeed_tpu_torch "
            "(ops/csrc/*.cpp) is compiled at first use and needs it")
    return gxx


def sources() -> list[str]:
    """The CUDA sources."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> list[str]:
    """The host C++ sources."""
    return sorted(p.stem for p in CSRC.glob("*.cpp"))


def _is_host(name: str) -> bool:
    return (CSRC / f"{name}.cpp").exists()


def library_path(name: str) -> Path:
    if _is_host(name):
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        deps = [CSRC / f"{name}.cpp"]
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        deps = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: str) -> list[str]:
    if _is_host(name):
        return [find_gxx(), *GXX_FLAGS, "-o", out, str(CSRC / f"{name}.cpp")]
    return [find_nvcc(), *NVCC_FLAGS, "-o", out, str(CSRC / f"{name}.cu")]


def build_all(names: Optional[list[str]] = None) -> dict[str, dict]:
    """Build the named sources (default: every CUDA source) that are not
    built yet, one compiler process each (nvcc for a ``.cu``, g++ for a
    ``.cpp``), all started together. Returns ``{name: {"path", "seconds",
    "command", "log"}}``; ``log`` holds the compiler's output (nvcc's
    ``-Xptxas -v``: registers, shared memory and spills of each kernel),
    kept beside the library as ``.log`` with the seconds and the command.
    Each library and its log are written under a temporary name and
    renamed into place, so concurrent builders never see half of one.
    Raises :class:`KernelBuildError` on any failure."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = _command(name, tmp)
        except KernelBuildError:
            os.unlink(tmp)
            raise
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, cmd, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {Path(cmd[-1]).name} ({Path(cmd[0]).name} "
                          f"exit {proc.returncode}) ---\n{log}")
            os.unlink(tmp)
            continue
        fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(f"{seconds:.2f}\n{' '.join(cmd).replace(tmp, str(out))}"
                    f"\n{log}")
        os.replace(tmp_log, out.with_suffix(".log"))
        os.replace(tmp, out)      # atomic: concurrent builders never see half
    if failed:
        raise KernelBuildError("the build failed:\n" + "\n".join(failed))
    result = {}
    for name in names:
        out = library_path(name)
        secs, _, rest = out.with_suffix(".log").read_text().partition("\n")
        cmd, _, log = rest.partition("\n")
        result[name] = {"path": str(out), "seconds": float(secs),
                        "command": cmd, "log": log}
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built first
    if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
