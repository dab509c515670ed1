"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``ops/csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, ``build/lib<name>-<hash>.so`` at the repository root
(``build/`` is git-ignored). The hash covers the source, every ``.cuh``
beside it and the flags, so an edited kernel rebuilds at its first use and
an unchanged one loads from disk. Sources build in parallel, one nvcc
process each. A missing nvcc or a failed build raises with the compiler's
output. ``torch.utils.cpp_extension`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.
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


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[list[str]] = None) -> dict[str, dict]:
    """Build the named sources (default: all) that are not built yet, one
    nvcc each, all started together. Returns ``{name: {"path", "seconds",
    "log"}}``; ``log`` holds nvcc's output (``-Xptxas -v``: registers,
    shared memory and spills of each kernel), also kept beside the library
    as ``.log``. Raises :class:`KernelBuildError` on any failure."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            os.unlink(tmp)
            continue
        out.with_suffix(".log").write_text(f"{seconds:.2f}\n{log}")
        os.replace(tmp, out)      # atomic: concurrent builders never see half
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    result = {}
    for name in names:
        out = library_path(name)
        secs, _, log = out.with_suffix(".log").read_text().partition("\n")
        result[name] = {"path": str(out), "seconds": float(secs), "log": log}
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
