"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the repository root.  The library's file name holds
a hash of its source and flags, so an edited source rebuilds and an unchanged
one loads from the cache.  Nothing is built when a module is imported: the
wrappers call :func:`load` when they first launch a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

SOURCES = {
    "assign": _PKG / "kernels" / "assign" / "csrc" / "assign.cu",
    "segment_sum": _PKG / "kernels" / "segment_sum" / "csrc" / "segment_sum.cu",
}

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each took
    (0.0 for a cached library); raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v`` register and memory use) of the
    current build of ``name``, or an empty string when it came from the cache."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
