"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the repository root.  The library's file name holds
a hash of every file in the source's ``csrc/`` directory (the ``.cu`` and the
headers it includes) and of the flags, so an edited source or header rebuilds
and an unchanged one loads from the cache.  Nothing is built when a module is imported: the
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

import torch

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

SOURCES = {
    "assign": _PKG / "kernels" / "assign" / "csrc" / "assign.cu",
    "fused": _PKG / "kernels" / "assign" / "csrc" / "fused.cu",
    "segment_sum": _PKG / "kernels" / "segment_sum" / "csrc" / "segment_sum.cu",
    "flash_attention": _PKG / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu",
}

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where ``name``'s library lives: its file name hashes every file of the
    source's ``csrc/`` directory (so an edited header rebuilds too) and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(p for p in SOURCES[name].parent.iterdir() if p.is_file()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``, as
    an int for a ``ctypes`` call; without building a ``torch.cuda.Stream``
    object where this PyTorch offers that."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
