"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The sources expose a plain C interface, so they compile with ``nvcc``
alone (no PyTorch headers) in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so \
         csrc/<name>.cu

(``-Xptxas -v`` only reports registers and shared memory per kernel.)

The library is named after a hash of the source and the flags, so an edit
rebuilds it; it is written to a temporary name and renamed, so processes
building at once never load a half-written file. ``nvcc`` is looked up under
``$CUDA_HOME`` (default ``/usr/local/cuda``) and then on ``PATH``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (loaded library, seconds spent building it in this process,
#: nvcc's output). Filled at first use of each kernel.
_LOADED: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library for this exact source exists yet."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not so.is_file():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = (lib, seconds, log)
    return lib


def load_all(names) -> None:
    """Build and load several sources at once, one nvcc process each."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for done in [pool.submit(load, name) for name in names]:
            done.result()


def build_info(name: str):
    """(seconds spent building, nvcc output) for a loaded kernel; zero
    and empty when the library was already built."""
    _, seconds, log = _LOADED[name]
    return seconds, log


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
