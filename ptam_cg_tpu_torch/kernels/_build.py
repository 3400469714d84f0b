"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The sources expose a plain C interface, so they compile with ``nvcc``
alone (no PyTorch headers) in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so \
         csrc/<name>.cu

(``-Xptxas -v`` only reports registers and shared memory per kernel.)
A build may add ``-D`` defines (a kernel's tile shape, for a variant
sweep); they go into the library's name and hash.

The library is named after a hash of the source, the flags and the
defines, so an edit rebuilds it; it is written to a temporary name and
renamed, so processes building at once never load a half-written file.
``nvcc`` is looked up under ``$CUDA_HOME`` (default ``/usr/local/cuda``)
and then on ``PATH``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: (name, defines) -> (loaded library, seconds spent building it in this
#: process, nvcc's output). Filled at first use of each build.
_LOADED: dict = {}

_DEFINE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*(=[A-Za-z0-9_.]+)?")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where the library for ``csrc/<name>.cu`` built with these ``-D``
    defines (``NAME`` or ``NAME=VALUE``) lives."""
    for d in defines:
        if not _DEFINE.fullmatch(d):
            raise ValueError(f"not a NAME or NAME=VALUE define: {d!r}")
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    tag = "".join(f"-{d}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest}.so"


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu`` with these ``-D``
    defines, building it first if no library for this exact source and
    these defines exists yet."""
    key = (name, defines)
    if key in _LOADED:
        return _LOADED[key][0]
    src = CSRC / f"{name}.cu"
    so = library_path(name, defines)
    seconds, log = 0.0, ""
    if not so.is_file():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(tmp), str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} {defines}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LOADED[key] = (lib, seconds, log)
    return lib


def load_all(builds) -> None:
    """Build and load several (name, defines) libraries at once, one nvcc
    process each."""
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for done in [pool.submit(load, *b) for b in builds]:
            done.result()


def build_info(name: str, defines: Tuple[str, ...] = ()):
    """(seconds spent building, nvcc output) for a loaded library; zero
    and empty when it was already built."""
    _, seconds, log = _LOADED[(name, defines)]
    return seconds, log


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a C entry point (a
    ``c_void_p`` argument). The raw handle, as Triton's launcher reads it:
    ``torch.cuda.current_stream`` builds a Stream object on every call,
    about 4.5 us of host time a launch on the host of an H100 80GB HBM3
    (chip_smoke.py phase 2b)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_COUNT_LOCK = threading.Lock()
_LOCAL = threading.local()


def count_launch(module, stream: int) -> None:
    """Add one launch on ``stream`` (a raw handle, 0 for the legacy default
    stream) to a wrapper module's ``launches`` and ``launches_by_stream``;
    inside ``tally()`` on this thread, add it to the tally instead."""
    tally_ = getattr(_LOCAL, "tally", None)
    if tally_ is not None:
        tally_[module] = tally_.get(module, 0) + 1
        return
    count_launches(module, stream, 1)


def count_launches(module, stream: int, n: int) -> None:
    """Add ``n`` launches on ``stream`` to a wrapper module's counts. Under
    a lock: the engine's tracking thread and its mapping worker launch the
    same kernels at once, and ``+=`` on a module global is a
    read-modify-write."""
    with _COUNT_LOCK:
        module.launches += n
        module.launches_by_stream[stream] = (
            module.launches_by_stream.get(stream, 0) + n)


def tally_key(key) -> None:
    """Add one to ``key`` in this thread's open ``tally()``, if any (a
    capture records the calls a replay stands for so)."""
    tally_ = getattr(_LOCAL, "tally", None)
    if tally_ is not None:
        tally_[key] = tally_.get(key, 0) + 1


@contextlib.contextmanager
def tally():
    """Collect this thread's launches as {wrapper module: count} instead of
    counting them: a CUDA graph's capture records its kernels this way,
    and each replay adds them (``models/programs.py``)."""
    outer = getattr(_LOCAL, "tally", None)
    _LOCAL.tally = launched = {}
    try:
        yield launched
    finally:
        _LOCAL.tally = outer
