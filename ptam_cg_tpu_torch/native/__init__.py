"""Native host runtime: the C++ frame pump and its ctypes binding (port of
``ptam_cg_tpu.native``; ``framepump.cpp`` is the JAX package's source,
byte for byte).

The library is built with ``g++`` at first use into
``ptam_cg_tpu_torch/_build/``, named after a hash of the source and the
flags, through a temporary name and a rename, so processes building at
once never load a half-written file. A failed build raises: a caller who
asked for the native pump does not get the Python reader
(``io.tum.TumDataset``) instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "framepump.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libframepump-{digest}.so"


def load_library() -> ctypes.CDLL:
    """Build (once) and load the native library; raises if ``g++`` fails
    or the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.is_file():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.fp_count.restype = ctypes.c_int
        lib.fp_count.argtypes = [ctypes.c_void_p]
        lib.fp_next.restype = ctypes.c_int
        lib.fp_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double)]
        lib.fp_close.restype = None
        lib.fp_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeFramePump:
    """A prefetching dataset reader (a native worker thread decodes
    ``.npy`` and ``.pgm`` frames into a ring buffer), with
    ``io.tum.TumDataset``'s ``next_frame`` and ``len``."""

    def __init__(self, root: str, prefetch: int = 4, loop: bool = True,
                 max_pixels: int = 1920 * 1080):
        self._lib = load_library()
        self._handle = self._lib.fp_open(str(root).encode(), prefetch,
                                         1 if loop else 0)
        if not self._handle:
            raise FileNotFoundError(f"no rgb.txt index under {root}")
        self._buf = np.empty(max_pixels, np.float32)

    def __len__(self) -> int:
        return self._lib.fp_count(self._handle)

    def next_frame(self) -> Tuple[float, np.ndarray]:
        h, w, ts = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
        rc = self._lib.fp_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.size, ctypes.byref(h), ctypes.byref(w),
            ctypes.byref(ts))
        if rc == -1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"framepump decode error rc={rc}")
        return ts.value, self._buf[: h.value * w.value].reshape(
            h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.fp_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # nothing can be raised from a finalizer
            pass
