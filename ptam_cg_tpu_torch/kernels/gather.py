"""K2: per-point window gather (``csrc/gather_windows.cu``).

``win[n] = atlas[oy_n : oy_n + D, ox_n : ox_n + D]`` with each origin
clamped to ``[0, Ha-D] x [0, Wa-D]``. Replaces the TPU kernels
``ptam_cg_tpu/ops/pallas_gather.py`` ``gather_windows_pallas`` and
``gather_windows_aligned`` (and the XLA row-take used in production
there). The kernel is bound by bytes and, at the tracking shapes, by its
launch (see the note in the source); one block per window walks the
window in row-major order for coalesced stores.

It copies float32 images and bool / uint8 masks (the FAST corner mask
is gathered as bytes). ``gather_windows`` runs the plain version for CPU
tensors and the kernel for CUDA tensors; both are exact copies.
"""

from __future__ import annotations

import ctypes

import torch

from ptam_cg_tpu_torch.kernels import _build

Tensor = torch.Tensor

#: Kernel launches made by ``gather_windows`` in this process.
launches = 0


def gather_windows_plain(atlas: Tensor, origin_yx: Tensor, D: int) -> Tensor:
    """Plain PyTorch gather: atlas (Ha, Wa), origin_yx (N, 2) (y, x)
    top-left corners -> (N, D, D) of the atlas dtype."""
    Ha, Wa = atlas.shape
    oy = torch.clamp(origin_yx[:, 0].long(), 0, Ha - D)
    ox = torch.clamp(origin_yx[:, 1].long(), 0, Wa - D)
    ii = torch.arange(D, device=atlas.device)
    rows = (oy[:, None] + ii)[:, :, None]
    cols = (ox[:, None] + ii)[:, None, :]
    return atlas[rows, cols]


def _entry(name: str):
    fn = getattr(_build.load("gather_windows"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_ENTRIES = {torch.float32: "gather_windows_f32",
            torch.uint8: "gather_windows_u8",
            torch.bool: "gather_windows_u8"}


def gather_windows(atlas: Tensor, origin_yx: Tensor, D: int) -> Tensor:
    """(N, D, D) windows of ``atlas`` at the clamped (y, x) origins."""
    if atlas.device.type == "cpu":
        return gather_windows_plain(atlas, origin_yx, D)
    if atlas.device.type != "cuda" or origin_yx.device != atlas.device:
        raise ValueError("gather_windows: atlas and origins must be on one "
                         f"CUDA device, got {atlas.device} and "
                         f"{origin_yx.device}")
    if atlas.dtype not in _ENTRIES or atlas.ndim != 2:
        raise ValueError("gather_windows: need a 2-D float32/uint8/bool "
                         f"atlas, got {tuple(atlas.shape)} {atlas.dtype}")
    Ha, Wa = atlas.shape
    N = origin_yx.shape[0]
    if origin_yx.shape != (N, 2) or not (0 < D <= min(Ha, Wa)):
        raise ValueError(f"gather_windows: bad origins {tuple(origin_yx.shape)}"
                         f" or window {D} for atlas {Ha}x{Wa}")
    atlas = atlas.contiguous()
    origins = origin_yx.to(torch.int32).contiguous()
    out = torch.empty((N, D, D), dtype=atlas.dtype, device=atlas.device)
    if N == 0:
        return out
    fn = _entry(_ENTRIES[atlas.dtype])
    global launches
    launches += 1
    _build.check(fn(atlas.data_ptr(), Ha, Wa, origins.data_ptr(), N, D,
                    out.data_ptr(), _build.stream_handle(atlas)),
                 "gather_windows")
    return out
