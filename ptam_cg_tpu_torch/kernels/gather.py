"""K2: per-point window gather (``csrc/gather_windows.cu``).

``win[n] = atlas[oy_n : oy_n + D, ox_n : ox_n + D]`` with each origin
clamped to ``[0, Ha-D] x [0, Wa-D]``. Replaces the TPU kernels
``ptam_cg_tpu/ops/pallas_gather.py`` ``gather_windows_pallas`` and
``gather_windows_aligned`` (and the XLA row-take used in production
there). The atlas sits in L2, so latency and the launch bound the kernel
(see the note in the source): each thread copies 4 consecutive elements
of the flat output with one vector store.

Origins come as two (N,) tensors ``oy`` and ``ox``, int32 or int64,
strided or not: the kernel reads them as they are, so a caller needs no
cast and no stack. ``gather_window_pair`` gathers an image window and a
corner-mask window of the same points in one launch. Both entries run
the plain version for CPU tensors and the kernel for CUDA tensors; both
are exact copies of float32 images and bool / uint8 masks. A bfloat16
atlas (``FrontendConfig.atlas_bf16``) gives float32 windows, as the JAX
package's ``gather_windows_rowtake`` does for one
(``preferred_element_type=f32``); bf16 -> float32 is exact.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ptam_cg_tpu_torch.kernels import _build

Tensor = torch.Tensor

#: Kernel launches made by ``gather_windows`` and ``gather_window_pair``
#: in this process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}


class _Launches:
    """A count of launches kept as a wrapper module keeps its own
    (``_build.count_launch`` takes either; a capture's tally keys it by
    identity)."""

    def __init__(self):
        self.launches = 0
        self.launches_by_stream: dict = {}


#: The launches among them that read a bfloat16 atlas.
bf16_source = _Launches()


def gather_windows_plain(atlas: Tensor, oy: Tensor, ox: Tensor, D: int,
                         offset: int = 0) -> Tensor:
    """Plain PyTorch gather: atlas (Ha, Wa); the (oy, ox) columns of the
    top-left corners, moved by ``offset`` and clamped -> (N, D, D) of the
    atlas dtype (float32 for a bfloat16 atlas)."""
    Ha, Wa = atlas.shape
    oy = torch.clamp(oy.long() + offset, 0, Ha - D)
    ox = torch.clamp(ox.long() + offset, 0, Wa - D)
    ii = torch.arange(D, device=atlas.device)
    rows = (oy[:, None] + ii)[:, :, None]
    cols = (ox[:, None] + ii)[:, None, :]
    win = atlas[rows, cols]
    return win.to(torch.float32) if win.dtype == torch.bfloat16 else win


def gather_window_pair_plain(atlas: Tensor, mask: Tensor, oy: Tensor,
                             ox: Tensor, D: int, offset: int, M: int):
    """Plain version of ``gather_window_pair``: two gathers."""
    return (gather_windows_plain(atlas, oy, ox, D),
            gather_windows_plain(mask, oy, ox, M, offset))


_SIGNATURES = {
    "gather_windows_f32": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p],
    "gather_window_pair": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p],
}
_SIGNATURES["gather_windows_u8"] = _SIGNATURES["gather_windows_f32"]
_SIGNATURES["gather_windows_bf16"] = _SIGNATURES["gather_windows_f32"]
_SIGNATURES["gather_window_pair_bf16"] = _SIGNATURES["gather_window_pair"]


def _entry(name: str):
    fn = getattr(_build.load("gather_windows"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


_ENTRIES = {torch.float32: "gather_windows_f32",
            torch.uint8: "gather_windows_u8",
            torch.bool: "gather_windows_u8",
            torch.bfloat16: "gather_windows_bf16"}
_PAIR_ENTRIES = {torch.float32: "gather_window_pair",
                 torch.bfloat16: "gather_window_pair_bf16"}


def _count(atlas: Tensor, stream: int) -> None:
    _build.count_launch(sys.modules[__name__], stream)
    if atlas.dtype == torch.bfloat16:
        _build.count_launch(bf16_source, stream)


def _check_atlas(atlas: Tensor, dtypes, what: str) -> None:
    if atlas.device.type != "cuda" or atlas.ndim != 2 or \
            atlas.dtype not in dtypes:
        raise ValueError(f"{what}: need a 2-D CUDA atlas of "
                         f"{tuple(dtypes)}, got "
                         f"{tuple(atlas.shape)} {atlas.dtype} on "
                         f"{atlas.device}")


def _origin_args(atlas: Tensor, oy: Tensor, ox: Tensor, sizes, what: str):
    """(oy pointer, ox pointer, oy stride, ox stride, int64?, N) for the
    C entries, after checking the origins and window sides."""
    N = oy.shape[0]
    if oy.ndim != 1 or ox.shape != (N,) or oy.dtype != ox.dtype or \
            oy.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: origins must be (N,) int32 or int64 "
                         f"columns, got {tuple(oy.shape)} {oy.dtype} and "
                         f"{tuple(ox.shape)} {ox.dtype}")
    if oy.device != atlas.device or ox.device != atlas.device:
        raise ValueError(f"{what}: atlas and origins must be on one CUDA "
                         f"device, got {atlas.device}, {oy.device} and "
                         f"{ox.device}")
    Ha, Wa = atlas.shape
    for D in sizes:
        if not 2 <= D <= min(Ha, Wa) or N * D * D >= 2 ** 31:
            raise ValueError(f"{what}: window {D} for {N} points does not "
                             f"fit the kernel or the atlas {Ha}x{Wa}")
    return (oy.data_ptr(), ox.data_ptr(), oy.stride(0), ox.stride(0),
            int(oy.dtype == torch.int64), N)


def gather_windows(atlas: Tensor, oy: Tensor, ox: Tensor, D: int) -> Tensor:
    """(N, D, D) windows of ``atlas`` at the clamped (oy, ox) origins, in
    the atlas dtype (float32 for a bfloat16 atlas)."""
    if atlas.device.type == "cpu":
        return gather_windows_plain(atlas, oy, ox, D)
    _check_atlas(atlas, _ENTRIES, "gather_windows")
    py, px, sy, sx, idx64, N = _origin_args(atlas, oy, ox, (D,),
                                            "gather_windows")
    atlas = atlas.contiguous()
    Ha, Wa = atlas.shape
    out = torch.empty((N, D, D), device=atlas.device, dtype=(
        torch.float32 if atlas.dtype == torch.bfloat16 else atlas.dtype))
    if N == 0:
        return out
    fn = _entry(_ENTRIES[atlas.dtype])
    stream = _build.stream_handle(atlas)
    _count(atlas, stream)
    _build.check(fn(atlas.data_ptr(), Ha, Wa, py, px, sy, sx, idx64, N, D,
                    out.data_ptr(), stream),
                 "gather_windows")
    return out


def gather_window_pair(atlas: Tensor, mask: Tensor, oy: Tensor, ox: Tensor,
                       D: int, offset: int, M: int):
    """In one launch: the (N, D, D) float32 windows of the float32 or
    bfloat16 ``atlas`` at the clamped origins, and the (N, M, M) windows of
    the bool ``mask`` (same shape as the atlas) at the origins moved by
    ``offset``, clamped."""
    if atlas.device.type == "cpu":
        return gather_window_pair_plain(atlas, mask, oy, ox, D, offset, M)
    _check_atlas(atlas, _PAIR_ENTRIES, "gather_window_pair")
    _check_atlas(mask, (torch.bool, torch.uint8), "gather_window_pair")
    if mask.shape != atlas.shape or mask.device != atlas.device:
        raise ValueError("gather_window_pair: mask and atlas differ: "
                         f"{tuple(mask.shape)} on {mask.device} vs "
                         f"{tuple(atlas.shape)} on {atlas.device}")
    py, px, sy, sx, idx64, N = _origin_args(atlas, oy, ox, (D, M),
                                            "gather_window_pair")
    atlas = atlas.contiguous()
    mask = mask.contiguous()
    Ha, Wa = atlas.shape
    out = torch.empty((N, D, D), dtype=torch.float32, device=atlas.device)
    mout = torch.empty((N, M, M), dtype=mask.dtype, device=atlas.device)
    if N == 0:
        return out, mout
    fn = _entry(_PAIR_ENTRIES[atlas.dtype])
    stream = _build.stream_handle(atlas)
    _count(atlas, stream)
    _build.check(fn(atlas.data_ptr(), mask.data_ptr(), Ha, Wa, py, px, sy,
                    sx, idx64, N, D, offset, M, out.data_ptr(),
                    mout.data_ptr(), stream),
                 "gather_window_pair")
    return out, mout
