"""K1: FAST-10 corner mask and score (``csrc/fast10.cu``).

Replaces the TPU kernels ``ptam_cg_tpu/ops/pallas_kernels.py``
``fast_score_map_banded`` and ``fast_score_map_pallas``; the function is
``ptam_cg_tpu/ops/fast.py::fast_score_map``. The kernel is bound by bytes
and, at the tracking shapes, by its launch (see the note in the source);
it stages each output tile with its 3-px halo in shared memory so every
input byte is read from device memory once.

``fast_score_map`` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor. The result is bit-identical either way: the function
uses only f32 add, subtract, min and max.
"""

from __future__ import annotations

import ctypes

import torch

from ptam_cg_tpu_torch.kernels import _build

Tensor = torch.Tensor

ARC = 10  # FAST-10

#: FAST ring offsets (x, y), clockwise from 12 o'clock.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

#: Kernel launches made by ``fast_score_map`` in this process.
launches = 0


def fast_score_map_plain(im: Tensor, threshold: float):
    """Plain PyTorch FAST-10: (is_corner (H, W) bool, score (H, W) f32)."""
    im = im.to(torch.float32)
    H, W = im.shape
    pad = 3
    p = torch.nn.functional.pad(im, (pad, pad, pad, pad))
    ring = [p[pad + dy: pad + dy + H, pad + dx: pad + dx + W]
            for dx, dy in CIRCLE]
    ring = ring + ring[: ARC - 1]
    hi = im + threshold
    lo = im - threshold

    def arc_max(margins):
        best = None
        for s in range(16):
            m = margins[s]
            for k in range(1, ARC):
                m = torch.minimum(m, margins[s + k])
            best = m if best is None else torch.maximum(best, m)
        return best

    score = torch.maximum(arc_max([r - hi for r in ring]),
                          arc_max([lo - r for r in ring]))
    inner = torch.zeros((H, W), dtype=torch.bool, device=im.device)
    inner[pad:-pad, pad:-pad] = True
    is_corner = (score > 0.0) & inner
    return is_corner, torch.where(is_corner, score + threshold, 0.0)


def _lib():
    lib = _build.load("fast10")
    fn = lib.fast10_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fast_score_map(im: Tensor, threshold: float):
    """FAST-10 corner mask and score of one (H, W) float32 image."""
    if im.device.type == "cpu":
        return fast_score_map_plain(im, threshold)
    if im.device.type != "cuda":
        raise ValueError(f"fast_score_map: unsupported device {im.device}")
    if im.dtype != torch.float32 or im.ndim != 2:
        raise ValueError("fast_score_map: need a 2-D float32 image, got "
                         f"{tuple(im.shape)} {im.dtype}")
    im = im.contiguous()
    H, W = im.shape
    mask = torch.empty((H, W), dtype=torch.bool, device=im.device)
    score = torch.empty((H, W), dtype=torch.float32, device=im.device)
    fn = _lib()
    global launches
    launches += 1
    _build.check(fn(im.data_ptr(), mask.data_ptr(), score.data_ptr(), H, W,
                    float(threshold), _build.stream_handle(im)),
                 "fast10_launch")
    return mask, score
