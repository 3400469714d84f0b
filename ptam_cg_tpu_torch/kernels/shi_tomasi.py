"""K3: Shi-Tomasi minimum-eigenvalue score map (``csrc/shi_tomasi.cu``).

Replaces the TPU kernels ``ptam_cg_tpu/ops/pallas_kernels.py``
``shi_tomasi_banded`` and ``shi_tomasi_pallas``; the function is
``ptam_cg_tpu/ops/image.py::shi_tomasi_score_map`` on each pyramid level.

``shi_tomasi_atlas`` scores all four levels of a packed pyramid atlas in
one launch: each level's score inside its 4-px border, 0 on the borders
and on the atlas's unused area. It runs the plain version for a CPU
tensor and the kernel for a CUDA tensor. ``shi_tomasi_score_map_plain``
is the single-image function, the plain version of each level.

The plain version sums in the order of the banded TPU kernel
(``pallas_kernels.py:288-307``): gradients, the three products, a row sum
over dy = 0..6, a column sum over dx = 0..6, then the divide, the
discriminant and the square root. The kernel does the same with every
operation separately rounded, so the two are bit-identical.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Sequence

import torch

from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.kernels import fast as kfast

Tensor = torch.Tensor

#: The box half-width the kernel is built for (the keyframe build's).
HALF_BOX = 3

#: Kernel launches made by ``shi_tomasi_atlas`` in this process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}


def box_sum(im: Tensor, radius: int) -> Tensor:
    """Sum over the (2r+1)^2 box around each pixel, zero padding: the
    rows dy = 0..2r first, then the columns dx = 0..2r, each in order."""
    H, W = im.shape[-2:]
    n = 2 * radius + 1
    p = torch.nn.functional.pad(im, (radius, radius, radius, radius))
    rows = p[..., 0:H, :]
    for dy in range(1, n):
        rows = rows + p[..., dy: dy + H, :]
    acc = rows[..., :, 0:W]
    for dx in range(1, n):
        acc = acc + rows[..., :, dx: dx + W]
    return acc


def shi_tomasi_score_map_plain(im: Tensor, half_box: int = HALF_BOX) -> Tensor:
    """Plain PyTorch Shi-Tomasi score of one (H, W) image, zero on the
    ``half_box + 1`` border."""
    im = im.to(torch.float32)
    H, W = im.shape
    p = torch.nn.functional.pad(im, (1, 1, 1, 1))
    gx = p[1:-1, 2:] - p[1:-1, :-2]
    gy = p[2:, 1:-1] - p[:-2, 1:-1]
    # A tensor divisor: PyTorch on CUDA turns a division by a Python
    # scalar into a multiply by its reciprocal, which rounds differently.
    n = torch.full((), float((2 * half_box + 1) ** 2) * 2.0,
                   device=im.device)
    dxx = box_sum(gx * gx, half_box) / n
    dyy = box_sum(gy * gy, half_box) / n
    dxy = box_sum(gx * gy, half_box) / n
    tr = dxx + dyy
    disc = tr * tr - 4.0 * (dxx * dyy - dxy * dxy)
    # The square root in float64, rounded once to float32: correctly
    # rounded, as the kernel's, on every device (PyTorch's float32 sqrt on
    # an AVX-512 CPU is not).
    root = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
    score = 0.5 * (tr - root)
    b = half_box + 1
    inner = torch.zeros((H, W), dtype=torch.bool, device=im.device)
    inner[b:H - b, b:W - b] = True
    return torch.where(inner, score, 0.0)


def shi_tomasi_atlas_plain(atlas: Tensor) -> Tensor:
    """Plain version of ``shi_tomasi_atlas``: ``shi_tomasi_score_map_plain``
    on each level's view, packed into zeros."""
    out = torch.zeros(atlas.shape, dtype=torch.float32, device=atlas.device)
    for r, c, hl, wl in kfast.level_rects(atlas.shape):
        out[r: r + hl, c: c + wl] = shi_tomasi_score_map_plain(
            atlas[r: r + hl, c: c + wl])
    return out


def _lib(defines: Sequence[str] = ()):
    fn = _build.load("shi_tomasi", tuple(defines)).shi_tomasi_atlas
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _rects_arg(shape):
    """The level table of an atlas shape as the C entry takes it."""
    flat = [int(v) for rect in kfast.level_rects(shape) for v in rect]
    return (ctypes.c_int * len(flat))(*flat)


def shi_tomasi_atlas(atlas: Tensor, defines: Sequence[str] = ()) -> Tensor:
    """Shi-Tomasi score of every level of a (1.5 H, W) float32 pyramid
    atlas, in the atlas layout. ``defines`` pick another tile shape of the
    kernel (``ST_TILE_W=..``, ``ST_TILE_H=..``, ``ST_PX=..``; chip_smoke.py
    phase 2c); the default build is the keyframe path's."""
    device = atlas.device.type
    if device == "cpu":
        return shi_tomasi_atlas_plain(atlas)
    if device != "cuda" or atlas.dtype != torch.float32 or atlas.ndim != 2:
        raise ValueError(f"shi_tomasi_atlas: need a 2-D float32 CUDA atlas, "
                         f"got {tuple(atlas.shape)} {atlas.dtype} on "
                         f"{atlas.device}")
    rects = _rects_arg(tuple(atlas.shape))
    atlas = atlas.contiguous()
    Ha, Wa = atlas.shape
    if Wa % 4 or atlas.data_ptr() % 16:
        raise ValueError(f"shi_tomasi_atlas: the kernel reads 16-byte rows; "
                         f"width {Wa} is no multiple of 4 or the data "
                         f"unaligned")
    out = torch.empty_like(atlas)
    fn = _lib(defines)
    stream = _build.stream_handle(atlas)
    _build.count_launch(sys.modules[__name__], stream)
    _build.check(fn(atlas.data_ptr(), Ha, Wa, rects, out.data_ptr(),
                    stream), "shi_tomasi_atlas")
    return out
