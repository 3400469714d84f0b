"""Dense image ops: pyramid, Gaussian blur, gradients, box sums and the
Shi-Tomasi score map (port of ``ptam_cg_tpu.ops.image``). Images are
float32 (..., H, W) with intensities in [0, 255].

``box_sum`` and the Shi-Tomasi score live beside their Hopper kernel (K3)
in ``kernels/shi_tomasi.py``: ``shi_tomasi_atlas`` scores every level of
a pyramid atlas in one launch on a CUDA tensor (the plain version on a CPU
tensor), and ``shi_tomasi_score_map`` is the plain one-image function.
Both sum the box in the order of the banded TPU kernel, which differs
from the JAX package's cumsum form by float rounding only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ptam_cg_tpu_torch.kernels.shi_tomasi import (  # noqa: F401
    box_sum, shi_tomasi_atlas, shi_tomasi_score_map_plain)

Tensor = torch.Tensor

#: The one-image Shi-Tomasi score under the JAX package's name.
shi_tomasi_score_map = shi_tomasi_score_map_plain


def half_sample(im: Tensor) -> Tensor:
    """2x2 box-filter downsample (libCVD halfSample); odd trailing
    row/col dropped. The four taps are summed in the order the JAX
    package's reduction uses, so the result is bit-identical."""
    H2, W2 = im.shape[-2] // 2, im.shape[-1] // 2
    r = im[..., : H2 * 2, : W2 * 2].reshape(*im.shape[:-2], H2, 2, W2, 2)
    s = ((r[..., 0, :, 0] + r[..., 0, :, 1]) + r[..., 1, :, 0]) \
        + r[..., 1, :, 1]
    return s / 4.0


def build_pyramid(im: Tensor, levels: int = 4) -> tuple:
    out = [im]
    for _ in range(levels - 1):
        out.append(half_sample(out[-1]))
    return tuple(out)


@functools.lru_cache(maxsize=32)
def _gauss_kernel(sigma: float) -> tuple:
    """Taps rounded to float32, as the JAX package stores them."""
    radius = max(1, int(math.ceil(2.5 * sigma)))
    xs = [math.exp(-0.5 * (i / sigma) ** 2)
          for i in range(-radius, radius + 1)]
    s = sum(xs)
    return tuple(float(np.float32(x / s)) for x in xs)


def _conv1d_last(x: Tensor, k: tuple) -> Tensor:
    """Correlate the last axis with taps ``k`` (valid mode)."""
    L = x.shape[-1] - len(k) + 1
    acc = torch.zeros((*x.shape[:-1], L), dtype=x.dtype, device=x.device)
    for i, ki in enumerate(k):
        acc = acc + ki * x[..., i: i + L]
    return acc


def _edge_pad_last(x: Tensor, r: int) -> Tensor:
    n = x.shape[-1]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    return x.index_select(-1, idx)


def gaussian_blur(im: Tensor, sigma: float) -> Tensor:
    """Separable Gaussian blur with edge-replicate padding; ``sigma`` is a
    Python float."""
    if sigma <= 0:
        return im
    k = _gauss_kernel(float(sigma))
    r = (len(k) - 1) // 2
    x = _edge_pad_last(im.transpose(-1, -2), r)      # rows first
    x = _conv1d_last(x, k).transpose(-1, -2)
    return _conv1d_last(_edge_pad_last(x, r), k)


def central_gradients(im: Tensor) -> tuple:
    """(gx, gy) central differences without the 0.5 factor, zero on the
    1-px border."""
    gx = torch.zeros_like(im)
    gy = torch.zeros_like(im)
    gx[..., 1:-1] = im[..., 2:] - im[..., :-2]
    gy[..., 1:-1, :] = im[..., 2:, :] - im[..., :-2, :]
    return gx, gy


def zero_mean(im: Tensor) -> Tensor:
    """``im`` less its mean over the last two dims."""
    return im - torch.mean(im, dim=(-2, -1), keepdim=True)


def bilinear_sample(im: Tensor, xy: Tensor, pad_value: float = 0.0):
    """Bilinear interpolation of ``im`` (H, W) at the (x, y) pixel points
    ``xy`` (..., 2). Returns (values, valid): valid marks samples whose
    2x2 support lies inside the image; the others read ``pad_value``."""
    H, W = im.shape[-2], im.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    valid = (x0i >= 0) & (y0i >= 0) & (x0i + 1 <= W - 1) & (y0i + 1 <= H - 1)
    x0c = torch.clamp(x0i, 0, W - 2)
    y0c = torch.clamp(y0i, 0, H - 2)
    v00, v01 = im[y0c, x0c], im[y0c, x0c + 1]
    v10, v11 = im[y0c + 1, x0c], im[y0c + 1, x0c + 1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    vals = top * (1 - fy) + bot * fy
    return torch.where(valid, vals, torch.full_like(vals, pad_value)), valid


def affine_warp_sample(im: Tensor, center: Tensor, A: Tensor,
                       offsets: Tensor, pad_value: float = 0.0):
    """Bilinear samples of ``im`` at center + A @ offset for each of the
    (P, 2) ``offsets`` (CVD::transform's template warp,
    src/PatchFinder.cc:98-127); ``A`` (2, 2), ``center`` (2,) as (x, y).
    Returns (values (P,), valid (P,))."""
    return bilinear_sample(im, center + offsets @ A.T, pad_value)


def patch_offsets(size: int, device="cuda") -> Tensor:
    """(size*size, 2) float32 offsets from the patch centre, row-major,
    the centre at size // 2 (src/PatchFinder.cc:104-110)."""
    c = size // 2
    ys, xs = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device),
                            indexing="ij")
    return torch.stack([(xs - c).reshape(-1), (ys - c).reshape(-1)],
                       dim=-1).to(torch.float32)


def extract_patch(im: Tensor, center_xy: Tensor, size: int,
                  pad_value: float = 0.0):
    """The size x size patch whose top-left is the integer centre minus
    size // 2 (GetImageROI, src/ImageProcess.cc:11-18). Returns (patch,
    valid): a patch that would leave the image is read clamped inside it
    and filled with ``pad_value``. No host read: the window is gathered
    at tensor offsets."""
    H, W = im.shape[-2], im.shape[-1]
    c = center_xy.to(torch.int64)
    x0 = c[0] - size // 2
    y0 = c[1] - size // 2
    valid = (x0 >= 0) & (y0 >= 0) & (x0 + size <= W) & (y0 + size <= H)
    x0c = torch.clamp(x0, 0, W - size)
    y0c = torch.clamp(y0, 0, H - size)
    r = torch.arange(size, device=im.device)
    patch = im[..., (y0c + r)[:, None], (x0c + r)[None, :]]
    return torch.where(valid, patch, torch.full_like(patch, pad_value)), valid
