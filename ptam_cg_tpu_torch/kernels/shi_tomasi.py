"""K3: Shi-Tomasi minimum-eigenvalue score map (``csrc/shi_tomasi.cu``).

Replaces the TPU kernels ``ptam_cg_tpu/ops/pallas_kernels.py``
``shi_tomasi_banded`` and ``shi_tomasi_pallas``; the function is
``ptam_cg_tpu/ops/image.py::shi_tomasi_score_map``. The kernel is bound by
bytes and, at the keyframe shapes, by its launch (see the note in the
source); it stages each output tile with its 4-px halo in shared memory
and keeps the gradient products and their row sums there.

The plain version sums in the order of the banded TPU kernel
(``pallas_kernels.py:288-307``): gradients, the three products, a row sum
over dy = 0..6, a column sum over dx = 0..6, then the divide, the
discriminant and the square root. The kernel does the same with every
operation separately rounded, so the two are bit-identical.

``shi_tomasi_score_map`` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ptam_cg_tpu_torch.kernels import _build

Tensor = torch.Tensor

#: The box half-width the kernel is built for (the keyframe build's).
HALF_BOX = 3

#: Kernel launches made by ``shi_tomasi_score_map`` in this process.
launches = 0


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


def _lib():
    lib = _build.load("shi_tomasi")
    fn = lib.shi_tomasi_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def shi_tomasi_score_map(im: Tensor, half_box: int = HALF_BOX) -> Tensor:
    """Shi-Tomasi score of one (H, W) float32 image."""
    if im.device.type == "cpu":
        return shi_tomasi_score_map_plain(im, half_box)
    if im.device.type != "cuda":
        raise ValueError(f"shi_tomasi_score_map: unsupported device "
                         f"{im.device}")
    if im.dtype != torch.float32 or im.ndim != 2:
        raise ValueError("shi_tomasi_score_map: need a 2-D float32 image, "
                         f"got {tuple(im.shape)} {im.dtype}")
    if half_box != HALF_BOX:
        raise ValueError(f"shi_tomasi_score_map: the kernel is built for "
                         f"half_box={HALF_BOX}, got {half_box}")
    im = im.contiguous()
    H, W = im.shape
    out = torch.empty((H, W), dtype=torch.float32, device=im.device)
    fn = _lib()
    global launches
    launches += 1
    _build.check(fn(im.data_ptr(), out.data_ptr(), H, W,
                    _build.stream_handle(im)), "shi_tomasi_launch")
    return out
