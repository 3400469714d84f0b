"""K6: the sub-pixel refinement of patch matches (``csrc/subpix.cu``).

Replaces the JAX package's ``lax.while_loop`` in
``ptam_cg_tpu/ops/patch.py::subpix_refine`` (:381-508), which the tracker
runs twice a frame (the coarse search, N = 128 on 40x40 windows, and the
fine one, N = 1024 on 30x30 windows, 8 iterations each), the MapMaker's
re-find on 16x16 windows (8) and its epipolar search and the stereo init
on gathered 15x15 windows (10). The kernel runs the preamble and every
iteration of every point in one launch, a warp a point (see the note in
the source).

``subpix_refine`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises. ``subpix_refine_plain`` is the port's
masked loop as it was. Both return (pos (N, 2), converged (N,),
last_step (N,)); ``ops/patch.py`` wraps them in its ``SubPixResult``. The
kernel rounds every operation in the plain version's order on the CPU,
its sums included (PyTorch's CPU product of such small matrices adds in
sample order from zero), so it returns the plain version's CPU outputs
bit for bit; the plain version on the card sums in cuBLAS's order.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Tuple

import torch

from ptam_cg_tpu_torch.config import PATCH_SIZE
from ptam_cg_tpu_torch.kernels import _build

Tensor = torch.Tensor

#: The largest window side and iteration count one launch takes (the
#: source's MAX_D and MAX_ITS); the tracker's coarse windows are 40 wide.
MAX_D = 64
MAX_ITS = 32

#: Kernel launches made by ``subpix_refine`` in this process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}


def inv3x3(m: Tensor) -> Tensor:
    """Batched closed-form (adjugate) 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def subpix_refine_plain(templates: Tensor, pos0: Tensor, bounds: Tensor,
                        windows: Tensor, win_origin: Tensor, max_its: int,
                        conv_limit: float, patch_size: int = PATCH_SIZE
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``subpix_refine``: the masked loop of ``max_its``
    iterations; settled points take no further updates."""
    N = templates.shape[0]
    P = patch_size
    ph = P // 2
    Q = P - 2
    dev = templates.device

    gx = 0.5 * (templates[:, 1:-1, 2:] - templates[:, 1:-1, :-2])
    gy = 0.5 * (templates[:, 2:, 1:-1] - templates[:, :-2, 1:-1])
    J = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(N, -1, 3)
    H = J.transpose(1, 2) @ J
    Hinv = inv3x3(H + 1e-9 * torch.eye(3, device=dev))
    t_interior = templates[:, 1:-1, 1:-1]

    win = windows
    D = win.shape[-1]
    origin = win_origin
    n_idx = torch.arange(N, device=dev)[:, None, None]
    span = torch.arange(Q + 1, device=dev)

    pos = pos0
    mean_diff = torch.zeros(N, dtype=torch.float32, device=dev)
    conv = torch.zeros(N, dtype=torch.bool, device=dev)
    failed = torch.zeros(N, dtype=torch.bool, device=dev)
    last_step = torch.zeros(N, dtype=torch.float32, device=dev)
    for _ in range(max_its):
        in_im = ((pos[:, 0] - ph - 1 >= bounds[:, 0]) &
                 (pos[:, 1] - ph - 1 >= bounds[:, 1]) &
                 (pos[:, 0] + ph + 1 <= bounds[:, 2]) &
                 (pos[:, 1] + ph + 1 <= bounds[:, 3]))
        base = pos - ph - origin                  # patch top-left in window
        fb = torch.floor(base)
        frac = base - fb
        ib = fb.to(torch.int64)
        in_win = ((ib[:, 0] >= 0) & (ib[:, 1] >= 0)
                  & (ib[:, 0] + P + 1 <= D) & (ib[:, 1] + P + 1 <= D))
        failed = failed | ~in_im | ~in_win
        ibx = torch.clamp(ib[:, 0], 0, D - P - 1)
        iby = torch.clamp(ib[:, 1], 0, D - P - 1)
        # S1 = win[ib + 1 + (0..Q, 0..Q)]: the interior and one more
        # row/column for the bilinear blend.
        rows = (iby[:, None] + 1 + span)[:, :, None]
        cols = (ibx[:, None] + 1 + span)[:, None, :]
        S1 = win[n_idx, rows, cols]                   # (N, Q+1, Q+1)
        fx = frac[:, 0][:, None, None]
        fy = frac[:, 1][:, None, None]
        cur = ((1 - fx) * (1 - fy) * S1[:, :Q, :Q]
               + fx * (1 - fy) * S1[:, :Q, 1:Q + 1]
               + (1 - fx) * fy * S1[:, 1:Q + 1, :Q]
               + fx * fy * S1[:, 1:Q + 1, 1:Q + 1])
        diff = (cur - t_interior + mean_diff[:, None, None]).reshape(N, 1, -1)
        accum = (diff @ J)[:, 0]                      # (N, 3)
        upd = (Hinv @ accum[..., None])[..., 0]
        active = ~(conv | failed)
        pos = torch.where(active[:, None], pos - upd[:, :2], pos)
        mean_diff = torch.where(active, mean_diff - upd[:, 2], mean_diff)
        step_sq = torch.sum(upd[:, :2] ** 2, dim=-1)
        last_step = torch.where(active, step_sq, last_step)
        conv = conv | (active & (step_sq < conv_limit * conv_limit))
    return pos, conv & ~failed, last_step


def validate(templates: Tensor, pos0: Tensor, bounds: Tensor,
             windows: Tensor, win_origin: Tensor, max_its: int,
             patch_size: int = PATCH_SIZE) -> None:
    """Raise ValueError on what the kernel cannot take: a patch size other
    than ``PATCH_SIZE``, a window side outside [P + 2, ``MAX_D``],
    ``max_its`` outside [0, ``MAX_ITS``], no point, shapes other than
    (N, P, P), (N, 2), (N, 4), (N, D, D), (N, 2), a dtype other than
    float32, a strided tensor, tensors on several devices."""
    P = patch_size
    if P != PATCH_SIZE:
        raise ValueError(f"subpix_refine: the kernel takes {PATCH_SIZE}x"
                         f"{PATCH_SIZE} patches, got {P}")
    N = templates.shape[0] if templates.ndim == 3 else -1
    D = windows.shape[-1] if windows.ndim == 3 else -1
    if N < 1:
        raise ValueError(f"subpix_refine: templates must be (N, P, P) with "
                         f"N >= 1, got {tuple(templates.shape)}")
    if not P + 2 <= D <= MAX_D:
        raise ValueError(f"subpix_refine: the kernel takes windows {P + 2} "
                         f"to {MAX_D} wide, got {tuple(windows.shape)}")
    if not 0 <= max_its <= MAX_ITS:
        raise ValueError(f"subpix_refine: the kernel takes 0 to {MAX_ITS} "
                         f"iterations, got {max_its}")
    dev = templates.device
    for what, x, shape in (("templates", templates, (N, P, P)),
                           ("pos0", pos0, (N, 2)),
                           ("bounds", bounds, (N, 4)),
                           ("windows", windows, (N, D, D)),
                           ("win_origin", win_origin, (N, 2))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 or \
                x.device != dev or not x.is_contiguous():
            raise ValueError(
                f"subpix_refine: {what} must be a contiguous float32 tensor "
                f"of shape {shape} on {dev}, got {tuple(x.shape)} "
                f"{x.dtype} on {x.device}"
                f"{'' if x.is_contiguous() else ', strided'}")


def _lib():
    fn = _build.load("subpix").subpix_refine
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def subpix_refine(templates: Tensor, pos0: Tensor, bounds: Tensor,
                  windows: Tensor, win_origin: Tensor, max_its: int,
                  conv_limit: float, patch_size: int = PATCH_SIZE
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse-composition alignment (x, y, mean difference) of templates
    (N, P, P) on windows (N, D, D) whose top-left lies at ``win_origin``
    (N, 2) (x, y), from atlas positions ``pos0`` (N, 2), inside the level
    rects ``bounds`` (N, 4), for ``max_its`` iterations at most; a squared
    step below ``conv_limit``^2 converges a point. Returns (pos (N, 2),
    converged (N,) bool, last_step (N,))."""
    if templates.device.type == "cpu":
        return subpix_refine_plain(templates, pos0, bounds, windows,
                                   win_origin, max_its, conv_limit,
                                   patch_size)
    validate(templates, pos0, bounds, windows, win_origin, max_its,
             patch_size)
    if templates.device.type != "cuda":
        raise ValueError(f"subpix_refine: need CUDA tensors, got "
                         f"{templates.device}")
    N, D = templates.shape[0], windows.shape[-1]
    dev = templates.device
    pos = torch.empty((N, 2), dtype=torch.float32, device=dev)
    conv = torch.empty(N, dtype=torch.bool, device=dev)
    step = torch.empty(N, dtype=torch.float32, device=dev)
    fn = _lib()
    stream = _build.stream_handle(templates)
    _build.count_launch(sys.modules[__name__], stream)
    _build.check(fn(templates.data_ptr(), pos0.data_ptr(), bounds.data_ptr(),
                    windows.data_ptr(), win_origin.data_ptr(), N, D,
                    int(max_its), float(conv_limit * conv_limit),
                    pos.data_ptr(), conv.data_ptr(), step.data_ptr(), stream),
                 "subpix_refine")
    return pos, conv, step
