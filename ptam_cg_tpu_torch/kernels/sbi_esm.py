"""K5: the ESM alignment of two small blurry images
(``csrc/sbi_esm.cu``).

Replaces the JAX package's ``lax.fori_loop`` in
``ptam_cg_tpu/ops/sbi.py::iterate_pos_rel_to_target`` (:64-147), which
``calc_sbi_rotation`` runs once a tracked frame (the rotation seed) and
once a relocalization. The JAX package warps by a one-hot (hw, hw)
product because per-element gathers are slow on the TPU; the kernel
reads the four bilinear taps from shared memory, and runs all the
iterations in one block (see the note in the source).

``esm`` runs the plain version for CPU tensors and launches the kernel
for CUDA tensors, or raises. ``esm_plain`` is the port's loop as it was.
Both take the templates and the target's gradients as tensors and return
(R (2, 2), t (2,), score); ``ops/sbi.py`` wraps them in its ``SE2``. The
warp is bit for bit the plain version's at the same SE2; the sums and the
4x4 solve round otherwise.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Tuple

import torch

from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.utils import geometry as geomlib
from ptam_cg_tpu_torch.utils import se3 as se3lib

Tensor = torch.Tensor

#: The most pixels one launch takes (the source's MAX_PIX: three images
#: and the warp in shared memory, 21 bytes a pixel of the H100's 227 kB a
#: block). The SBI of a 1920x1080 frame is 67x120, 8,040 pixels.
MAX_PIX = 11008

#: Kernel launches made by ``esm`` in this process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}


def esm_plain(moving: Tensor, target: Tensor, target_jac: Tensor,
              n_iterations: int = 10) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``esm``: the SE2 (R, t) warping the template
    ``moving`` (h, w) onto ``target`` (h, w) with gradients ``target_jac``
    (h, w, 2), and the last iteration's score."""
    tmpl = moving
    h, w = tmpl.shape
    dev = tmpl.device
    cx, cy = w // 2, h // 2
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    interior = (ys >= 1) & (ys < h - 1) & (xs >= 1) & (xs < w - 1)
    tmpl_flat = tmpl.reshape(-1)
    center = torch.stack([xs[0, cx], ys[cy, 0]])

    def warp(R, t):
        """warped[p] = template(R p + t), bilinear; -9e20 where the 2x2
        support leaves the image (CVD::transform's fill)."""
        px = R[0, 0] * xs + R[0, 1] * ys + t[0]
        py = R[1, 0] * xs + R[1, 1] * ys + t[1]
        fx0 = torch.floor(px)
        fy0 = torch.floor(py)
        fx, fy = px - fx0, py - fy0
        x0 = fx0.to(torch.int64)
        y0 = fy0.to(torch.int64)
        valid = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
        base = (torch.clamp(y0, 0, h - 2) * w
                + torch.clamp(x0, 0, w - 2)).reshape(-1)
        t00 = tmpl_flat[base].reshape(h, w)
        t01 = tmpl_flat[base + 1].reshape(h, w)
        t10 = tmpl_flat[base + w].reshape(h, w)
        t11 = tmpl_flat[base + w + 1].reshape(h, w)
        vals = (t00 * ((1 - fx) * (1 - fy)) + t01 * (fx * (1 - fy))
                + t10 * ((1 - fx) * fy) + t11 * (fx * fy))
        return torch.where(valid, vals, -9e20), valid

    R_cc = torch.eye(2, dtype=torch.float32, device=dev)
    t_cc = torch.zeros(2, dtype=torch.float32, device=dev)
    mean_off = torch.zeros((), dtype=torch.float32, device=dev)
    score = torch.zeros((), dtype=torch.float32, device=dev)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    for _ in range(n_iterations):
        # se2XForm = W * CtoC * W^-1 (warp about the image centre).
        t_x = center + t_cc - R_cc @ center
        warped, wvalid = warp(R_cc, t_x)
        ok = interior & wvalid
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ok = ok & torch.roll(wvalid, (-dy, -dx), dims=(0, 1))
        gx = torch.roll(warped, -1, dims=1) - torch.roll(warped, 1, dims=1)
        gy = torch.roll(warped, -1, dims=0) - torch.roll(warped, 1, dims=0)
        sum_gx = 0.25 * (gx + target_jac[..., 0])
        sum_gy = 0.25 * (gy + target_jac[..., 1])
        j2 = -(ys - cy) * sum_gx + (xs - cx) * sum_gy
        diff = warped - target + mean_off
        m = ok.to(torch.float32)
        J = torch.stack([sum_gx, sum_gy, j2, torch.ones_like(sum_gx)],
                        dim=-1) * m[..., None]
        d = diff * m
        score = torch.sum(d * d)
        JTd = torch.einsum("hwk,hw->k", J, d)
        JTJ = torch.einsum("hwi,hwj->ij", J, J)
        upd = geomlib.spd_solve(JTJ + 1e-8 * eye4, JTd)
        t_cc = R_cc @ (-upd[:2]) + t_cc
        R_cc = R_cc @ se3lib.so2_exp(-upd[2])
        mean_off = mean_off - upd[3]
    return R_cc, t_cc, score


def validate(moving: Tensor, target: Tensor, target_jac: Tensor,
             n_iterations: int) -> None:
    """Raise ValueError on what the kernel cannot take: images other than
    (h, w), (h, w), (h, w, 2) float32 on one device, strided, smaller
    than 3x3 or above ``MAX_PIX`` pixels; a negative iteration count."""
    if moving.ndim != 2:
        raise ValueError(f"esm: the moving template must be (h, w), got "
                         f"{tuple(moving.shape)}")
    h, w = moving.shape
    if not (h >= 3 and w >= 3 and h * w <= MAX_PIX):
        raise ValueError(f"esm: the kernel takes 3x3 to {MAX_PIX} pixels in "
                         f"one block, got {h}x{w}")
    for what, x, shape in (("moving", moving, (h, w)),
                           ("target", target, (h, w)),
                           ("target_jac", target_jac, (h, w, 2))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 or \
                x.device != moving.device or not x.is_contiguous():
            raise ValueError(
                f"esm: {what} must be a contiguous float32 tensor of shape "
                f"{shape} on {moving.device}, got {tuple(x.shape)} "
                f"{x.dtype} on {x.device}"
                f"{'' if x.is_contiguous() else ', strided'}")
    if n_iterations < 0:
        raise ValueError(f"esm: {n_iterations} iterations")


def _lib():
    fn = _build.load("sbi_esm").sbi_esm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def esm(moving: Tensor, target: Tensor, target_jac: Tensor,
        n_iterations: int = 10) -> Tuple[Tensor, Tensor, Tensor]:
    """ESM alignment: the SE2 (R (2, 2), t (2,)) warping the template
    ``moving`` (h, w) onto the template ``target`` (h, w) with gradients
    ``target_jac`` (h, w, 2), and the final score, after
    ``n_iterations`` iterations."""
    if moving.device.type == "cpu":
        return esm_plain(moving, target, target_jac, n_iterations)
    validate(moving, target, target_jac, n_iterations)
    if moving.device.type != "cuda":
        raise ValueError(f"esm: need CUDA tensors, got {moving.device}")
    h, w = moving.shape
    out = torch.empty(7, dtype=torch.float32, device=moving.device)
    fn = _lib()
    stream = _build.stream_handle(moving)
    _build.count_launch(sys.modules[__name__], stream)
    _build.check(fn(moving.data_ptr(), target.data_ptr(),
                    target_jac.data_ptr(), h, w, int(n_iterations),
                    out.data_ptr(), stream), "esm")
    return out[:4].view(2, 2), out[4:6], out[6]
