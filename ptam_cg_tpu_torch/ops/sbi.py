"""SmallBlurryImage: construction, ESM SE2 alignment, SE3-from-SE2 (port of
``ptam_cg_tpu.ops.sbi``).

The bilinear warp of the ESM loop reads its four taps with a direct
indexed load; the JAX package expresses the same sampling as an (hw, hw)
one-hot matmul because per-element gathers are slow on the TPU. The loops
have fixed counts (10 ESM iterations, 3 Gauss-Newton steps), so they run
as plain Python loops with no data-dependent exit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.ops import image as imops
from ptam_cg_tpu_torch.utils import geometry as geomlib
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


@dataclasses.dataclass
class SBI:
    template: Tensor   # (h, w) zero-mean blurred float32
    jac: Tensor        # (h, w, 2) gradient image (no 0.5 factor)


@dataclasses.dataclass
class SE2:
    R: Tensor  # (2, 2)
    t: Tensor  # (2,)


def se2_identity(device) -> SE2:
    return SE2(torch.eye(2, dtype=torch.float32, device=device),
               torch.zeros(2, dtype=torch.float32, device=device))


def se2_mul(a: SE2, b: SE2) -> SE2:
    return SE2(a.R @ b.R, a.R @ b.t + a.t)


def make_sbi(level3: Tensor, blur: float = 2.5) -> SBI:
    """SBI from pyramid level 3: half-sample, subtract the mean, blur."""
    small = imops.half_sample(level3)
    tmpl = imops.gaussian_blur(small - torch.mean(small), blur)
    gx, gy = imops.central_gradients(tmpl)
    return SBI(template=tmpl, jac=torch.stack([gx, gy], dim=-1))


def so2_exp(theta: Tensor) -> Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def iterate_pos_rel_to_target(moving: SBI, target: SBI,
                              n_iterations: int = 10) -> Tuple[SE2, Tensor]:
    """ESM alignment: the SE2 warping ``moving`` onto ``target``.
    Returns (se2_c_to_c, final_score)."""
    tmpl = moving.template
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
        sum_gx = 0.25 * (gx + target.jac[..., 0])
        sum_gy = 0.25 * (gy + target.jac[..., 1])
        j2 = -(ys - cy) * sum_gx + (xs - cx) * sum_gy
        diff = warped - target.template + mean_off
        m = ok.to(torch.float32)
        J = torch.stack([sum_gx, sum_gy, j2, torch.ones_like(sum_gx)],
                        dim=-1) * m[..., None]
        d = diff * m
        score = torch.sum(d * d)
        JTd = torch.einsum("hwk,hw->k", J, d)
        JTJ = torch.einsum("hwi,hwj->ij", J, J)
        upd = geomlib.spd_solve(JTJ + 1e-8 * eye4, JTd)
        t_cc = R_cc @ (-upd[:2]) + t_cc
        R_cc = R_cc @ so2_exp(-upd[2])
        mean_off = mean_off - upd[3]
    return SE2(R_cc, t_cc), score


def se3_from_se2(se2: SE2, cam_params: Tensor,
                 sbi_size: Tuple[int, int]) -> SE3:
    """Pure-rotation SE3 inducing the given SE2 on the SBI: project two
    points through an SBI-sized camera and Gauss-Newton a 3-DoF SO3."""
    h, w = sbi_size
    dev = se2.R.device
    cam = atan.make_camera(cam_params, (w, h), dev)
    # Built from device fills: an indexed store of a Python number into a
    # CUDA tensor is a host-to-device copy, which syncs.
    cx = torch.full((), w / 2, dtype=torch.float32, device=dev)
    center = torch.stack([cx, torch.full_like(cx, h / 2)])
    off = torch.stack([torch.full_like(cx, 5.0), torch.zeros_like(cx)])
    pix0 = torch.stack([center + off, center - off])
    # R @ (+-5, 0) is exactly +-5 R[:, 0].
    turned = torch.stack([5.0 * se2.R[:, 0], -5.0 * se2.R[:, 0]]) \
        + center + se2.t
    z1 = atan.unproject(pix0, cam)
    orig = torch.cat([z1, torch.ones_like(z1[:, :1])], dim=-1)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    R = eye3
    for _ in range(3):
        p_cam = orig @ R.T
        z = p_cam[:, 2]
        implane = p_cam[:, :2] / z[:, None]
        err = turned - atan.project(implane, cam)
        cam_d = atan.project_derivs(implane, cam)
        inv_z = 1.0 / z
        gen = se3lib.motion_jacobian(p_cam)[:, 3:, :]          # (2, 3, 3)
        plane_motion = (gen[..., :2]
                        - p_cam[:, None, :2] * gen[..., 2:]
                        * inv_z[:, None, None]) * inv_z[:, None, None]
        Jpix = torch.einsum("nij,nmj->nmi", cam_d, plane_motion)
        J = Jpix.permute(0, 2, 1).reshape(-1, 3)                # (4, 3)
        JTJ = J.T @ J + 10.0 * eye3
        upd = geomlib.spd_solve(JTJ, J.T @ err.reshape(-1))
        R = se3lib.so3_exp(upd) @ R
    return SE3(R, torch.zeros(3, dtype=torch.float32, device=dev))


def calc_sbi_rotation(moving: SBI, target: SBI, cam_params: Tensor,
                      sbi_size: Tuple[int, int],
                      n_iterations: int = 10) -> Tuple[SE3, Tensor]:
    """ESM + SE2 -> SE3. Returns (rotation-only SE3, score)."""
    se2, score = iterate_pos_rel_to_target(moving, target, n_iterations)
    return se3_from_se2(se2, cam_params, sbi_size), score
