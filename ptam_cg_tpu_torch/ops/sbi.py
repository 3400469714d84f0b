"""SmallBlurryImage: construction, ESM SE2 alignment, SE3-from-SE2 (port of
``ptam_cg_tpu.ops.sbi``).

The ESM loop is one kernel launch on the card (K5,
``kernels/sbi_esm.py``); its bilinear warp reads its four taps directly,
where the JAX package expresses the same sampling as an (hw, hw) one-hot
matmul because per-element gathers are slow on the TPU. The 3
Gauss-Newton steps of ``se3_from_se2`` run as a plain Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
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


def iterate_pos_rel_to_target(moving: SBI, target: SBI,
                              n_iterations: int = 10) -> Tuple[SE2, Tensor]:
    """ESM alignment: the SE2 warping ``moving`` onto ``target``, one K5
    launch on the card (``kernels/sbi_esm.py``). Returns (se2_c_to_c,
    final_score)."""
    R, t, score = kesm.esm(moving.template, target.template, target.jac,
                           n_iterations)
    return SE2(R, t), score


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
