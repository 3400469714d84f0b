"""ATAN (FOV) camera model on tensors (port of ``ptam_cg_tpu.camera.atan``).

Normalized parameters [fx fy cx cy w] scale with the image size exactly
as the reference does, including the -0.5 pixel centre offset. The unit
frame buffer (UFB) projections serve the AR compositor (``viz/ar.py``);
``param_derivs`` serves the calibrator (``camera/calibrator.py``);
``project_points`` and ``pose_jacobian`` the tracker and its pose loop
(``models/tracker.py``, ``kernels/pose_gn.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ptam_cg_tpu_torch.utils import se3 as se3lib

Tensor = torch.Tensor


@dataclasses.dataclass
class Camera:
    """Precomputed camera state; every field is a float32 tensor on the
    camera's device (scalars are 0-d)."""

    params: Tensor          # (5,) normalized [fx fy cx cy w]
    image_size: Tensor      # (2,) [width, height]
    focal: Tensor           # (2,) pixel focal
    center: Tensor          # (2,) pixel centre
    inv_focal: Tensor       # (2,)
    w: Tensor               # distortion parameter
    two_tan: Tensor         # 2 tan(w / 2)
    one_over_2tan: Tensor
    winv: Tensor            # 1 / w
    distortion_enabled: Tensor  # 1.0 or 0.0
    largest_radius: Tensor
    max_r: Tensor           # 1.5 * largest_radius
    one_pixel_dist: Tensor  # z=1 distance of one pixel
    implane_tl: Tensor      # (2,) z=1 bounds of the image's corners
    implane_br: Tensor      # (2,)
    ufb_linear_focal: Tensor   # (2,) linear z=1 -> UFB scale
    ufb_linear_center: Tensor  # (2,)


def _rtrans_factor(r: Tensor, cam: Camera) -> Tensor:
    """Distorted/undistorted radius ratio."""
    safe_r = torch.where(r < 0.001, torch.ones_like(r), r)
    fac = cam.winv * torch.atan(safe_r * cam.two_tan) / safe_r
    return torch.where((r < 0.001) | (cam.distortion_enabled == 0.0),
                       torch.ones_like(fac), fac)


def _invrtrans(r: Tensor, cam: Camera) -> Tensor:
    """Undistorted radius from distorted."""
    return torch.where(cam.distortion_enabled == 0.0, r,
                       torch.tan(r * cam.w) * cam.one_over_2tan)


def make_camera(params, image_size: Tuple[int, int],
                device="cuda") -> Camera:
    """Build the precomputed camera (RefreshParams) on ``device``.
    ``params`` is a sequence of 5 floats or a (5,) tensor."""
    if isinstance(params, Tensor):
        p = params.to(device=device, dtype=torch.float32)
    else:
        p = torch.tensor(params, dtype=torch.float32, device=device)
    dev = p.device
    W, H = image_size
    size = torch.stack([p.new_full((), float(W)), p.new_full((), float(H))])
    focal = size * p[:2]
    center = size * p[2:4] - 0.5
    w = p[4]
    on = w != 0.0
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    safe_w = torch.where(on, w, one)
    two_tan = torch.where(on, 2.0 * torch.tan(safe_w / 2.0), zero)
    one_over_2tan = torch.where(
        on, 1.0 / torch.where(two_tan == 0, one, two_tan), zero)
    cam = Camera(
        params=p, image_size=size, focal=focal, center=center,
        inv_focal=1.0 / focal, w=w, two_tan=two_tan,
        one_over_2tan=one_over_2tan, winv=torch.where(on, 1.0 / safe_w, zero),
        distortion_enabled=torch.where(on, one, zero),
        largest_radius=zero, max_r=zero + float("inf"), one_pixel_dist=zero,
        implane_tl=p.new_zeros(2), implane_br=p.new_ones(2),
        ufb_linear_focal=p.new_ones(2), ufb_linear_center=p.new_zeros(2))
    v2 = torch.stack([torch.maximum(p[2], 1.0 - p[2]) / p[0],
                      torch.maximum(p[3], 1.0 - p[3]) / p[1]])
    largest = _invrtrans(torch.linalg.vector_norm(v2), cam)
    cam.largest_radius = largest
    cam.max_r = 1.5 * largest
    c0 = unproject(size / 2.0, cam)
    c1 = unproject(size / 2.0 + 1.0, cam)
    cam.one_pixel_dist = torch.linalg.vector_norm(c0 - c1) / math.sqrt(2.0)
    # The UFB's linear bounds (src/ATANCamera.cc:77-103).
    # From device fills: a tensor of a Python list is a host-to-device
    # copy, which a CUDA graph cannot capture (``se3_from_se2`` makes a
    # camera inside the tracking program).
    x0, x1, y1 = (p.new_full((), v) for v in (-0.5, W - 0.5, H - 0.5))
    corners = unproject(torch.stack([
        torch.stack([x0, x0]), torch.stack([x1, x0]), torch.stack([x1, y1]),
        torch.stack([x0, y1])]), cam)
    cam.implane_tl = corners.min(0).values
    cam.implane_br = corners.max(0).values
    cam.ufb_linear_focal = 1.0 / (cam.implane_br - cam.implane_tl)
    cam.ufb_linear_center = -cam.implane_tl * cam.ufb_linear_focal
    return cam


def project(cam_xy: Tensor, cam: Camera) -> Tensor:
    """z=1-plane coords (..., 2) -> pixels (..., 2)."""
    r = torch.linalg.vector_norm(cam_xy, dim=-1)
    factor = _rtrans_factor(r, cam)
    return cam.center + cam.focal * (factor[..., None] * cam_xy)


def project_valid(cam_xy: Tensor, cam: Camera) -> Tensor:
    """Validity of a projection (the reference's r > mdMaxR check)."""
    return torch.linalg.vector_norm(cam_xy, dim=-1) <= cam.max_r


def unproject(pix: Tensor, cam: Camera) -> Tensor:
    """Pixels (..., 2) -> z=1-plane coords."""
    dist = (pix - cam.center) * cam.inv_focal
    dist_r = torch.linalg.vector_norm(dist, dim=-1)
    r = _invrtrans(dist_r, cam)
    factor = torch.where(
        dist_r > 0.01,
        r / torch.where(dist_r <= 0.01, torch.ones_like(dist_r), dist_r),
        torch.ones_like(dist_r))
    return factor[..., None] * dist


def project_derivs(cam_xy: Tensor, cam: Camera) -> Tensor:
    """d(pixel)/d(z=1 coords), (..., 2, 2)."""
    x, y = cam_xy[..., 0], cam_xy[..., 1]
    rn = torch.linalg.vector_norm(cam_xy, dim=-1)
    r = rn * cam.distortion_enabled
    factor = _rtrans_factor(rn, cam)
    k = cam.two_tan
    small = r < 0.01
    rr = torch.where(small, torch.ones_like(r), r * r)
    zero = torch.zeros_like(r)
    frac_dx = torch.where(small, zero,
                          cam.winv * (k * x) / (rr * (1 + k * k * rr))
                          - x * factor / rr)
    frac_dy = torch.where(small, zero,
                          cam.winv * (k * y) / (rr * (1 + k * k * rr))
                          - y * factor / rr)
    fx, fy = cam.focal[0], cam.focal[1]
    j00 = fx * (frac_dx * x + factor)
    j10 = fy * (frac_dx * y)
    j01 = fx * (frac_dy * x)
    j11 = fy * (frac_dy * y + factor)
    return torch.stack([torch.stack([j00, j01], dim=-1),
                        torch.stack([j10, j11], dim=-1)], dim=-2)


def project_points(pose, pts_w: Tensor, cam: Camera, image_size):
    """World points (..., 3) through the pose (an ``SE3``) and the camera:
    (p_cam, z=1 coords, pixels, in front and inside the camera's radius
    and the image)."""
    W, H = image_size
    p_cam = pts_w @ pose.R.T + pose.t
    z = p_cam[..., 2]
    z_ok = z > 0.001
    safe_z = torch.where(z_ok, z, 1.0)
    z1 = p_cam[..., :2] / safe_z[..., None]
    r_ok = torch.sum(z1 * z1, dim=-1) <= cam.largest_radius ** 2
    pix = project(z1, cam)
    in_im = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
             & (pix[..., 0] <= W) & (pix[..., 1] <= H))
    ok = z_ok & r_ok & in_im & project_valid(z1, cam)
    return p_cam, z1, pix, ok


def pose_jacobian(p_cam: Tensor, cam_derivs: Tensor) -> Tensor:
    """(N, 2, 6) d(pixel)/d(left-multiplied twist)."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    gen = se3lib.motion_jacobian(p_cam)                     # (N, 6, 3)
    plane = (gen[..., :2] - p_cam[..., None, :2]
             * gen[..., 2:] * inv_z[..., None, None]) * inv_z[..., None, None]
    return cam_derivs @ plane.transpose(-1, -2)


def param_derivs(cam_xy: Tensor, cam: Camera) -> Tensor:
    """d(pixel)/d(the 5 normalized params), (..., 2, 5), by forward
    differences of 1e-3 (ATANCamera::GetCameraParameterDerivs,
    src/ATANCamera.cc:211-237); the w column is zero when distortion is
    off, as the reference's. Reads the image size on the host."""
    size = tuple(int(v) for v in cam.image_size.tolist())
    dev = cam.params.device
    base = project(cam_xy, make_camera(cam.params, size, dev))
    eps = 1e-3
    cols = []
    for i in range(5):
        dp = cam.params.clone()
        dp[i] += eps
        cols.append((project(cam_xy, make_camera(dp, size, dev)) - base)
                    / eps)
    J = torch.stack(cols, dim=-1)
    J[..., 4] *= cam.distortion_enabled
    return J


def ufb_project(cam_xy: Tensor, cam: Camera) -> Tensor:
    """z=1-plane coords -> unit frame buffer coords
    (src/ATANCamera.cc:254-267)."""
    r = torch.linalg.vector_norm(cam_xy, dim=-1)
    dist = _rtrans_factor(r, cam)[..., None] * cam_xy
    return cam.params[2:4] + cam.params[:2] * dist


def ufb_unproject(ufb: Tensor, cam: Camera) -> Tensor:
    """Unit frame buffer coords -> z=1-plane coords
    (src/ATANCamera.cc:269-284)."""
    dist = (ufb - cam.params[2:4]) / cam.params[:2]
    dist_r = torch.linalg.vector_norm(dist, dim=-1)
    r = _invrtrans(dist_r, cam)
    factor = torch.where(
        dist_r > 0.01,
        r / torch.where(dist_r <= 0.01, torch.ones_like(dist_r), dist_r),
        torch.ones_like(dist_r))
    return factor[..., None] * dist


def ufb_linear_project(cam_xy: Tensor, cam: Camera) -> Tensor:
    """The undistorted UFB projection (ATANCamera.h's UFBLinear*)."""
    return cam_xy * cam.ufb_linear_focal + cam.ufb_linear_center


def ufb_linear_unproject(ufb: Tensor, cam: Camera) -> Tensor:
    return (ufb - cam.ufb_linear_center) / cam.ufb_linear_focal
