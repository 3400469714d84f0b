"""Checkerboard camera calibration, the reference's second executable
(port of ``ptam_cg_tpu.camera.calibrator``; CameraCalibrator, CalibImage
and CalibCornerPatch, src/CameraCalibrator.cc, src/CalibImage.cc,
src/CalibCornerPatch.cc).

- ``find_calib_corners``: the ring-transition checkerboard-corner test
  on a blurred image (IsCorner, src/CalibImage.cc:30-71) at every pixel
  at once
- ``make_corner_refiner``: the 6-DoF (position, two angles, mean, gain)
  corner-patch fit (src/CalibCornerPatch.cc:106-177) as a batched
  Gauss-Newton loop of fixed length. The blurred corner is the JAX
  package's analytic model (a product of Gaussian CDFs in warped
  coordinates). JAX takes the Jacobian with ``jacfwd`` under ``vmap``;
  here it is written out (the bilinear sample's gradient, the model's
  derivatives by the two angles) and batched over the corners
  (``torch.func.jacfwd`` under ``vmap`` took about ten times as long a
  corner on the CPU)
- ``guess_initial_angles``, and the grid growth of ``CalibImage``
  (MakeFromImage / ExpandByAngle / ExpandByStep, src/CalibImage.cc:
  123-436): a host loop around the refiner, as in the JAX package
- ``CalibImage.guess_initial_pose``: the grid -> image-plane DLT with
  the conditioning fix and Gram-Schmidt (src/CalibImage.cc:514-606),
  float64 numpy on the host as in the JAX package
- ``CameraCalibrator``: Gauss-Newton over the N view poses and the 5
  ATAN parameters with the identity prior and 0.1 step damping
  (OptimizeOneStep, src/CameraCalibrator.cc:215-269); target RMS < 0.3 px

Images and solves live on ``device`` (the card unless the caller asks for
the CPU); the grid growth and the joint solve's assembly read the device
on the host, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.ops import fast as fastops
from ptam_cg_tpu_torch.ops import image as imops
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Corner candidates (the ring-transition test)
# ---------------------------------------------------------------------------

def find_calib_corners(im: Tensor, gate: float = 10.0,
                       blur_sigma: float = 1.0,
                       max_corners: int = 2048) -> fastops.Corners:
    """IsCorner at every pixel (src/CalibImage.cc:30-71, blur at
    :135-141): the centre within ``gate`` of the 16-ring's mean, and the
    ring making exactly 4 hysteresis transitions; scored by
    |centre - mean| so an overflow keeps the crisp corners."""
    imb = imops.gaussian_blur(im.to(torch.float32), blur_sigma)
    ring = torch.stack([torch.roll(imb, (-dy, -dx), dims=(0, 1))
                        for dx, dy in fastops.CIRCLE])    # (16, H, W)
    mean = torch.mean(ring, dim=0)
    hi = mean + gate
    lo = mean - gate
    center_ok = (imb > lo) & (imb < hi)
    state = ring[15] > mean
    swaps = torch.zeros_like(mean)
    for i in range(16):
        go_low = state & (ring[i] < lo)
        go_high = ~state & (ring[i] > hi)
        swaps = swaps + (go_low | go_high).to(torch.float32)
        state = torch.where(go_low, False, torch.where(go_high, True, state))
    H, W = im.shape
    border = torch.zeros((H, W), dtype=torch.bool, device=im.device)
    border[5:-5, 5:-5] = True
    is_corner = center_ok & (swaps == 4) & border
    return fastops.corners_from_mask(is_corner, torch.abs(imb - mean),
                                     max_corners)


# ---------------------------------------------------------------------------
# The 6-DoF corner-patch fit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CornerParams:
    """CalibCornerPatch::Params: position, the two axis angles, mean and
    gain."""
    pos: np.ndarray
    angles: np.ndarray
    mean: float = 120.0
    gain: float = 80.0


def _axes_inverse(angles: Tensor):
    """The inverse of the axis matrix [[cos a0, cos a1], [sin a0, sin a1]]
    of each row of ``angles`` (..., 2), and its derivatives by a0 and by
    a1: three (..., 2, 2). The determinant sin(a1 - a0) is held at least
    1e-6 from zero (its derivative is then zero)."""
    c0, s0 = torch.cos(angles[..., 0]), torch.sin(angles[..., 0])
    c1, s1 = torch.cos(angles[..., 1]), torch.sin(angles[..., 1])
    det = c0 * s1 - c1 * s0
    small = torch.abs(det) < 1e-6
    det = torch.where(small, torch.where(det < 0, -1e-6, 1e-6), det)
    zero = torch.zeros_like(det)

    def mat(a, b, c, d):
        return torch.stack([torch.stack([a, b], -1),
                            torch.stack([c, d], -1)], -2)

    N = mat(s1, -c1, -s0, c0)
    Winv = N / det[..., None, None]
    ddet0 = torch.where(small, 0.0, -s0 * s1 - c1 * c0)
    ddet1 = torch.where(small, 0.0, c0 * c1 + s1 * s0)
    d0 = (mat(zero, zero, -c0, -s0) - Winv * ddet0[..., None, None]) \
        / det[..., None, None]
    d1 = (mat(c1, s1, zero, zero) - Winv * ddet1[..., None, None]) \
        / det[..., None, None]
    return Winv, d0, d1


def _template_model(offsets: Tensor, angles: Tensor, blur: float = 1.0,
                    derivs: bool = False):
    """The blurred checkerboard corner in [0, 1] at the patch ``offsets``
    (Q, 2) for each row of axis angles ``angles`` (..., 2): a closed form
    of the reference's rasterized, warped and blurred template, (..., Q).
    With ``derivs`` also its derivatives by a0 and a1."""
    Winv, d0, d1 = _axes_inverse(angles)
    uv = offsets @ Winv.transpose(-1, -2)                 # (..., Q, 2)
    k = 1.0 / (blur * math.sqrt(2.0))
    g = 0.5 * (1.0 + torch.erf(uv * k))
    m = g[..., 0] * g[..., 1] + (1 - g[..., 0]) * (1 - g[..., 1])
    if not derivs:
        return m
    dg = k / math.sqrt(math.pi) * torch.exp(-(uv * k) ** 2)
    dm_duv = torch.stack([dg[..., 0] * (2 * g[..., 1] - 1),
                          dg[..., 1] * (2 * g[..., 0] - 1)], -1)
    dm0 = torch.sum(dm_duv * (offsets @ d0.transpose(-1, -2)), -1)
    dm1 = torch.sum(dm_duv * (offsets @ d1.transpose(-1, -2)), -1)
    return m, dm0, dm1


def _bilinear_with_gradient(im: Tensor, xy: Tensor):
    """``ops.image.bilinear_sample`` (pad 0) and its derivatives by x and
    by y (zero where a sample's support leaves the image)."""
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
    dx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    dy = bot - top
    return (torch.where(valid, vals, 0.0), torch.where(valid, dx, 0.0),
            torch.where(valid, dy, 0.0))


def make_corner_refiner(im_shape: Tuple[int, int], patch_size: int = 20,
                        iterations: int = 30, model_blur: float = 1.0,
                        device="cuda"):
    """A batched corner-patch Gauss-Newton fit over one image:
    refine(im, pos0 (N, 2), angles0 (N, 2), mean0 (N,), gain0 (N,)) ->
    (pos, angles, mean, gain, ok). ``iterations`` steps of 0.7 times the
    Gauss-Newton update (the Jacobian analytic: the JAX package's
    ``jacfwd`` of the same residuals), then the reference's gates
    (src/CalibCornerPatch.cc:106-130): the last position step under 1e-2,
    the axes at least 30 degrees apart, |gain| > 20, mean |residual| < 25,
    the patch inside the image. Nothing is read on the host; on the card
    each batch size's fit is captured once as a CUDA graph."""
    half = (patch_size - 1) / 2.0
    ys, xs = np.mgrid[0:patch_size, 0:patch_size]
    offsets = torch.from_numpy(np.stack([xs - half, ys - half], -1).reshape(
        -1, 2).astype(np.float32)).to(device)
    H, W = im_shape
    eye6 = torch.eye(6, device=device)

    def residuals(theta, im, jac: bool):
        """(N, Q) residuals of (N, 6) parameters, and with ``jac`` their
        (N, Q, 6) Jacobian."""
        pts = theta[:, None, :2] + offsets
        mean, gain = theta[:, 4:5], theta[:, 5:6]
        if not jac:
            vals, _ = imops.bilinear_sample(im, pts)
            return vals - (gain * _template_model(offsets, theta[:, 2:4],
                                                  model_blur) + mean)
        vals, dx, dy = _bilinear_with_gradient(im, pts)
        m, dm0, dm1 = _template_model(offsets, theta[:, 2:4], model_blur,
                                      derivs=True)
        r = vals - (gain * m + mean)
        J = torch.stack([dx, dy, -gain * dm0, -gain * dm1,
                         -torch.ones_like(m), -m], dim=-1)
        return r, J

    def fit(im, theta):
        last_step = torch.ones(theta.shape[0], device=theta.device)
        for _ in range(iterations):
            r, J = residuals(theta, im, True)
            Jt = J.transpose(1, 2)
            # solve_ex: no error check, so no host read (a singular
            # system gives inf/NaN, as JAX's solve does).
            upd = -0.7 * torch.linalg.solve_ex(
                Jt @ J + 1e-6 * eye6, Jt @ r[..., None],
                check_errors=False)[0][..., 0]
            theta = theta + upd
            last_step = torch.linalg.vector_norm(upd[:, :2], dim=-1)
        err = torch.mean(torch.abs(residuals(theta, im, False)), dim=-1)
        pos, angles, mean, gain = (theta[:, :2], theta[:, 2:4], theta[:, 4],
                                   theta[:, 5])
        in_im = ((pos[:, 0] > half) & (pos[:, 1] > half)
                 & (pos[:, 0] < W - half - 1) & (pos[:, 1] < H - half - 1))
        ok = (in_im & (last_step < 1e-2)
              & (torch.abs(torch.sin(angles[:, 0] - angles[:, 1]))
                 >= math.sin(math.pi / 6.0))
              & (torch.abs(gain) > 20.0) & (err < 25.0))
        return pos, angles, mean, gain, ok

    fits = {}       # batch size -> graphs.Graph

    def refine(im, pos0, angles0, mean0, gain0):
        theta = torch.cat([pos0, angles0, mean0[:, None], gain0[:, None]],
                          dim=1).to(torch.float32)        # (N, 6)
        if not theta.is_cuda:
            return fit(im, theta)
        # On the card a fit is one CUDA graph of its ~3,600 small kernels
        # (JAX's jitted fit is one program too), captured at the first
        # call of each batch size and replayed on copies of the inputs.
        n = theta.shape[0]
        if n not in fits:
            fits[n] = graphs.Graph(fit, (im.clone(), theta.clone()))
        graph = fits[n]
        for buf, x in zip(graph.inputs, (im, theta)):
            graphs.fill(buf, x)
        return tuple(o.clone() for o in graph.replay())

    return refine


def guess_initial_angles(im: Tensor, pos: Tensor) -> Tensor:
    """The two axis angles from the strongest gradient direction
    (GuessInitialAngles, src/CalibImage.cc:83-121), (2,)."""
    dev = im.device
    angles = torch.arange(0.0, math.pi, 0.1, dtype=torch.float64).to(
        torch.float32).to(dev)
    d = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
    p = torch.stack([d[:, 1], -d[:, 0]], -1)
    pos = pos.to(device=dev, dtype=torch.float32)
    pts = torch.stack([pos + d * 3.0 + p * 0.1, pos + d * 3.0 - p * 0.1,
                       pos - d * 3.0 - p * 0.1, pos - d * 3.0 + p * 0.1])
    v, _ = imops.bilinear_sample(im, pts.reshape(-1, 2))
    v = v.reshape(4, -1)
    g = v[0] - v[1] + v[2] - v[3]
    best = torch.argmax(torch.abs(g))
    a = angles[best]
    return torch.where(g[best] < 0, torch.stack([a, a + math.pi / 2]),
                       torch.stack([a - math.pi / 2, a]))


# ---------------------------------------------------------------------------
# Grid growth (a host loop)
# ---------------------------------------------------------------------------

N_NOT_TRIED, N_FAILED = -1, -2

_DIRS = [(1, 0), (0, 1), (-1, 0), (0, -1)]


@dataclasses.dataclass
class GridCorner:
    params: CornerParams
    grid_pos: Tuple[int, int] = (0, 0)
    neighbors: Optional[list] = None
    inherited_steps: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.neighbors is None:
            self.neighbors = [N_NOT_TRIED] * 4

    def warp(self) -> np.ndarray:
        a = self.params.angles
        return np.array([[np.cos(a[0]), np.cos(a[1])],
                         [np.sin(a[0]), np.sin(a[1])]])

    def expansion_potential(self) -> float:
        missing = sum(1 for v in self.neighbors if v == N_NOT_TRIED)
        if missing == 0:
            return 0.0
        if missing == 1:
            return 100.0
        if missing == 3:
            return 1.0
        first = next(i for i, v in enumerate(self.neighbors)
                     if v == N_NOT_TRIED)
        return 10.0 if self.neighbors[(first + 2) % 4] == N_NOT_TRIED \
            else 20.0

    def get_steps(self, corners: list) -> np.ndarray:
        steps = np.zeros((2, 2))
        for dirn in range(2):
            acc = np.zeros(2)
            found = 0
            if self.neighbors[dirn] >= 0:
                acc += (corners[self.neighbors[dirn]].params.pos
                        - self.params.pos)
                found += 1
            if self.neighbors[dirn + 2] >= 0:
                acc -= (corners[self.neighbors[dirn + 2]].params.pos
                        - self.params.pos)
                found += 1
            steps[dirn] = (self.inherited_steps[dirn] if found == 0
                           else acc / found)
        return steps


class CalibImage:
    """One calibration view (CalibImage): its corner candidates, the grid
    grown over them and the view's pose."""

    def __init__(self, im, gate: float = 10.0, min_corners: int = 20,
                 max_step_frac: float = 0.3, device="cuda"):
        if not isinstance(im, Tensor):
            im = torch.from_numpy(np.array(im, np.float32))
        self.im = im.to(device=device, dtype=torch.float32)
        self.pose = se3lib.identity(self.im.device)
        self.grid: List[GridCorner] = []
        self._refine = make_corner_refiner(tuple(self.im.shape),
                                           device=self.im.device)
        c = find_calib_corners(self.im, gate)
        n = int(c.count)
        self.corners = c.xy[:n].cpu().numpy().astype(np.float64)
        self.ok = n >= min_corners
        self.max_step_frac = max_step_frac

    def _refine_corner(self, params: CornerParams):
        dev = self.im.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        pos, ang, mean, gain, ok = self._refine(
            self.im, t(params.pos)[None], t(params.angles)[None],
            t([params.mean]), t([params.gain]))
        vals = torch.cat([pos[0], ang[0], mean[:1], gain[:1],
                          ok[:1].to(torch.float32)]).cpu().numpy()
        return (CornerParams(vals[:2].astype(np.float64),
                             vals[2:4].astype(np.float64), float(vals[4]),
                             float(vals[5])), bool(vals[6]))

    def make_grid(self) -> bool:
        """MakeFromImage (src/CalibImage.cc:123-214)."""
        if not self.ok:
            return False
        center = np.array(self.im.shape[::-1]) / 2.0
        d2 = np.sum((self.corners - center) ** 2, -1)
        start = self.corners[int(np.argmin(d2))]
        angles = guess_initial_angles(
            self.im, torch.as_tensor(start)).cpu().numpy().astype(np.float64)
        p0, ok = self._refine_corner(CornerParams(start.copy(),
                                                  angles.copy()))
        if not ok:
            return False
        self.grid = [GridCorner(p0)]
        if not (self._expand_by_angle(0, 0) or self._expand_by_angle(0, 2)):
            return False
        if not (self._expand_by_angle(0, 1) or self._expand_by_angle(0, 3)):
            return False
        steps = self.grid[0].get_steps(self.grid)
        self.grid[1].inherited_steps = steps.copy()
        self.grid[2].inherited_steps = steps.copy()
        for _ in range(500):
            nxt = self._next_to_expand()
            if nxt < 0:
                break
            self._expand_by_step(nxt)
        return len(self.grid) >= 4

    def _expand_by_angle(self, src: int, dirn: int) -> bool:
        g = self.grid[src]
        target_dirn = g.warp()[:, dirn % 2] * (1 if dirn < 2 else -1)
        diff = self.corners - g.params.pos
        d2 = np.sum(diff * diff, -1)
        with np.errstate(invalid="ignore", divide="ignore"):
            dirs = diff / np.sqrt(d2)[:, None]
        cosang = dirs @ target_dirn
        okm = (d2 >= 100) & (cosang >= np.cos(np.pi / 18))
        if not okm.any():
            g.neighbors[dirn] = N_FAILED
            return False
        best = self.corners[int(np.argmin(np.where(okm, d2, np.inf)))]
        refined, ok = self._refine_corner(CornerParams(
            best.copy(), g.params.angles.copy(), g.params.mean,
            -g.params.gain))
        if not ok:
            g.neighbors[dirn] = N_FAILED
            return False
        gp = list(g.grid_pos)
        gp[dirn % 2] += 1 if dirn < 2 else -1
        nc = GridCorner(refined, tuple(gp))
        nc.neighbors[(dirn + 2) % 4] = src
        self.grid.append(nc)
        g.neighbors[dirn] = len(self.grid) - 1
        return True

    def _next_to_expand(self) -> int:
        best, bd = -1, 0.0
        for i, g in enumerate(self.grid):
            d = g.expansion_potential()
            if d > bd:
                best, bd = i, d
        return best

    def _expand_by_step(self, n: int):
        """ExpandByStep (src/CalibImage.cc:363-436)."""
        g = self.grid[n]
        dirn = next((i for i in range(4)
                     if g.neighbors[i] == N_NOT_TRIED
                     and g.neighbors[(i + 2) % 4] >= 0), None)
        if dirn is None:
            dirn = next(i for i in range(4) if g.neighbors[i] == N_NOT_TRIED)
        step_ir = np.array(_DIRS[dirn])
        step = g.get_steps(self.grid).T @ step_ir
        search = g.params.pos + step
        g.neighbors[dirn] = N_FAILED
        d2 = np.sum((self.corners - search) ** 2, -1)
        best = int(np.argmin(d2))
        if np.sqrt(d2[best]) > self.max_step_frac * np.linalg.norm(step):
            return
        refined, ok = self._refine_corner(CornerParams(
            self.corners[best].copy(), g.params.angles.copy(),
            g.params.mean, -g.params.gain))
        if not ok:
            return
        nc = GridCorner(refined, (g.grid_pos[0] + step_ir[0],
                                  g.grid_pos[1] + step_ir[1]))
        nc.inherited_steps = g.get_steps(self.grid)
        idx = len(self.grid)
        for d in range(4):
            want = (nc.grid_pos[0] + _DIRS[d][0], nc.grid_pos[1] + _DIRS[d][1])
            for i, other in enumerate(self.grid):
                if tuple(other.grid_pos) == want:
                    nc.neighbors[d] = i
                    other.neighbors[(d + 2) % 4] = idx
        self.grid.append(nc)

    # -- the pose's start and the reprojection terms -----------------------
    def guess_initial_pose(self, cam: atan.Camera):
        """GuessInitialPose (src/CalibImage.cc:514-606)."""
        pts = np.array([g.grid_pos for g in self.grid], np.float64)
        pix = torch.as_tensor(np.array([g.params.pos for g in self.grid],
                                       np.float32), device=self.im.device)
        unproj = atan.unproject(pix, cam).cpu().numpy().astype(np.float64)
        rows = []
        for (x, y), (u, v) in zip(pts, unproj):
            rows.append([x, y, 1, 0, 0, 0, -x * u, -y * u, -u])
            rows.append([0, 0, 0, x, y, 1, -x * v, -y * v, -v])
        _, _, Vt = np.linalg.svd(np.array(rows))
        Hm = Vt[-1].reshape(3, 3)
        # The conditioning fix on the top-left 2x2 (:560-580).
        _, D2, Vt2 = np.linalg.svd(Hm[:2, :2])
        Hm = Hm / D2[0]
        lam2 = D2[1] / D2[0]
        v2aprime = np.array([0.0, np.sqrt(max(1.0 - lam2 * lam2, 0.0))]) @ Vt2
        Hm[2, :2] = v2aprime if Hm[2, :2] @ v2aprime > 0 else -v2aprime
        # Gram-Schmidt -> rotation and translation (:585-605).
        Hm = Hm / np.linalg.norm(Hm[:, 0])
        r0 = Hm[:, 0]
        r1 = Hm[:, 1] - r0 * (r0 @ Hm[:, 1])
        r1 /= np.linalg.norm(r1)
        R = np.stack([r0, r1, np.cross(r0, r1)], axis=1)
        dev = self.im.device
        self.pose = SE3(torch.as_tensor(R, dtype=torch.float32, device=dev),
                        torch.as_tensor(Hm[:, 2], dtype=torch.float32,
                                        device=dev))

    def reprojection_data(self):
        """The grid corners: (world points (G, 3) on z=0, measured pixels
        (G, 2)), on the image's device."""
        dev = self.im.device
        pts = np.array([[g.grid_pos[0], g.grid_pos[1], 0.0]
                        for g in self.grid], np.float32)
        pix = np.array([g.params.pos for g in self.grid], np.float32)
        return (torch.as_tensor(pts, device=dev),
                torch.as_tensor(pix, device=dev))


# ---------------------------------------------------------------------------
# The joint optimization (the poses and the camera parameters)
# ---------------------------------------------------------------------------

def _view_terms(pose: SE3, pts_w: Tensor, pix_meas: Tensor,
                cam: atan.Camera):
    """One view's errors (G, 2), pose Jacobian (G, 2, 6) and camera-
    parameter Jacobian (G, 2, 5), zero where a corner does not project,
    and that mask (CalibImage::Project, src/CalibImage.cc:608-648)."""
    p_cam = pts_w @ pose.R.T + pose.t
    z = p_cam[:, 2]
    ok = z > 0.001
    zs = torch.where(ok, z, 1.0)
    z1 = p_cam[:, :2] / zs[:, None]
    pix = atan.project(z1, cam)
    ok = ok & atan.project_valid(z1, cam)
    err = pix_meas - pix
    derivs = atan.project_derivs(z1, cam)
    inv_z = (1.0 / zs)[:, None, None]
    gen = se3lib.motion_jacobian(p_cam)
    plane = (gen[..., :2] - p_cam[:, None, :2] * gen[..., 2:] * inv_z) * inv_z
    Jpose = torch.einsum("nij,nmj->nim", derivs, plane)
    Jcam = atan.param_derivs(z1, cam)
    w = ok.to(torch.float32)
    return (err * w[:, None], Jpose * w[:, None, None],
            Jcam * w[:, None, None], ok)


class CameraCalibrator:
    """Gauss-Newton over the N view poses and the 5 camera parameters
    (CameraCalibrator::OptimizeOneStep, src/CameraCalibrator.cc:215-269):
    the identity prior and 0.1 step damping. The normal equations are
    assembled and solved in float64 on the host, as in the JAX package;
    the views' terms come from ``device``."""

    def __init__(self, image_size, init_params=(0.5, 0.75, 0.5, 0.5, 0.1),
                 device="cuda"):
        self.image_size = image_size
        self.params = np.array(init_params, np.float64)
        self.views: List[CalibImage] = []
        self.device = torch.device(device)

    def _camera(self) -> atan.Camera:
        return atan.make_camera(tuple(float(p) for p in self.params),
                                self.image_size, self.device)

    def add_image(self, im, gate: float = 10.0) -> bool:
        """Grow a grid in ``im``; a view with one joins with its pose's
        start. Returns whether it joined."""
        view = CalibImage(im, gate, device=self.device)
        if not view.make_grid():
            return False
        view.guess_initial_pose(self._camera())
        self.views.append(view)
        return True

    def optimize_step(self) -> float:
        """One damped step; returns the RMS reprojection error (px) before
        it."""
        cam = self._camera()
        nv = len(self.views)
        dim = 6 * nv + 5
        JTJ = np.eye(dim)
        JTe = np.zeros(dim)
        sq_sum, n_meas = 0.0, 0
        for n, view in enumerate(self.views):
            pts, pix = view.reprojection_data()
            err, Jp, Jc, ok = _view_terms(view.pose, pts, pix, cam)
            err, Jp, Jc = (x.cpu().numpy().astype(np.float64)
                           for x in (err, Jp, Jc))
            base = 6 * n
            JTJ[base:base + 6, base:base + 6] += np.einsum(
                "nia,nib->ab", Jp, Jp)
            JTJ[-5:, -5:] += np.einsum("nia,nib->ab", Jc, Jc)
            cross = np.einsum("nia,nib->ab", Jp, Jc)
            JTJ[base:base + 6, -5:] += cross
            JTJ[-5:, base:base + 6] += cross.T
            JTe[base:base + 6] += np.einsum("nia,ni->a", Jp, err)
            JTe[-5:] += np.einsum("nia,ni->a", Jc, err)
            sq_sum += float(np.sum(err * err))
            n_meas += int(ok.sum())
        upd = 0.1 * np.linalg.lstsq(JTJ, JTe, rcond=None)[0]
        for n, view in enumerate(self.views):
            d = se3lib.se3_exp(torch.as_tensor(
                upd[6 * n:6 * n + 6], dtype=torch.float32,
                device=self.device))
            view.pose = se3lib.mul(d, view.pose)
        self.params = self.params + upd[-5:]
        return float(np.sqrt(sq_sum / max(n_meas, 1)))

    def optimize(self, iterations: int = 30) -> float:
        rms = np.inf
        for _ in range(iterations):
            rms = self.optimize_step()
        return rms
