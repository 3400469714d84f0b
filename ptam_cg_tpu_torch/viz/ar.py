"""AR compositor: undistortion-mesh rendering and a 3D overlay, offline
(port of ``ptam_cg_tpu.viz.ar``).

ARDriver and EyeGame (src/ARDriver.cc:38-281, src/EyeGame.cc): the
reference uploads each frame to an OpenGL texture, renders it undistorted
through a distortion mesh into a frame buffer, draws 3D content with the
UFB linear frustum, then distorts the result back to the screen. Here the
three stages are tensor ops on the camera's device: (1) undistort through
the UFB mapping as one bilinear resample, (2) rasterize z-buffered
triangles over it, (3) distort back. The output is a frame for export,
not a window.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.ops import image as imops
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


def _grid(h: int, w: int, device):
    """(ys, xs), each (h, w) float32 pixel coordinates."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def _as_image(frame, device) -> Tensor:
    if not isinstance(frame, Tensor):
        frame = torch.from_numpy(np.asarray(frame, np.float32))
    return frame.to(device=device, dtype=torch.float32)


def undistort_frame(frame, cam: atan.Camera,
                    out_size: Tuple[int, int]) -> Tensor:
    """Distorted camera frame -> linear (UFB) image of ``out_size``
    (ARDriver::MakeFrameBuffer and the DrawDistortedFB mesh,
    src/ARDriver.cc:96-238): one inverse-map bilinear resample."""
    Wo, Ho = out_size
    frame = _as_image(frame, cam.params.device)
    ys, xs = _grid(Ho, Wo, frame.device)
    ufb = torch.stack([(xs + 0.5) / Wo, (ys + 0.5) / Ho], dim=-1)
    pix = atan.project(atan.ufb_linear_unproject(ufb, cam), cam)
    vals, valid = imops.bilinear_sample(frame, pix.reshape(-1, 2))
    return torch.where(valid, vals, 0.0).reshape(Ho, Wo)


def redistort_frame(linear: Tensor, cam: atan.Camera,
                    out_size: Tuple[int, int]) -> Tensor:
    """Linear (UFB) image -> distorted camera frame of ``out_size`` (the
    final re-distortion pass, src/ARDriver.cc:240-281)."""
    Wo, Ho = out_size
    Hl, Wl = linear.shape
    ys, xs = _grid(Ho, Wo, linear.device)
    implane = atan.unproject(torch.stack([xs, ys], dim=-1).reshape(-1, 2),
                             cam)
    ufb = atan.ufb_linear_project(implane, cam)
    src = torch.stack([ufb[:, 0] * Wl - 0.5, ufb[:, 1] * Hl - 0.5], dim=-1)
    vals, valid = imops.bilinear_sample(linear, src)
    return torch.where(valid, vals, 0.0).reshape(Ho, Wo)


def _raster_triangles(img: Tensor, verts2: Tensor, depth: Tensor,
                      tris: np.ndarray, shade: np.ndarray) -> Tensor:
    """A small z-buffered triangle rasterizer over an intensity image:
    ``verts2`` (V, 2) screen coordinates, ``depth`` (V,), ``tris`` (T, 3)
    vertex indices, ``shade`` (T,) a triangle's intensity. Each triangle
    is tested at every pixel by its barycentric weights, in order; a
    pixel takes a triangle nearer than what it holds."""
    H, W = img.shape
    ys, xs = _grid(H, W, img.device)
    zbuf = torch.full((H, W), float("inf"), device=img.device)
    out = img
    for t, sh in zip(np.asarray(tris), np.asarray(shade, np.float32)):
        a, b, c = verts2[int(t[0])], verts2[int(t[1])], verts2[int(t[2])]
        za, zb, zc = depth[int(t[0])], depth[int(t[1])], depth[int(t[2])]
        d = ((b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1]))
        d = torch.where(torch.abs(d) < 1e-9, 1e-9, d)
        w0 = ((b[1] - c[1]) * (xs - c[0]) + (c[0] - b[0]) * (ys - c[1])) / d
        w1 = ((c[1] - a[1]) * (xs - c[0]) + (a[0] - c[0]) * (ys - c[1])) / d
        w2 = 1.0 - w0 - w1
        z = w0 * za + w1 * zb + w2 * zc
        win = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > 0.01) & (z < zbuf)
        out = torch.where(win, float(sh), out)
        zbuf = torch.where(win, z, zbuf)
    return out


def make_cube(size: float = 0.05, center=(0.0, 0.0, 0.0), device="cuda"):
    """Demo AR content on the z=0 plane (EyeGame's stand-in): a cube.
    Returns (verts (8, 3) on ``device``, tris (12, 3), shades (12,)), the
    last two numpy."""
    s = size / 2
    cx, cy, cz = center
    verts = np.array([[x, y, z] for z in (cz, cz - size)
                      for y in (cy - s, cy + s)
                      for x in (cx - s, cx + s)], np.float32)
    tris = np.array([
        [0, 1, 2], [1, 3, 2],        # bottom (on the plane)
        [4, 6, 5], [5, 6, 7],        # top
        [0, 4, 1], [1, 4, 5],
        [2, 3, 6], [3, 7, 6],
        [0, 2, 4], [2, 6, 4],
        [1, 5, 3], [3, 7, 5],
    ], np.int32)
    shades = np.array([140, 140, 250, 250, 180, 180, 200, 200, 160,
                       160, 220, 220], np.float32)
    return torch.from_numpy(verts).to(device), tris, shades


def _unit_octahedron():
    """(6, 3) vertices and (8, 3) triangles of a unit octahedron, the
    low-poly sphere of an eyeball."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
    tris = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                     [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return verts, tris


def make_eye_game(cam_center_w: Tensor, spacing: float = 0.1,
                  radius: float = 0.04):
    """EyeGame's content (src/EyeGame.cc:15-241): four eyeballs on the z=0
    plane, each with a pupil turned towards the camera centre
    ``cam_center_w`` (3,). Returns (verts (V, 3) on its device, tris
    (T, 3), shades (T,)); only the vertices depend on the camera."""
    dev = cam_center_w.device
    overts, otris = _unit_octahedron()
    overts_t = torch.from_numpy(overts).to(dev)
    z_up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    all_verts, all_tris, all_shades = [], [], []
    n_v = 0
    for ex in (-spacing, spacing):
        for ey in (-spacing, spacing):
            center = torch.tensor([ex, ey, -radius], dtype=torch.float32,
                                  device=dev)
            all_verts.append(center + radius * overts_t)
            all_tris.append(otris + n_v)
            all_shades.append(np.full(len(otris), 235.0, np.float32))
            n_v += len(overts)
            # The pupil: a small disc on the sphere facing the camera
            # (the eyes follow you, EyeGame.cc:150+).
            d = cam_center_w - center
            d = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-9)
            up = torch.where(torch.abs(d[2]) < 0.9, z_up, x_axis)
            u = torch.linalg.cross(d, up)
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-9)
            v = torch.linalg.cross(d, u)
            pc = center + d * radius * 1.02
            pr = 0.35 * radius
            ring = torch.stack([pc + pr * (float(np.cos(a)) * u
                                           + float(np.sin(a)) * v)
                                for a in np.linspace(0, 2 * np.pi, 7)[:6]])
            all_verts.append(torch.cat([pc[None], ring]))
            fan = np.array([[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)],
                           np.int32)
            all_tris.append(fan + n_v)
            all_shades.append(np.full(6, 15.0, np.float32))
            n_v += 7
    return (torch.cat(all_verts), np.concatenate(all_tris),
            np.concatenate(all_shades))


def render_ar_frame(frame, pose: SE3, cam: atan.Camera,
                    image_size: Tuple[int, int], verts: Tensor, tris,
                    shades, ufb_size: Tuple[int, int] = (640, 480)) -> Tensor:
    """The AR pipeline for one frame (ARDriver::Render,
    src/ARDriver.cc:60-92): undistort, draw the 3D content, distort
    back. Returns the (H, W) float32 composite on the camera's device."""
    linear = undistort_frame(frame, cam, ufb_size)
    Wl, Hl = ufb_size
    p_cam = verts @ pose.R.T + pose.t
    z = torch.clamp(p_cam[:, 2], min=1e-3)
    ufb = atan.ufb_linear_project(p_cam[:, :2] / z[:, None], cam)
    verts2 = torch.stack([ufb[:, 0] * Wl - 0.5, ufb[:, 1] * Hl - 0.5], -1)
    linear = _raster_triangles(linear, verts2, z, tris, shades)
    return redistort_frame(linear, cam, image_size)
