"""Offline map visualization (port of ``ptam_cg_tpu.viz.mapviewer``).

The reference's MapViewer (src/MapViewer.cc:19-226: grid, points coloured
by level, keyframes) as headless renders: numpy draws the map into an RGB
array that can be saved as a PPM (no dependency) or returned to a
notebook. A map's tensors are read on the host once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.utils.se3 import SE3

#: Per-level point colours (Level::mvLevelColors, src/KeyFrame.cc:84-90).
LEVEL_COLORS = np.array([
    [1.0, 0.0, 0.0],
    [1.0, 1.0, 0.0],
    [0.0, 1.0, 0.0],
    [0.0, 0.0, 0.7],
], np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _world_to_canvas(pts: np.ndarray, center, scale, size):
    x = (pts[:, 0] - center[0]) * scale + size[0] / 2
    y = (pts[:, 1] - center[1]) * scale + size[1] / 2
    return np.stack([x, y], -1)


def render_topdown(m: MapState, size: Tuple[int, int] = (800, 800),
                   trajectory: Optional[np.ndarray] = None,
                   grid_step: float = 0.1) -> np.ndarray:
    """Top-down (x-y plane) render: grid lines, map points colored by
    source level, keyframe positions, optional trajectory polyline.
    Returns (H, W, 3) uint8."""
    W, H = size
    img = np.full((H, W, 3), 25, np.uint8)
    valid = _np(m.point_valid)
    pts = _np(m.point_pos)[valid]
    lvl = _np(m.point_src_level)[valid]
    kf_valid = _np(m.kf_valid)
    centers = -np.einsum("kji,kj->ki", _np(m.kf_R), _np(m.kf_t))[kf_valid]

    all_xy = np.concatenate(
        [pts[:, :2] if len(pts) else np.zeros((0, 2)),
         centers[:, :2] if len(centers) else np.zeros((0, 2))])
    if len(all_xy) == 0:
        return img
    lo = all_xy.min(0)
    hi = all_xy.max(0)
    center = (lo + hi) / 2
    span = max(float((hi - lo).max()), 1e-3)
    scale = 0.85 * min(W, H) / span

    # Grid lines every grid_step world units (DrawGrid).
    def draw_px(canvas, xy, color, radius=1):
        xi = np.round(xy[:, 0]).astype(int)
        yi = np.round(xy[:, 1]).astype(int)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                xs = np.clip(xi + dx, 0, W - 1)
                ys = np.clip(yi + dy, 0, H - 1)
                canvas[ys, xs] = color

    n_lines = int(span / grid_step) + 2
    g0 = np.floor(lo / grid_step) * grid_step
    for i in range(n_lines):
        v = g0[0] + i * grid_step
        x = int(round((v - center[0]) * scale + W / 2))
        if 0 <= x < W:
            img[:, x] = (45, 45, 45)
        v = g0[1] + i * grid_step
        y = int(round((v - center[1]) * scale + H / 2))
        if 0 <= y < H:
            img[y, :] = (45, 45, 45)

    for level in range(4):
        sel = lvl == level
        if sel.any():
            xy = _world_to_canvas(pts[sel], center, scale, (W, H))
            draw_px(img, xy, (LEVEL_COLORS[level] * 255).astype(np.uint8))

    if trajectory is not None and len(trajectory):
        xy = _world_to_canvas(np.asarray(trajectory), center, scale,
                              (W, H))
        draw_px(img, xy, np.array([200, 200, 255], np.uint8), 0)

    if len(centers):
        xy = _world_to_canvas(centers, center, scale, (W, H))
        draw_px(img, xy, np.array([255, 255, 255], np.uint8), 2)
    return img


def project_points_into_frame(m: MapState, pose: SE3, cam: atan.Camera,
                              image_size):
    """Per-frame overlay data (the reference draws tracked dots coloured
    by level, src/Tracker.cc:646-660): returns numpy (pix (N, 2), level
    (N,), visible mask)."""
    W, H = image_size
    p_cam = _np(m.point_pos) @ _np(pose.R).T + _np(pose.t)
    z = p_cam[:, 2]
    ok = (z > 1e-3) & _np(m.point_valid)
    z1 = p_cam[:, :2] / np.where(ok, z, 1.0)[:, None]
    pix = _np(atan.project(torch.from_numpy(z1.astype(np.float32)).to(
        cam.params.device), cam))
    ok &= ((pix[:, 0] >= 0) & (pix[:, 1] >= 0)
           & (pix[:, 0] < W) & (pix[:, 1] < H))
    return pix, _np(m.point_src_level), ok


def overlay_tracked_points(frame: np.ndarray, pix, levels, mask
                           ) -> np.ndarray:
    """Draw tracked-point dots on a grayscale frame -> RGB uint8."""
    if isinstance(frame, torch.Tensor):
        frame = _np(frame)
    img = np.stack([np.asarray(frame)] * 3, -1).astype(np.uint8)
    H, W = img.shape[:2]
    for level in range(4):
        sel = mask & (levels == level)
        if not sel.any():
            continue
        xi = np.clip(np.round(pix[sel, 0]).astype(int), 1, W - 2)
        yi = np.clip(np.round(pix[sel, 1]).astype(int), 1, H - 2)
        c = (LEVEL_COLORS[level] * 255).astype(np.uint8)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                img[yi + dy, xi + dx] = c
    return img


def save_ppm(path: str, img: np.ndarray) -> None:
    """Dependency-free image writer (binary PPM)."""
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(img.tobytes())
