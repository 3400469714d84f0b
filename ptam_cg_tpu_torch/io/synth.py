"""Synthetic scenes with ground-truth poses (port of
``ptam_cg_tpu.io.synth``): the textured plane, raised blocks with
occlusion, orbit and loop trajectories, motion blur, a rolling shutter,
photometric hostility and the calibrator's checkerboard; plus two
one-keyframe maps of the scene: ``planar_map_scene`` (FAST corners, the tracking map ``bench.py``
builds) and ``candidate_map_scene`` (Shi-Tomasi candidates with dense root
measurements, the mapping scene of ``bench_mapping.py``); and the bundle
adjustment scenes: ``ba_problem`` (``bench_ba.py``'s problem) and
``ba_map`` (a many-keyframe map of the same geometry).

The texture is drawn from a numpy ``Generator``: it has the structure of
the JAX package's texture but not its values (jax.random draws differ),
so tests that compare the packages hand the same texture to both. Every
draw is an input or a seeded numpy generator (the hostile noise).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ptam_cg_tpu_torch.config import LEVELS, FrontendConfig
from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models import bundle
from ptam_cg_tpu_torch.models import keyframe as kflib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.ops import image as imops
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


def make_texture(rng: np.random.Generator, size: int = 512,
                 device="cuda") -> Tensor:
    """Multi-scale noise texture in [10, 245] with plenty of FAST corners:
    fine noise, cubic-upsampled blobs, nearest-upsampled patches and a
    high-contrast 4-px block pattern."""
    def up(a, mode):
        t = torch.from_numpy(a.astype(np.float32))[None, None]
        return F.interpolate(t, size=(size, size), mode=mode)[0, 0]

    base = torch.from_numpy(rng.uniform(size=(size, size)).astype(np.float32))
    coarse = up(rng.uniform(size=(size // 8, size // 8)), "bicubic")
    mid = up(rng.uniform(size=(size // 32, size // 32)), "nearest")
    blocks = up((rng.uniform(size=(size // 4, size // 4)) > 0.5), "nearest")
    tex = 0.15 * base + 0.25 * coarse + 0.25 * mid + 0.35 * blocks
    tex = tex - tex.min()
    tex = tex / torch.clamp(tex.max(), min=1e-6)
    return (tex * 235.0 + 10.0).to(device)


def _tex_sample(tex: Tensor, uv: Tensor) -> Tensor:
    """Bilinear sample with wraparound; uv in texture pixels."""
    S = tex.shape[0]
    u, v = uv[..., 0], uv[..., 1]
    fu0 = torch.floor(u)
    fv0 = torch.floor(v)
    fu, fv = u - fu0, v - fv0
    u0 = torch.remainder(fu0.to(torch.int64), S)
    v0 = torch.remainder(fv0.to(torch.int64), S)
    u1 = torch.remainder(u0 + 1, S)
    v1 = torch.remainder(v0 + 1, S)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def _make_rays(cam: atan.Camera, T_cw: SE3, image_size):
    """World-space rays of every pixel: (origin, dir_w (H, W, 3)).
    ``T_cw`` is one pose (R (3, 3), t (3,)), origin (3,), or a pose per
    image row (R (H, 3, 3), t (H, 3): the rolling shutter's), origin
    (H, 1, 3)."""
    W, H = image_size
    dev = T_cw.R.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    z1 = atan.unproject(torch.stack([xs, ys], dim=-1), cam)
    ray_cam = torch.cat([z1, torch.ones_like(z1[..., :1])], dim=-1)
    if T_cw.R.dim() == 2:
        T_wc = se3lib.inv(T_cw)
        return T_wc.t, ray_cam @ T_wc.R.T
    R_wc = T_cw.R.transpose(-1, -2)                       # (H, 3, 3)
    origin = -(R_wc @ T_cw.t[..., None])[..., 0]          # (H, 3)
    dir_w = torch.einsum("hwj,hij->hwi", ray_cam, R_wc)
    return origin[:, None, :], dir_w


def render_plane(cam: atan.Camera, T_cw: SE3, texture: Tensor,
                 image_size: Tuple[int, int],
                 tex_scale: float = 256.0) -> Tensor:
    """Render the textured z=0 world plane through pose T_cw (world ->
    camera; one pose or a per-row stack, ``_make_rays``). Returns (H, W)
    float32; rays that miss the plane give 0."""
    origin, dir_w = _make_rays(cam, T_cw, image_size)
    dz = dir_w[..., 2]
    s = -origin[..., 2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    hit = (s > 0.05) & (torch.abs(dz) > 1e-6)
    xy_w = origin[..., :2] + s[..., None] * dir_w[..., :2]
    return torch.where(hit, _tex_sample(texture, xy_w * tex_scale), 0.0)


def render_scene(cam: atan.Camera, T_cw: SE3, texture: Tensor,
                 image_size: Tuple[int, int], boxes: Tensor,
                 tex_scale: float = 256.0) -> Tensor:
    """The z=0 plane and raised axis-aligned blocks standing on it: the
    non-planar scene with parallax and occlusion. ``boxes``: (B, 4) rows
    [cx, cy, half_xy, height]; a block spans x, y in [c - half, c + half]
    and z in [-height, 0] (the cameras look from negative z). Blocks take
    the same texture, shaded by face (top 1, x sides 0.72, y sides 0.55).
    ``T_cw`` may be a per-row stack (``_make_rays``)."""
    W, H = image_size
    origin, dir_w = _make_rays(cam, T_cw, image_size)
    dev = dir_w.device
    dz = dir_w[..., 2]
    s_plane = -origin[..., 2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    plane_ok = (s_plane > 0.05) & (torch.abs(dz) > 1e-6)
    best_s = torch.where(plane_ok, s_plane, float("inf"))
    best_shade = torch.ones((H, W), dtype=torch.float32, device=dev)
    inv_d = 1.0 / torch.where(torch.abs(dir_w) < 1e-9, 1e-9, dir_w)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(boxes.shape[0]):
        cx, cy, half, h = boxes[b]
        lo = torch.stack([cx - half, cy - half, -h])
        hi = torch.stack([cx + half, cy + half, zero])
        t0 = (lo - origin) * inv_d                        # (H, W, 3)
        t1 = (hi - origin) * inv_d
        tmin3 = torch.minimum(t0, t1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        tmin = torch.amax(tmin3, dim=-1)
        hit = (tmax > torch.clamp(tmin, min=0.05)) & (tmin < best_s)
        # The face: the slab that bounds the entry point (the first axis
        # on a tie, as argmax).
        enter_axis = torch.argmax(tmin3, dim=-1)
        shade = torch.where(enter_axis == 2, 1.0,
                            torch.where(enter_axis == 0, 0.72, 0.55))
        best_shade = torch.where(hit, shade, best_shade)
        best_s = torch.where(hit, tmin, best_s)
    hit_any = torch.isfinite(best_s)
    p_w = origin + torch.where(hit_any, best_s, 0.0)[..., None] * dir_w
    vals = _tex_sample(texture, p_w[..., :2] * tex_scale) * best_shade
    return torch.where(hit_any, vals, 0.0)


def default_blocks(seed: int = 0, n: int = 5, device="cuda") -> Tensor:
    """A scatter of low raised blocks near the origin, (n, 4), drawn from
    ``np.random.default_rng(seed)`` as the JAX package draws them
    (heights a modest fraction of the 1.5 camera height, so the plane
    still wins the stereo init)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-0.6, 0.6, n)
    cy = rng.uniform(-0.45, 0.45, n)
    half = rng.uniform(0.05, 0.14, n)
    h = rng.uniform(0.05, 0.16, n)
    return torch.from_numpy(np.stack([cx, cy, half, h], -1).astype(
        np.float32)).to(device)


def render_checkerboard(cam: atan.Camera, T_cw: SE3,
                        image_size: Tuple[int, int], dark: float = 40.0,
                        light: float = 210.0, blur: float = 0.0) -> Tensor:
    """A unit-square checkerboard on the z=0 world plane, the calibrator's
    synthetic target; rays that miss the plane read mid-gray."""
    origin, dir_w = _make_rays(cam, T_cw, image_size)
    dz = dir_w[..., 2]
    s = -origin[2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    hit = (s > 0.05) & (torch.abs(dz) > 1e-6)
    xy = origin[:2] + s[..., None] * dir_w[..., :2]
    par = torch.remainder(torch.floor(xy[..., 0]) + torch.floor(xy[..., 1]),
                          2.0)
    vals = torch.where(par < 0.5, light, dark)
    out = torch.where(hit, vals, 0.5 * (dark + light))
    if blur > 0:
        out = imops.gaussian_blur(out, blur)
    return out


def _look_at_origin(centers: Tensor, look_at_z: float) -> SE3:
    """World -> camera poses at ``centers`` (N, 3), each looking at
    (0, 0, look_at_z), y up."""
    dev = centers.device
    target = torch.zeros(3, device=dev)
    target[2] = look_at_z
    fwd = target[None] - centers
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    up_hint = torch.zeros(3, device=dev)
    up_hint[1] = 1.0
    right = torch.linalg.cross(up_hint.expand(fwd.shape), fwd, dim=-1)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    up = torch.linalg.cross(fwd, right, dim=-1)
    R_cw = torch.stack([right, up, fwd], dim=-1).transpose(-1, -2)
    t_cw = -(R_cw @ centers[..., None])[..., 0]
    return SE3(R_cw, t_cw)


def orbit_trajectory(n_frames: int, height: float = 1.5,
                     radius: float = 0.25, sweep: float = 0.8,
                     look_at_z: float = 0.0, device="cuda") -> SE3:
    """Lateral arc above the plane, always looking at the origin region:
    batched SE3 (n_frames poses, world -> camera)."""
    t = torch.linspace(0.0, 1.0, n_frames, device=device)
    ang = sweep * t
    cx = radius * torch.sin(ang)
    cy = 0.15 * radius * (1.0 - torch.cos(2.0 * ang))
    cz = -height + 0.05 * radius * torch.sin(3.0 * ang)
    return _look_at_origin(torch.stack([cx, cy, cz], dim=-1), look_at_z)


def loop_trajectory(n_frames: int, height: float = 1.5, radius: float = 0.8,
                    look_at_z: float = 0.0, device="cuda") -> SE3:
    """A full circle above the plane that returns to its start pose,
    always looking at the origin (a loop-closure-shaped path)."""
    t = torch.linspace(0.0, 1.0, n_frames, device=device)
    ang = 2.0 * math.pi * t
    cx = radius * torch.sin(ang)
    cy = radius * (1.0 - torch.cos(ang))
    cz = -height + 0.03 * radius * torch.sin(3.0 * ang)
    return _look_at_origin(torch.stack([cx, cy, cz], dim=-1), look_at_z)


def interp_pose(T0: SE3, delta: Tensor, alpha) -> SE3:
    """The pose at fraction ``alpha`` (a number or a tensor, e.g. one a
    row) of the inter-frame twist ``delta = se3_log(T1 T0^-1)``."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=delta.device)
    d = se3lib.se3_exp(alpha[..., None] * delta)
    return se3lib.mul(d, SE3(T0.R.expand(d.R.shape), T0.t.expand(d.t.shape)))


def render_motion(cam: atan.Camera, T0: SE3, delta: Tensor, texture: Tensor,
                  image_size: Tuple[int, int], boxes, tex_scale: float,
                  n_blur: int, rolling_shutter: float,
                  exposure: float) -> Tensor:
    """A frame with motion blur and a rolling shutter: the mean of
    ``n_blur`` renders spread over ``exposure`` of the inter-frame motion
    ``delta`` (one render with ``n_blur`` 0), each row r exposed
    ``rolling_shutter * (r + 0.5) / H`` of the frame period late. The
    frame's ground-truth pose stays T0."""
    W, H = image_size
    rows = (torch.arange(H, dtype=torch.float32, device=delta.device)
            + 0.5) / H
    n = max(n_blur, 1)
    acc = torch.zeros((H, W), dtype=torch.float32, device=delta.device)
    for s_i in range(n):
        t_off = (s_i + 0.5) / n * exposure if n_blur > 0 else 0.0
        if rolling_shutter == 0.0:
            T = interp_pose(T0, delta, t_off)
        else:
            T = interp_pose(T0, delta, t_off + rolling_shutter * rows)
        if boxes is None:
            acc = acc + render_plane(cam, T, texture, image_size, tex_scale)
        else:
            acc = acc + render_scene(cam, T, texture, image_size, boxes,
                                     tex_scale)
    return acc / n


def hostile_transform(im: Tensor, i, noise: Tensor, noise_std: float = 4.0,
                      gain_amp: float = 0.25, offset_amp: float = 12.0,
                      vignette: float = 0.25) -> Tensor:
    """Photometric hostility: a slow gain (exposure) and offset
    (black-level) drift over the frame index ``i``, sensor noise
    ``noise_std * noise`` (``noise``: (H, W) standard normal draws, an
    input) and a static vignette, clipped to [0, 255]."""
    i = float(i)
    gain = 1.0 + gain_amp * math.sin(i / 17.0)
    offset = offset_amp * math.sin(i / 29.0 + 1.0)
    H, W = im.shape
    dev = im.device
    yy = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2) / (H / 2)
    xx = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2) / (W / 2)
    vig = 1.0 - vignette * (yy[:, None] ** 2 + xx[None, :] ** 2) / 2.0
    return torch.clamp(gain * im * vig + offset + noise_std * noise,
                       0.0, 255.0)


class SyntheticSequence:
    """Frames of a ground-truth sequence, rendered on demand on
    ``device``: the textured plane, with raised ``boxes`` (``render_scene``)
    if given; an "orbit" (lateral arc) or "loop" (full circle)
    ``trajectory``; ``motion_blur`` exposure samples over ``exposure`` of
    the frame period and a ``rolling_shutter`` row lag
    (``render_motion``); and ``hostile`` photometric drift, noise and
    vignette (``hostile_transform``), whose noise for frame i is drawn
    from ``np.random.default_rng(seed * 100003 + i)``."""

    def __init__(self, cam_params, image_size=(640, 480), n_frames=100,
                 seed=0, height=1.5, radius=0.25, sweep=0.8,
                 tex_scale=256.0, boxes=None, trajectory="orbit",
                 hostile=False, motion_blur: int = 0,
                 rolling_shutter: float = 0.0, exposure: float = 0.5,
                 device="cuda"):
        self.cam = atan.make_camera(cam_params, image_size, device)
        self.image_size = image_size
        self.n_frames = n_frames
        self.texture = make_texture(np.random.default_rng(seed),
                                    device=device)
        if trajectory == "loop":
            self.poses = loop_trajectory(n_frames, height, radius,
                                         device=device)
        elif trajectory == "orbit":
            self.poses = orbit_trajectory(n_frames, height, radius, sweep,
                                          device=device)
        else:
            raise ValueError(f"trajectory {trajectory!r}: orbit or loop")
        self.tex_scale = tex_scale
        self.boxes = (None if boxes is None
                      else torch.as_tensor(boxes, dtype=torch.float32).to(
                          device))
        self.hostile = hostile
        self._seed = seed
        self.motion_blur = motion_blur
        self.rolling_shutter = rolling_shutter
        self.exposure = exposure

    def pose(self, i: int) -> SE3:
        return SE3(self.poses.R[i], self.poses.t[i])

    def frame(self, i: int) -> Tensor:
        T = self.pose(i)
        if self.motion_blur > 0 or self.rolling_shutter > 0.0:
            j = min(i + 1, self.n_frames - 1)
            delta = (se3lib.se3_log(se3lib.mul(self.pose(j),
                                               se3lib.inv(T)))
                     if j != i else torch.zeros(6, device=T.t.device))
            im = render_motion(self.cam, T, delta, self.texture,
                               self.image_size, self.boxes, self.tex_scale,
                               self.motion_blur, self.rolling_shutter,
                               self.exposure)
        elif self.boxes is None:
            im = render_plane(self.cam, T, self.texture, self.image_size,
                              self.tex_scale)
        else:
            im = render_scene(self.cam, T, self.texture, self.image_size,
                              self.boxes, self.tex_scale)
        if self.hostile:
            W, H = self.image_size
            noise = np.random.default_rng(
                self._seed * 100003 + i).standard_normal((H, W))
            im = hostile_transform(im, i, torch.from_numpy(
                noise.astype(np.float32)).to(im.device))
        return im


def planar_map_scene(seq: SyntheticSequence, max_points: int = 2048,
                     per_level: int = 512, max_kfs: int = 4, seed: int = 0,
                     border: int = 10,
                     frontend_cfg: FrontendConfig = FrontendConfig()):
    """A one-keyframe map of frame 0, built as ``bench.py`` builds its map:
    corners of frame 0 back-projected onto the z=0 plane through the
    ground-truth pose. The corners come from the frame's FAST corner mask:
    at most ``per_level`` per level, drawn with a seeded numpy generator
    among the corners at least ``border`` px from the level's edge.

    Returns (map, frame-0 TrackFeatures); the features' ``sbi_track`` is
    the previous SBI for tracking frame 1.
    """
    W, H = seq.image_size
    cam = seq.cam
    dev = seq.texture.device
    ff0 = kflib.build_frame_tracking(seq.frame(0), frontend_cfg)
    pose0 = seq.pose(0)
    rng = np.random.default_rng(seed)
    centers, lvls = [], []
    for lev in range(LEVELS):
        mask = levelops.unpack_level(ff0.corner_mask, lev, H, W).cpu().numpy()
        hl, wl = mask.shape
        ys, xs = np.nonzero(mask)
        keep = ((xs >= border) & (xs < wl - border)
                & (ys >= border) & (ys < hl - border))
        ys, xs = ys[keep], xs[keep]
        pick = np.sort(rng.choice(len(xs), min(per_level, len(xs)),
                                  replace=False))
        centers.append(np.stack([xs[pick], ys[pick]], -1))
        lvls.append(np.full(len(pick), lev))
    ctr = torch.from_numpy(np.concatenate(centers)[:max_points]).to(
        device=dev, dtype=torch.float32)
    lv = torch.from_numpy(np.concatenate(lvls)[:max_points]).to(dev)

    T_wc = se3lib.inv(pose0)
    z1 = atan.unproject(levelops.level_zero_pos(ctr, lv), cam)
    dir_w = torch.cat([z1, torch.ones_like(z1[:, :1])], -1) @ T_wc.R.T
    s = -T_wc.t[2] / dir_w[:, 2]
    on_plane = (s > 0).cpu()
    pts = (T_wc.t + s[:, None] * dir_w)[on_plane.to(dev)]
    ctr, lv = ctr[on_plane.to(dev)], lv[on_plane.to(dev)]
    n = pts.shape[0]

    m = ms.empty_map((W, H), max_points=max_points, max_kfs=max_kfs,
                     device=dev)
    ms.insert_keyframe(m, 0, ff0, pose0, 1.5, 0.1)
    m.point_pos[:n] = pts
    m.point_valid[:n] = True
    m.point_src_level[:n] = lv.to(torch.int32)
    m.point_center[:n] = ctr
    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(
        m.point_center, m.point_src_level.long(), cam)
    m.point_center_nc, m.point_right_nc = c_nc, r_nc
    m.point_down_nc, m.point_normal_nc = d_nc, nrm
    m.good = torch.ones((), dtype=torch.bool, device=dev)
    return ms.refresh_pixel_vectors(m), ff0


def _plane_points(seq: SyntheticSequence, pose: SE3, ctr: Tensor,
                  lv: Tensor):
    """Back-project level coords ``ctr`` at levels ``lv`` through ``pose``
    onto the z=0 plane. Returns (points, mask of rays that hit it)."""
    T_wc = se3lib.inv(pose)
    z1 = atan.unproject(levelops.level_zero_pos(ctr, lv), seq.cam)
    dir_w = torch.cat([z1, torch.ones_like(z1[:, :1])], -1) @ T_wc.R.T
    s = -T_wc.t[2] / dir_w[:, 2]
    return T_wc.t + s[:, None] * dir_w, s > 0


def candidate_map_scene(seq: SyntheticSequence, max_points: int = 2048,
                        max_kfs: int = 4, candidate_min_score: float = 50.0):
    """A one-keyframe map of frame 0 built as ``bench_mapping.py``'s
    ``build_scene`` builds it: the full keyframe build of frame 0 with
    ``candidate_min_score``, its Shi-Tomasi candidates level by level
    back-projected onto the z=0 plane through the ground-truth pose until
    ``max_points`` are taken, and a root measurement of every point in
    keyframe 0.

    Returns (map, frame-0 FrameFeatures).
    """
    W, H = seq.image_size
    dev = seq.texture.device
    ff0 = kflib.build_frame(seq.frame(0),
                            candidate_min_score=candidate_min_score)
    pose0 = seq.pose(0)
    ctr, lv = [], []
    for lev in range(LEVELS):
        xy = ff0.cand_xy[lev][ff0.cand_valid[lev]]
        ctr.append(xy.to(torch.float32))
        lv.append(torch.full((xy.shape[0],), lev, dtype=torch.int64,
                             device=dev))
    ctr, lv = torch.cat(ctr), torch.cat(lv)
    pts, hit = _plane_points(seq, pose0, ctr, lv)
    keep = torch.nonzero(hit)[:max_points, 0]
    pts, ctr, lv = pts[keep], ctr[keep], lv[keep]
    n = pts.shape[0]

    m = ms.empty_map((W, H), max_points=max_points, max_kfs=max_kfs,
                     device=dev)
    ms.insert_keyframe(m, 0, ff0, pose0, 1.5, 0.1)
    m.point_pos[:n] = pts
    m.point_valid[:n] = True
    m.point_src_level[:n] = lv.to(torch.int32)
    m.point_center[:n] = ctr
    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(
        m.point_center, m.point_src_level.long(), seq.cam)
    m.point_center_nc, m.point_right_nc = c_nc, r_nc
    m.point_down_nc, m.point_normal_nc = d_nc, nrm
    m.good = torch.ones((), dtype=torch.bool, device=dev)
    m = ms.refresh_pixel_vectors(m)
    P = max_points
    root = levelops.level_zero_pos(m.point_center, m.point_src_level.long())
    m = ms.set_measurements(
        m, 0, torch.arange(P, device=dev), root, m.point_src_level,
        torch.ones(P, dtype=torch.bool, device=dev),
        torch.full((P,), ms.SRC_ROOT, dtype=torch.int32, device=dev),
        m.point_valid)
    return m, ff0


# ---------------------------------------------------------------------------
# Bundle adjustment scenes
# ---------------------------------------------------------------------------

#: The reference ATAN camera, at 640x480, of the BA scenes.
BA_CAMERA = ((1.0803, 1.43987, 0.519983, 0.548655, 0.244943), (640, 480))
#: bench_ba.make_problem's scene: a camera's sideways step and pan a
#: camera index, the points' depth range, and the pixel noise (at level 0).
BA_MOTION = (0.08, 0.015)
BA_DEPTH = (3.0, 6.0)
BA_NOISE_PX = 0.3
#: ba_map: the most keyframes that measure a point.
BA_MEAS_PER_PT = 4


def _ba_geometry(rng: np.random.Generator, n_cams: int, n_pts: int):
    """``bench_ba.make_problem``'s scene: points uniform in a box in front
    of the cameras, and cameras stepping sideways while panning. Returns
    numpy (points (n_pts, 3), R (n_cams, 3, 3), t (n_cams, 3))."""
    z0, z1 = BA_DEPTH
    pts = rng.uniform([-2, -1.5, z0], [2, 1.5, z1],
                      (n_pts, 3)).astype(np.float32)
    tm, rm = BA_MOTION
    j = np.arange(n_cams, dtype=np.float32)
    zero = np.zeros_like(j)
    xi = np.stack([tm * j, tm * 0.125 * j, zero, zero, -rm * j, zero], -1)
    poses = se3lib.se3_exp(torch.from_numpy(xi.astype(np.float32)))
    return pts, poses.R.numpy(), poses.t.numpy()


def _project_np(cam: atan.Camera, p_cam: np.ndarray) -> np.ndarray:
    z1 = p_cam[..., :2] / p_cam[..., 2:3]
    return atan.project(torch.from_numpy(np.ascontiguousarray(z1)),
                        cam).numpy()


def ba_problem(n_cams: int, n_pts: int, n_meas: int, seed: int = 0,
               fixed=(0,), device="cuda"):
    """``bench_ba.make_problem`` rebuilt with numpy and the port: the same
    draws from ``np.random.default_rng(seed)`` in the same order, so the
    same problem up to float32 rounding of the poses. Measurements pair
    random cameras and points (a pair may repeat); the cameras ``fixed``
    are held (bench_ba's: the first, which leaves the monocular scale
    free; a second fixed camera far from it pins the scale); the points
    start perturbed by N(0, 0.02). Returns (problem, camera) on
    ``device``."""
    rng = np.random.default_rng(seed)
    cam_cpu = atan.make_camera(*BA_CAMERA, device="cpu")
    pts, R, t = _ba_geometry(rng, n_cams, n_pts)
    mc = rng.integers(0, n_cams, n_meas).astype(np.int32)
    mp = rng.integers(0, n_pts, n_meas).astype(np.int32)
    p_cam = np.einsum("mij,mj->mi", R[mc], pts[mp]) + t[mc]
    pix = _project_np(cam_cpu, p_cam)
    pix += rng.normal(0, BA_NOISE_PX, pix.shape)
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[list(fixed)] = True
    pt0 = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prob = bundle.BundleProblem(
        cam_R=T(R), cam_t=T(t), cam_fixed=T(cam_fixed),
        cam_valid=T(np.ones(n_cams, bool)), pt_pos=T(pt0),
        pt_valid=T(np.ones(n_pts, bool)), meas_cam=T(mc), meas_pt=T(mp),
        meas_pos=T(pix.astype(np.float32)),
        meas_sqrt_inv_noise=T(np.ones(n_meas, np.float32)),
        meas_valid=T(np.ones(n_meas, bool)),
        meas_bad=T(np.zeros(n_meas, bool)))
    return prob, atan.make_camera(*BA_CAMERA, device=device)


def ba_map(n_kfs: int = 64, max_kfs: int = 128, n_pts: int = 4096,
           seed: int = 0, image_size=(640, 480), device="cuda"):
    """A map of ``ba_problem``'s geometry for the MapMaker's BA: ``n_kfs``
    valid keyframes in ``max_kfs`` slots (keyframes 0 and ``n_kfs // 2``
    fixed: their wide baseline pins the monocular scale; the others' poses
    perturbed by twists of N(0, 0.003)), ``n_pts`` points in as many
    slots, perturbed by N(0, 0.02). Each point is measured in up to
    ``BA_MEAS_PER_PT`` keyframes drawn from those that see it (in front,
    8 px inside the image); a point seen by fewer than two is invalid.
    Each measurement has a level drawn from 0-3 and noise of
    ``BA_NOISE_PX`` times its scale; the point's first measurement is its ROOT (source keyframe
    and level), the others are tracker, re-find, trail or epipolar ones.
    ``image_size`` sets only the keyframe atlases' shape (all zero); the
    camera is 640x480. Returns (map, camera) on ``device``."""
    rng = np.random.default_rng(seed)
    cam_cpu = atan.make_camera(*BA_CAMERA, device="cpu")
    W, H = BA_CAMERA[1]
    pts, R, t = _ba_geometry(rng, n_kfs, n_pts)
    p_cam = np.einsum("kij,pj->kpi", R, pts) + t[:, None]     # (K, P, 3)
    pix = _project_np(cam_cpu, p_cam)
    sees = ((p_cam[..., 2] > 0.1) & (pix[..., 0] >= 8) & (pix[..., 0] < W - 8)
            & (pix[..., 1] >= 8) & (pix[..., 1] < H - 8))
    prio = np.where(sees, rng.uniform(size=sees.shape), -1.0)
    rank = np.argsort(np.argsort(-prio, axis=0, kind="stable"), axis=0,
                      kind="stable")
    meas = sees & (rank < BA_MEAS_PER_PT)
    valid = meas.sum(0) >= 2
    meas &= valid[None]
    level = rng.integers(0, 4, meas.shape).astype(np.int32)
    scale = (1 << level).astype(np.float32)
    pos = (pix + rng.normal(0, BA_NOISE_PX, pix.shape) * scale[..., None]
           ).astype(np.float32)
    src_kf = np.argmax(meas, axis=0).astype(np.int32)           # first
    root = np.zeros_like(meas)
    root[src_kf, np.arange(n_pts)] = valid
    others = np.array([ms.SRC_TRACKER, ms.SRC_REFIND, ms.SRC_TRAIL,
                       ms.SRC_EPIPOLAR], np.int32)
    source = np.where(root, ms.SRC_ROOT,
                      others[rng.integers(0, 4, meas.shape)]).astype(np.int32)
    src_level = level[src_kf, np.arange(n_pts)]
    xi = rng.normal(0, 0.003, (n_kfs, 6)).astype(np.float32)
    fixed = [0, n_kfs // 2]
    xi[fixed] = 0.0
    d = se3lib.se3_exp(torch.from_numpy(xi))
    R0 = (d.R @ torch.from_numpy(R)).numpy()
    t0 = ((d.R @ torch.from_numpy(t)[..., None])[..., 0] + d.t).numpy()
    pt0 = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    m = ms.empty_map(image_size, max_points=n_pts, max_kfs=max_kfs,
                     device=device)
    K = n_kfs
    m.kf_R[:K], m.kf_t[:K] = T(R0), T(t0)
    m.kf_valid[:K] = True
    m.kf_fixed[fixed] = True
    m.point_pos[:] = T(pt0)
    m.point_valid[:] = T(valid)
    m.point_src_kf[:] = T(src_kf)
    m.point_src_level[:] = T(src_level)
    m.meas_valid[:K] = T(meas)
    m.meas_pos[:K] = T(pos)
    m.meas_level[:K] = T(level)
    m.meas_subpix[:K] = T(meas)
    m.meas_source[:K] = T(np.where(meas, source, 0))
    root_pos = T(pos[src_kf, np.arange(n_pts)])
    lv = m.point_src_level.long()
    m.point_center[:] = levelops.level_n_pos(root_pos, lv)
    cam = atan.make_camera(*BA_CAMERA, device=device)
    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(m.point_center, lv, cam)
    m.point_center_nc, m.point_right_nc = c_nc, r_nc
    m.point_down_nc, m.point_normal_nc = d_nc, nrm
    m.good = torch.ones((), dtype=torch.bool, device=device)
    return ms.refresh_pixel_vectors(m), cam


def ba_problem_large(n_cams: int = 128, n_pts: int = 16384,
                     obs_per_pt: int = 4, seed: int = 7,
                     perturb_cams: float = 0.01, perturb_pts: float = 0.02,
                     device="cuda"):
    """``tests/test_sharded_ba.py::make_problem_large`` rebuilt with numpy
    and the port, the same draws from ``np.random.default_rng(seed)`` in
    the same order: ``n_cams`` cameras sliding sideways and panning in
    front of a point cloud, each point measured by ``obs_per_pt`` of the
    cameras that see it (noise-free), the first two cameras fixed, the
    others' poses perturbed by twists of N(0, ``perturb_cams``) and the
    points by N(0, ``perturb_pts``). Returns (problem, camera, ground
    truth (R, t, points)) on ``device``."""
    rng = np.random.default_rng(seed)
    params, size = BA_CAMERA      # tests/test_bundle.py's camera too
    cam_cpu = atan.make_camera(params, size, "cpu")
    pts = rng.uniform([-2.0, -1.5, 3.5], [2.0, 1.5, 6.0],
                      (n_pts, 3)).astype(np.float32)
    j = np.arange(n_cams, dtype=np.float32)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = 0.015 * j
    xi[:, 4] = -0.003 * j
    poses = se3lib.se3_exp(torch.from_numpy(xi))
    R_gt, t_gt = poses.R.numpy(), poses.t.numpy()
    p_cam = np.einsum("cij,pj->cpi", R_gt, pts) + t_gt[:, None]
    z = p_cam[..., 2]
    z1 = p_cam[..., :2] / np.maximum(z[..., None], 1e-6)
    pix = atan.project(torch.from_numpy(np.ascontiguousarray(
        z1.reshape(-1, 2))), cam_cpu).numpy().reshape(n_cams, n_pts, 2)
    W, H = size
    vis = ((z > 0.5) & (pix[..., 0] > 5) & (pix[..., 0] < W - 5)
           & (pix[..., 1] > 5) & (pix[..., 1] < H - 5))
    pref = np.where(vis, rng.random((n_cams, n_pts)), -1.0)
    order = np.argsort(-pref, axis=0)[:obs_per_pt]
    ok = np.take_along_axis(pref, order, axis=0) > 0
    M = n_pts * obs_per_pt
    mc = order.reshape(-1).astype(np.int32)
    mp = np.tile(np.arange(n_pts, dtype=np.int32), obs_per_pt)
    mpos = pix[mc, mp].astype(np.float32)
    dxi = rng.normal(0, perturb_cams, (n_cams, 6)).astype(np.float32)
    dxi[:2] = 0.0
    d = se3lib.se3_exp(torch.from_numpy(dxi))
    dR, dt = d.R.numpy(), d.t.numpy()
    R0 = np.einsum("cij,cjk->cik", dR, R_gt)
    t0 = np.einsum("cij,cj->ci", dR, t_gt) + dt
    pts0 = pts + rng.normal(0, perturb_pts, pts.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prob = bundle.BundleProblem(
        cam_R=T(R0.astype(np.float32)), cam_t=T(t0.astype(np.float32)),
        cam_fixed=T(fixed), cam_valid=T(np.ones(n_cams, bool)),
        pt_pos=T(pts0), pt_valid=T(np.ones(n_pts, bool)), meas_cam=T(mc),
        meas_pt=T(mp), meas_pos=T(mpos),
        meas_sqrt_inv_noise=T(np.ones(M, np.float32)),
        meas_valid=T(ok.reshape(-1)), meas_bad=T(np.zeros(M, bool)))
    return (prob, atan.make_camera(params, size, device),
            (T(R_gt), T(t_gt), T(pts)))
