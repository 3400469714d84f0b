"""The benchmark's scene: a frozen copy, in plain PyTorch, of the port's
synthetic renderer (``ptam_cg_tpu_torch/io/synth.py``): a textured z=0
plane with raised boxes, seen through an ATAN camera from an orbit arc that
always looks at the origin. It imports nothing of the port, so a change to
the port cannot change the frames it is measured on.

Everything is drawn from one ``torch.Generator`` on the device, seeded with
the run's seed: the texture, then the boxes. The camera's path is the same
for every seed; only the scene it sees changes.

The arc is swept forth and back, paced by the camera's angular speed
(the configuration's ``angular_speed_deg_s`` at its ``fps``), after a ramp
in which the camera starts from rest. Frame ``k`` of the endless sequence is
one of ``n_unique`` rendered frames (``Sequence.index``), so a window of any
length needs no further rendering.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TEX_SIZE = 512
TEX_SCALE = 256.0      # texture pixels a world unit (synth.py's default)
ARC_SAMPLES = 4097     # the dense arc over which the pacing is worked out


# -- the ATAN camera (ref: src/ATANCamera.cc), normalized parameters ----------

def camera(params, image_size):
    """(focal (2,), center (2,), w) in pixels of an ATAN camera with
    normalized parameters [fx fy cx cy w] at ``image_size`` (W, H)."""
    W, H = image_size
    fx, fy, cx, cy, w = (float(p) for p in params)
    return (np.array([W * fx, H * fy]), np.array([W * cx - 0.5, H * cy - 0.5]),
            w)


def unproject(pix: torch.Tensor, cam) -> torch.Tensor:
    """Pixels (..., 2) -> coordinates on the z=1 plane."""
    focal, center, w = cam
    f = torch.as_tensor(focal, dtype=pix.dtype, device=pix.device)
    c = torch.as_tensor(center, dtype=pix.dtype, device=pix.device)
    d = (pix - c) / f
    r_d = torch.linalg.vector_norm(d, dim=-1)
    if w == 0.0:
        return d
    r_u = torch.tan(r_d * w) / (2.0 * math.tan(w / 2.0))
    factor = torch.where(r_d > 0.01, r_u / torch.clamp(r_d, min=0.01),
                         torch.ones_like(r_d))
    return factor[..., None] * d


# -- the path -----------------------------------------------------------------

def arc_centers(a: np.ndarray, radius: float, height: float) -> np.ndarray:
    """Camera centres (N, 3) at arc angles ``a``: synth.orbit_trajectory's
    lateral arc above the plane (the camera looks from negative z)."""
    return np.stack([radius * np.sin(a),
                     0.15 * radius * (1.0 - np.cos(2.0 * a)),
                     -height + 0.05 * radius * np.sin(3.0 * a)], -1)


def look_at_origin(centers: np.ndarray):
    """World -> camera poses (R (N, 3, 3), t (N, 3)) at ``centers``, each
    looking at the origin, y up (synth._look_at_origin), in float64."""
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    up_hint = np.broadcast_to(np.array([0.0, 1.0, 0.0]), fwd.shape)
    right = np.cross(up_hint, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd], axis=-2)          # rows: camera axes
    t = -np.einsum("nij,nj->ni", R, centers)
    return R, t


def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle (rad) of Ra Rb^T, batched: |Ra - Rb|_F = 2 sqrt(2) sin(a / 2)."""
    f = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return 2.0 * np.arcsin(np.clip(f, 0.0, 1.0))


class Path:
    """The sweep of a configuration's ``path`` at its ``fps``: grid angles
    at equal steps of rotation, ``n_sweep`` steps from one end of the arc
    to the other, and ``ramp`` frames of rest-to-speed before the first
    grid frame."""

    def __init__(self, path: dict, fps: float):
        self.radius, self.height = path["radius"], path["height"]
        half = path["half_sweep_rad"]
        a = np.linspace(-half, half, ARC_SAMPLES)
        R, _ = look_at_origin(arc_centers(a, self.radius, self.height))
        theta = np.concatenate([[0.0], np.cumsum(rotation_angle(R[1:],
                                                                R[:-1]))])
        step = math.radians(path["angular_speed_deg_s"]) / fps
        self.n_sweep = max(8, int(round(theta[-1] / step)))
        self.ramp = int(path["ramp_frames"])
        if self.ramp % 2:
            raise ValueError("ramp_frames must be even: the ramp then ends "
                             "on a grid frame")
        dth = theta[-1] / self.n_sweep
        # The ramp: at rest at frame 0, full speed at frame `ramp`.
        ramp_th = dth * np.arange(self.ramp) ** 2 / (2.0 * max(self.ramp, 1))
        grid_th = dth * np.arange(self.n_sweep + 1)
        self.angles = np.interp(np.concatenate([ramp_th, grid_th]), theta, a)
        self.n_unique = self.angles.shape[0]
        centers = arc_centers(self.angles, self.radius, self.height)
        self.R, self.t = look_at_origin(centers)
        self.centers = centers
        self.speed_m_s = float(np.linalg.norm(
            np.diff(centers[self.ramp:], axis=0), axis=-1).mean() * fps)
        self.speed_deg_s = math.degrees(dth) * fps

    def index(self, k: int) -> int:
        """The rendered frame shown as frame ``k`` of the sequence."""
        if k < self.ramp:
            return k
        m = (self.ramp // 2 + k - self.ramp) % (2 * self.n_sweep)
        if m > self.n_sweep:
            m = 2 * self.n_sweep - m
        return self.ramp + m


# -- the scene ----------------------------------------------------------------

def make_texture(g: torch.Generator, device) -> torch.Tensor:
    """synth.make_texture's multi-scale noise in [10, 245], from ``g``."""
    S = TEX_SIZE

    def up(a, mode):
        return F.interpolate(a[None, None], size=(S, S), mode=mode)[0, 0]

    def rand(n):
        return torch.rand((n, n), generator=g, device=device)

    base = rand(S)
    coarse = up(rand(S // 8), "bicubic")
    mid = up(rand(S // 32), "nearest")
    blocks = up((rand(S // 4) > 0.5).float(), "nearest")
    tex = 0.15 * base + 0.25 * coarse + 0.25 * mid + 0.35 * blocks
    tex = tex - tex.min()
    tex = tex / torch.clamp(tex.max(), min=1e-6)
    return tex * 235.0 + 10.0


def make_boxes(g: torch.Generator, spec: dict, device) -> torch.Tensor:
    """(n, 4) rows [cx, cy, half, height], each uniform in its range."""
    n = int(spec["n"])
    lo = torch.tensor([spec[k][0] for k in ("cx", "cy", "half", "height")],
                      device=device)
    hi = torch.tensor([spec[k][1] for k in ("cx", "cy", "half", "height")],
                      device=device)
    return lo + (hi - lo) * torch.rand((n, 4), generator=g, device=device)


def _tex_sample(tex, uv):
    S = tex.shape[0]
    u, v = uv[..., 0], uv[..., 1]
    fu0, fv0 = torch.floor(u), torch.floor(v)
    fu, fv = u - fu0, v - fv0
    u0 = torch.remainder(fu0.to(torch.int64), S)
    v0 = torch.remainder(fv0.to(torch.int64), S)
    u1, v1 = torch.remainder(u0 + 1, S), torch.remainder(v0 + 1, S)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def render(ray_cam, R_cw, t_cw, tex, boxes):
    """One frame (H, W) float32: the plane and the boxes (the nearest hit,
    shaded by face as synth.render_scene shades them) along the camera
    rays ``ray_cam`` (H, W, 3), through the pose (R_cw, t_cw)."""
    R_wc = R_cw.T
    origin = -(R_wc @ t_cw)
    dir_w = ray_cam @ R_wc.T
    dz = dir_w[..., 2]
    s_plane = -origin[2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    best_s = torch.where((s_plane > 0.05) & (torch.abs(dz) > 1e-6), s_plane,
                         float("inf"))
    best_shade = torch.ones_like(dz)
    inv_d = 1.0 / torch.where(torch.abs(dir_w) < 1e-9, 1e-9, dir_w)
    for b in range(boxes.shape[0]):
        cx, cy, half, h = boxes[b]
        lo = torch.stack([cx - half, cy - half, -h])
        hi = torch.stack([cx + half, cy + half, torch.zeros_like(h)])
        t0, t1 = (lo - origin) * inv_d, (hi - origin) * inv_d
        tmin3 = torch.minimum(t0, t1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        tmin = torch.amax(tmin3, dim=-1)
        hit = (tmax > torch.clamp(tmin, min=0.05)) & (tmin < best_s)
        axis = torch.argmax(tmin3, dim=-1)
        shade = torch.where(axis == 2, 1.0, torch.where(axis == 0, 0.72, 0.55))
        best_shade = torch.where(hit, shade, best_shade)
        best_s = torch.where(hit, tmin, best_s)
    hit_any = torch.isfinite(best_s)
    p_w = origin + torch.where(hit_any, best_s, 0.0)[..., None] * dir_w
    vals = _tex_sample(tex, p_w[..., :2] * TEX_SCALE) * best_shade
    return torch.where(hit_any, vals, 0.0)


class Sequence:
    """A configuration's frames for one seed: ``frames`` (n_unique, H, W)
    uint8 on the host, the ground truth ``R``, ``t`` (n_unique, ...) float64
    world -> camera, the ``boxes`` (float64 NumPy) and ``index(k)``."""

    def __init__(self, cfg: dict, seed: int, device):
        W, H = cfg["camera"]["image_size"]
        self.image_size = (W, H)
        self.cam = camera(cfg["camera"]["params"], (W, H))
        self.path = Path(cfg["path"], cfg["camera"]["fps"])
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        tex = make_texture(g, device)
        boxes = make_boxes(g, cfg["scene"]["boxes"], device)
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device),
            indexing="ij")
        z1 = unproject(torch.stack([xs, ys], -1), self.cam)
        rays = torch.cat([z1, torch.ones_like(z1[..., :1])], -1)
        R = torch.as_tensor(self.path.R, dtype=torch.float32, device=device)
        t = torch.as_tensor(self.path.t, dtype=torch.float32, device=device)
        frames = torch.stack([
            render(rays, R[i], t[i], tex, boxes).clamp(0, 255)
            .to(torch.uint8) for i in range(self.path.n_unique)])
        self.frames = frames.cpu().numpy()
        self.boxes = boxes.double().cpu().numpy()
        self.R, self.t = self.path.R, self.path.t
        self.n_unique = self.path.n_unique

    def index(self, k: int) -> int:
        return self.path.index(k)

    def frame(self, k: int) -> np.ndarray:
        return self.frames[self.index(k)]
