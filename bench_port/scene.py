"""The benchmark's scene: a frozen copy, in plain PyTorch, of the port's
synthetic renderer (``ptam_cg_tpu_torch/io/synth.py``): a textured z=0
plane with raised boxes, seen through an ATAN camera. It imports nothing of
the port, so a change to the port cannot change the frames it is measured
on.

Everything is drawn from one ``torch.Generator`` on the device, seeded with
the run's seed: the texture, then the boxes. The camera's path is the same
for every seed; only the scene it sees changes.

A configuration's ``path`` is one of two kinds:

- ``"arc"`` (the default): an orbit arc that always looks at the origin,
  swept forth and back, paced by the camera's angular speed (the
  configuration's ``angular_speed_deg_s`` at its ``fps``), after a ramp in
  which the camera starts from rest. Frame ``k`` of the endless sequence is
  one of ``n_unique`` rendered frames (``Path.index``), so a window of any
  length needs no further rendering. The texture is 512 texels square and
  wraps every 2 world units; the boxes lie in the ranges the configuration
  gives.
- ``"route"``: a flight over new ground (``Route``), straight ahead at
  ``linear_speed_m_s`` and ``height`` above the plane, the camera looking
  ``look_deg`` from its travel, pitched ``pitch_deg`` below the horizon
  and swaying so that its mean angular speed is ``angular_speed_deg_s``,
  after the same ramp from rest.
  Frame ``k`` is route frame ``k``: nothing folds back, and a route has as
  many frames as the traffic mix flies (``traffic.py``'s ``explore``). The
  texture covers the ground every frame sees, without wrapping, and the
  boxes are drawn over it at ``per_m2`` a square metre.
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


def ramp_distance(n: int, ramp: int) -> np.ndarray:
    """Distance along a path at frames 0..n-1, in full-speed steps: at rest
    at frame 0, full speed from frame ``ramp`` on (``Path``'s ramp)."""
    k = np.arange(n, dtype=np.float64)
    return np.where(k < ramp, k ** 2 / (2.0 * max(ramp, 1)), k - ramp / 2.0)


#: The least sine of a ray's angle below the horizon: a route's view must
#: hold no horizon, so that every ray meets the ground near the camera.
MIN_RAY_DROP = 0.15


class Route:
    """A flight over new ground, ``n_frames`` long, at ``fps``.

    The camera flies straight along +x at ``height`` above the plane, at
    ``linear_speed_m_s`` after ``ramp_frames`` from rest. It looks
    ``look_deg`` about the vertical from its travel (0: ahead; 90: across),
    pitched ``pitch_deg`` below the horizon, its x axis level, and sways as
    a sine of the distance flown, ``sway_wavelength_m`` long, whose
    amplitude makes the mean angular speed after the ramp
    ``angular_speed_deg_s``: the rotation between frames is the change of
    sway alone. ``sway_about`` names the sway's axis: ``"world"``, a yaw
    about the world's vertical (which rolls the image of a camera pitched
    down), or ``"camera"``, a pan about the camera's own vertical axis
    (which shifts the image sideways).

    Why straight: the route must show the map only new ground, for any
    footprint. Lanes and spirals come back beside ground already seen
    unless they lie a footprint apart, and the 180-degree turn at a lane's
    end would set the angular speed by itself; a loop comes back onto its
    start. A straight flight never looks again at ground it has left, and
    every keyframe's neighbours in space are its neighbours in time, as
    when a camera explores. The view's heading, pitch, height and sway
    are the configuration's, from the flight it stands for; the scene is a
    plane, so the view must hold no horizon (``ground_bounds``).

    ``R``, ``t`` (n, ...) float64 world -> camera, ``centers``,
    ``speed_m_s`` and ``speed_deg_s`` (the means after the ramp),
    ``n_unique`` (= n_frames), ``ramp`` and ``index`` as ``Path`` has
    them; ``sway_deg``, the sway's amplitude."""

    SWAY_AXES = ("world", "camera")

    def __init__(self, path: dict, fps: float, n_frames: int):
        self.ramp = int(path["ramp_frames"])
        if self.ramp % 2:
            raise ValueError("ramp_frames must be even")
        if n_frames <= self.ramp + 1:
            raise ValueError(f"a route of {n_frames} frames ends inside "
                             f"its {self.ramp}-frame ramp")
        if path["sway_about"] not in self.SWAY_AXES:
            raise ValueError(f"sway_about {path['sway_about']!r}: one of "
                             f"{self.SWAY_AXES}")
        self.height = float(path["height"])
        self.n_unique = n = int(n_frames)
        s = ramp_distance(n, self.ramp) * path["linear_speed_m_s"] / fps
        unit = np.sin(2.0 * np.pi * s / path["sway_wavelength_m"])
        step = math.radians(path["angular_speed_deg_s"]) / fps
        amp = step / np.abs(np.diff(unit[self.ramp:])).mean()
        if amp > math.pi / 3:
            raise ValueError(f"a sway of {math.degrees(amp):.1f} degrees: "
                             f"sway_wavelength_m is too long for the "
                             f"angular speed")
        self.sway_deg = math.degrees(amp)
        look, pitch = math.radians(path["look_deg"]), math.radians(
            path["pitch_deg"])
        if path["sway_about"] == "world":
            R = np.stack([pitched(look + a, pitch) for a in amp * unit])
        else:
            c, sn = np.cos(amp * unit), np.sin(amp * unit)
            zero, one = np.zeros(n), np.ones(n)
            pan = np.stack([np.stack([c, zero, sn], -1),
                            np.stack([zero, one, zero], -1),
                            np.stack([-sn, zero, c], -1)], -2)
            R = pan @ pitched(look, pitch)
        zero = np.zeros(n)
        centers = np.stack([s, zero, np.full(n, -self.height)], -1)
        self.R = R
        self.t = -np.einsum("nij,nj->ni", R, centers)
        self.centers = centers
        self.speed_m_s = float(np.linalg.norm(
            np.diff(centers[self.ramp:], axis=0), axis=-1).mean() * fps)
        self.speed_deg_s = float(np.degrees(rotation_angle(
            R[self.ramp + 1:], R[self.ramp:-1])).mean() * fps)

    def index(self, k: int) -> int:
        """Route frame ``k``: nothing folds back."""
        if not 0 <= k < self.n_unique:
            raise IndexError(f"frame {k} of a route of {self.n_unique}")
        return k


def pitched(heading: float, pitch: float) -> np.ndarray:
    """The world -> camera rotation (3, 3) of a camera looking ``pitch``
    below the horizon towards ``heading`` (rad about the world's z from
    +x), its x axis level: rows the camera's axes, the image's bottom
    towards the ground under it (the ground lies at +z of the camera)."""
    c, s = math.cos(heading), math.sin(heading)
    fwd = np.array([math.cos(pitch) * c, math.cos(pitch) * s,
                    math.sin(pitch)])
    right = np.array([-s, c, 0.0])
    return np.stack([right, np.cross(fwd, right), fwd])


def border_rays(cam, image_size, every: int = 8) -> np.ndarray:
    """Camera rays (M, 3) through the image's border pixels, every
    ``every`` pixels and the corners."""
    W, H = image_size
    xs = np.unique(np.r_[np.arange(0, W, every), W - 1])
    ys = np.unique(np.r_[np.arange(0, H, every), H - 1])
    pix = np.concatenate([np.stack([xs, np.zeros_like(xs)], -1),
                          np.stack([xs, np.full_like(xs, H - 1)], -1),
                          np.stack([np.zeros_like(ys), ys], -1),
                          np.stack([np.full_like(ys, W - 1), ys], -1)])
    z1 = unproject(torch.as_tensor(pix, dtype=torch.float64), cam).numpy()
    return np.concatenate([z1, np.ones_like(z1[:, :1])], -1)


def ground_bounds(rays: np.ndarray, R: np.ndarray, t: np.ndarray):
    """Each frame's (x0, y0, x1, y1) on the plane: the box around the
    ground its border ``rays`` meet and the point under the camera, which
    holds every point of the plane or a box the frame sees. Raises where a
    ray runs within ``MIN_RAY_DROP`` of the horizon."""
    R_wc = np.swapaxes(R, -1, -2)
    origin = -np.einsum("nij,nj->ni", R_wc, t)
    d = np.einsum("nij,mj->nmi", R_wc, rays)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if d[..., 2].min() < MIN_RAY_DROP:
        raise ValueError("the route's view reaches the horizon: pitch the "
                         "camera further down")
    reach = -origin[:, None, 2:] / d[..., 2:]
    hit = origin[:, None, :2] + reach * d[..., :2]
    xy = np.concatenate([hit, origin[:, None, :2]], 1)
    return np.concatenate([xy.min(1), xy.max(1)], -1)


def make_path(cfg: dict, n_frames: int | None = None):
    """The configuration's path: a ``Path`` (an arc) or, with ``"kind":
    "route"``, a ``Route`` of ``n_frames``."""
    path, fps = cfg["path"], cfg["camera"]["fps"]
    kind = path.get("kind", "arc")
    if kind == "arc":
        return Path(path, fps)
    if kind != "route":
        raise ValueError(f"path kind {kind!r}: 'arc' or 'route'")
    if n_frames is None:
        raise ValueError("a route needs its number of frames (the mix's "
                         "explore)")
    return Route(path, fps, n_frames)


# -- the scene ----------------------------------------------------------------

def make_texture(g: torch.Generator, device,
                 size=(TEX_SIZE, TEX_SIZE)) -> torch.Tensor:
    """synth.make_texture's multi-scale noise in [10, 245], from ``g``, of
    ``size`` (rows, columns) texels, each a multiple of 32."""
    Sv, Su = size

    def up(a, mode):
        return F.interpolate(a[None, None], size=(Sv, Su), mode=mode)[0, 0]

    def rand(n):
        return torch.rand((Sv // n, Su // n), generator=g, device=device)

    base = rand(1)
    coarse = up(rand(8), "bicubic")
    mid = up(rand(32), "nearest")
    blocks = up((rand(4) > 0.5).float(), "nearest")
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
    Sv, Su = tex.shape
    u, v = uv[..., 0], uv[..., 1]
    fu0, fv0 = torch.floor(u), torch.floor(v)
    fu, fv = u - fu0, v - fv0
    u0 = torch.remainder(fu0.to(torch.int64), Su)
    v0 = torch.remainder(fv0.to(torch.int64), Sv)
    u1, v1 = torch.remainder(u0 + 1, Su), torch.remainder(v0 + 1, Sv)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def render(ray_cam, R_cw, t_cw, tex, boxes, tex_origin=None):
    """Frames (B, H, W) float32: the plane and the boxes (the nearest hit,
    shaded by face as synth.render_scene shades them) along the camera
    rays ``ray_cam`` (H, W, 3), through the poses R_cw (B, 3, 3), t_cw
    (B, 3). Texel (0, 0) lies at the world's origin, or at ``tex_origin``
    (x, y) where given."""
    origin = -torch.einsum("bji,bj->bi", R_cw, t_cw)[:, None, None]
    dir_w = ray_cam @ R_cw[:, None]
    dz = dir_w[..., 2]
    s_plane = -origin[..., 2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
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
    ground = p_w[..., :2] if tex_origin is None else p_w[..., :2] - tex_origin
    vals = _tex_sample(tex, ground * TEX_SCALE) * best_shade
    return torch.where(hit_any, vals, 0.0)


#: Texels of texture beyond the ground a route's frames see, on every side.
TEX_MARGIN = 8
#: A route's frames rendered at a time, each with the boxes any of them
#: can reach, before they go to the host.
RENDER_CHUNK = 8


class Sequence:
    """A configuration's frames for one seed: ``frames`` (n_unique, H, W)
    uint8 on the host, the ground truth ``R``, ``t`` (n_unique, ...) float64
    world -> camera, the ``boxes`` (float64 NumPy) and ``index(k)``.
    ``n_frames``: a route's length (``make_path``)."""

    def __init__(self, cfg: dict, seed: int, device, n_frames=None):
        W, H = cfg["camera"]["image_size"]
        self.image_size = (W, H)
        self.cam = camera(cfg["camera"]["params"], (W, H))
        self.path = make_path(cfg, n_frames)
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device),
            indexing="ij")
        z1 = unproject(torch.stack([xs, ys], -1), self.cam)
        rays = torch.cat([z1, torch.ones_like(z1[..., :1])], -1)
        R = torch.as_tensor(self.path.R, dtype=torch.float32, device=device)
        t = torch.as_tensor(self.path.t, dtype=torch.float32, device=device)
        if isinstance(self.path, Route):
            self.frames, boxes = self._fly(cfg["scene"]["boxes"], g, rays, R,
                                           t, device)
        else:
            tex = make_texture(g, device)
            boxes = make_boxes(g, cfg["scene"]["boxes"], device)
            frames = torch.cat([
                render(rays, R[i:i + 1], t[i:i + 1], tex, boxes).clamp(
                    0, 255).to(torch.uint8)
                for i in range(self.path.n_unique)])
            self.frames = frames.cpu().numpy()
        self.boxes = boxes.double().cpu().numpy()
        self.R, self.t = self.path.R, self.path.t
        self.n_unique = self.path.n_unique

    def _fly(self, spec, g, rays, R, t, device):
        """A route's frames: a texture over all the ground its frames see
        (``tex_extent``, x0 y0 x1 y1), boxes drawn over it at ``per_m2`` a
        square metre, and the frames rendered ``RENDER_CHUNK`` at a time
        with the boxes their views can reach."""
        bounds = ground_bounds(border_rays(self.cam, self.image_size),
                               self.path.R, self.path.t)
        pad = TEX_MARGIN / TEX_SCALE
        lo = bounds[:, :2].min(0) - pad
        size = np.ceil((bounds[:, 2:].max(0) + pad - lo) * TEX_SCALE / 32.0)
        Su, Sv = (int(n) * 32 for n in size)
        self.tex_extent = (*lo, *(lo + np.array([Su, Sv]) / TEX_SCALE))
        tex = make_texture(g, device, (Sv, Su))
        self.tex_size = (Sv, Su)
        x0, y0, x1, y1 = self.tex_extent
        n_boxes = int(round(spec["per_m2"] * (x1 - x0) * (y1 - y0)))
        boxes = make_boxes(g, dict(spec, n=n_boxes, cx=[x0, x1],
                                   cy=[y0, y1]), device)
        b = boxes.double().cpu().numpy()
        origin = torch.as_tensor(lo, dtype=torch.float32, device=device)
        W, H = self.image_size
        frames = np.empty((self.path.n_unique, H, W), dtype=np.uint8)
        for c0 in range(0, len(frames), RENDER_CHUNK):
            c1 = min(c0 + RENDER_CHUNK, len(frames))
            fx0, fy0 = bounds[c0:c1, :2].min(0)
            fx1, fy1 = bounds[c0:c1, 2:].max(0)
            near = np.flatnonzero(
                (b[:, 0] + b[:, 2] >= fx0) & (b[:, 0] - b[:, 2] <= fx1)
                & (b[:, 1] + b[:, 2] >= fy0) & (b[:, 1] - b[:, 2] <= fy1))
            frames[c0:c1] = render(rays, R[c0:c1], t[c0:c1], tex,
                                   boxes[near], origin).clamp(0, 255).to(
                                       torch.uint8).cpu().numpy()
        return frames, boxes

    def index(self, k: int) -> int:
        return self.path.index(k)

    def frame(self, k: int) -> np.ndarray:
        return self.frames[self.index(k)]
