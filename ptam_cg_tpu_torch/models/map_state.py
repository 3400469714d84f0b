"""MapState: the static-capacity SLAM map as a dataclass of tensors (port
of ``ptam_cg_tpu.models.map_state``).

Fields, shapes and dtypes match the JAX package's MapState one for one.
``insert_keyframe`` writes in place (the keyframe atlases are the map's
largest buffers), so a caller that needs the map as it was copies it
first (``copy_map``); the other functions return new tensors for the
fields they change.

Where the JAX package scatters with ``.at[idx].set(..., mode="drop")``,
the port scatters into a buffer one row longer and drops that row: the
dropped entries all carry the index past the end, so no host read is
needed to select the kept ones.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ptam_cg_tpu_torch.config import LEVELS
from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models.keyframe import (CAND_CAP, NONMAX_CAP,
                                               FrameFeatures, TrackFeatures)
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor

# Measurement source enum (ref: include/KeyFrame.h:50).
SRC_TRACKER = 0
SRC_REFIND = 1
SRC_ROOT = 2
SRC_TRAIL = 3
SRC_EPIPOLAR = 4


@dataclasses.dataclass
class MapState:
    # ---- points (capacity P) ----
    point_pos: Tensor          # (P, 3) world position
    point_valid: Tensor        # (P,) bool
    point_src_kf: Tensor       # (P,) int32 source keyframe slot
    point_src_level: Tensor    # (P,) int32 source pyramid level
    point_center: Tensor       # (P, 2) centre in source-level coords
    point_center_nc: Tensor    # (P, 3) unit ray to the patch centre
    point_right_nc: Tensor     # (P, 3) unit ray one pixel right
    point_down_nc: Tensor      # (P, 3) unit ray one pixel down
    point_normal_nc: Tensor    # (P, 3) patch normal (source-KF frame)
    point_right_w: Tensor      # (P, 3) world one-pixel-right step
    point_down_w: Tensor       # (P, 3) world one-pixel-down step
    point_inlier: Tensor       # (P,) int32
    point_outlier: Tensor      # (P,) int32
    point_source: Tensor       # (P,) int32 provenance
    # ---- keyframes (capacity K) ----
    kf_R: Tensor               # (K, 3, 3) world -> camera rotation
    kf_t: Tensor               # (K, 3)
    kf_valid: Tensor           # (K,) bool
    kf_fixed: Tensor           # (K,) bool
    kf_atlas: Tensor           # (K, Ha, W) float32, or bfloat16
    kf_corner_mask: Tensor     # (K, Ha, W) bool
    kf_max_xy: Tensor          # (K, LEVELS, NONMAX_CAP, 2) int32
    kf_max_valid: Tensor       # (K, LEVELS, NONMAX_CAP) bool
    kf_cand_xy: Tensor         # (K, LEVELS, CAND_CAP, 2) int32
    kf_cand_score: Tensor      # (K, LEVELS, CAND_CAP) float32
    kf_cand_valid: Tensor      # (K, LEVELS, CAND_CAP) bool
    kf_sbi: Tensor             # (K, h_sbi, w_sbi)
    kf_sbi_jac: Tensor         # (K, h_sbi, w_sbi, 2)
    kf_depth_mean: Tensor      # (K,)
    kf_depth_sigma: Tensor     # (K,)
    # ---- measurements: dense (keyframe, point) matrices ----
    meas_valid: Tensor         # (K, P) bool
    meas_pos: Tensor           # (K, P, 2) level-0 position
    meas_level: Tensor         # (K, P) int32
    meas_subpix: Tensor        # (K, P) bool
    meas_source: Tensor        # (K, P) int32
    never_retry: Tensor        # (K, P) bool
    good: Tensor               # () bool: map initialized


def empty_map(image_size: Tuple[int, int], max_points: int = 2048,
              max_kfs: int = 32, device="cuda",
              atlas_dtype=torch.float32) -> MapState:
    """An all-invalid map (Map::Reset). ``atlas_dtype``: the keyframe
    atlases' storage dtype, ``torch.bfloat16`` under
    ``FrontendConfig.atlas_bf16`` (the JAX package's ``atlas_dtype``)."""
    W, H = image_size
    Ha = H + H // 2
    h_sbi, w_sbi = (H >> 3) // 2, (W >> 3) // 2
    P, K = max_points, max_kfs
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapState(
        point_pos=z((P, 3), f32), point_valid=z(P, b),
        point_src_kf=z(P, i32), point_src_level=z(P, i32),
        point_center=z((P, 2), f32), point_center_nc=z((P, 3), f32),
        point_right_nc=z((P, 3), f32), point_down_nc=z((P, 3), f32),
        point_normal_nc=z((P, 3), f32), point_right_w=z((P, 3), f32),
        point_down_w=z((P, 3), f32), point_inlier=z(P, i32),
        point_outlier=z(P, i32), point_source=z(P, i32),
        kf_R=torch.eye(3, dtype=f32, device=device).repeat(K, 1, 1),
        kf_t=z((K, 3), f32), kf_valid=z(K, b), kf_fixed=z(K, b),
        kf_atlas=z((K, Ha, W), atlas_dtype), kf_corner_mask=z((K, Ha, W), b),
        kf_max_xy=z((K, LEVELS, NONMAX_CAP, 2), i32),
        kf_max_valid=z((K, LEVELS, NONMAX_CAP), b),
        kf_cand_xy=z((K, LEVELS, CAND_CAP, 2), i32),
        kf_cand_score=z((K, LEVELS, CAND_CAP), f32),
        kf_cand_valid=z((K, LEVELS, CAND_CAP), b),
        kf_sbi=z((K, h_sbi, w_sbi), f32),
        kf_sbi_jac=z((K, h_sbi, w_sbi, 2), f32),
        kf_depth_mean=torch.ones(K, dtype=f32, device=device),
        kf_depth_sigma=torch.ones(K, dtype=f32, device=device),
        meas_valid=z((K, P), b), meas_pos=z((K, P, 2), f32),
        meas_level=z((K, P), i32), meas_subpix=z((K, P), b),
        meas_source=z((K, P), i32), never_retry=z((K, P), b),
        good=z((), b))


def atlas_dtype(frontend_cfg) -> torch.dtype:
    """The atlases' storage dtype under a ``FrontendConfig``: bfloat16
    with ``atlas_bf16`` (the JAX engine's choice, engine.py:112-113)."""
    return torch.bfloat16 if frontend_cfg.atlas_bf16 else torch.float32


def copy_map(m: MapState) -> MapState:
    """A copy of ``m`` that shares no storage with it (each field keeps
    its dtype)."""
    return dataclasses.replace(m, **{
        f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)})


def kf_row(table: Tensor, k) -> Tensor:
    """``table[k]`` for keyframe ``k``, an int or a 0-dim tensor. A tensor
    is used as a one-element index: indexing with a 0-dim tensor reads it
    on the host, which waits for the device."""
    return table[k.reshape(1)][0] if isinstance(k, Tensor) else table[k]


def set_kf_row(table: Tensor, k, value) -> None:
    """``table[k] = value`` in place, ``k`` as in ``kf_row``."""
    if isinstance(k, Tensor):
        k = k.reshape(1)
        if not isinstance(value, Tensor):   # a Python scalar: no copy
            value = torch.full((), value, dtype=table.dtype,
                               device=table.device)
    table[k] = value


def insert_keyframe(m: MapState, slot, features, pose: SE3,
                    depth_mean=1.0, depth_sigma=1.0,
                    fixed: bool = False) -> MapState:
    """Write a frame's pose, atlas, corner mask, SBI and depth into
    keyframe ``slot`` (an int or a 0-dim tensor), in place; returns ``m``.
    A ``FrameFeatures`` also writes its non-max and candidate lists; the
    slim ``TrackFeatures`` leaves the slot's lists as they are."""
    rows = [(m.kf_R, pose.R), (m.kf_t, pose.t), (m.kf_valid, True),
            (m.kf_fixed, fixed), (m.kf_atlas, features.atlas),
            (m.kf_corner_mask, features.corner_mask)]
    if isinstance(features, FrameFeatures):
        rows += [(m.kf_max_xy, features.max_xy),
                 (m.kf_max_valid, features.max_valid),
                 (m.kf_cand_xy, features.cand_xy),
                 (m.kf_cand_score, features.cand_score),
                 (m.kf_cand_valid, features.cand_valid)]
    elif not isinstance(features, TrackFeatures):
        raise TypeError(f"insert_keyframe: unexpected {type(features)}")
    rows += [(m.kf_sbi, features.sbi.template),
             (m.kf_sbi_jac, features.sbi.jac),
             (m.kf_depth_mean, depth_mean), (m.kf_depth_sigma, depth_sigma)]
    for table, value in rows:
        set_kf_row(table, slot, value)
    return m


def scatter_drop(table: Tensor, idx: Tensor, values) -> Tensor:
    """A copy of ``table`` with ``table[idx[i]] = values[i]``; an index
    equal to ``len(table)`` writes nothing (``.at[idx].set(values,
    mode="drop")``). Kept indices must be unique."""
    buf = torch.cat([table, table[:1]])
    if isinstance(values, Tensor):
        values = values.to(table.dtype)
    else:   # a Python scalar: a fill on the device, no host copy
        values = torch.full(idx.shape, values, dtype=table.dtype,
                            device=table.device)
    buf[idx] = values
    return buf[:-1]


def set_measurements(m: MapState, kf, point_idx: Tensor, pos: Tensor,
                     level: Tensor, subpix: Tensor, source: Tensor,
                     valid: Tensor) -> MapState:
    """Write a batch of measurements into keyframe ``kf``'s dense row;
    only entries with ``valid`` and an index in range are written (their
    indices are unique)."""
    P = m.point_pos.shape[0]
    ok = valid & (point_idx >= 0) & (point_idx < P)
    idx = torch.where(ok, point_idx, P).long()

    def wr(table, values):
        out = table.clone()
        set_kf_row(out, kf, scatter_drop(kf_row(table, kf), idx, values))
        return out

    return dataclasses.replace(
        m, meas_valid=wr(m.meas_valid, True), meas_pos=wr(m.meas_pos, pos),
        meas_level=wr(m.meas_level, level),
        meas_subpix=wr(m.meas_subpix, subpix),
        meas_source=wr(m.meas_source, source))


def scene_depth_for_kf(m: MapState, k):
    """Mean and standard deviation of the depths of keyframe ``k``'s
    measured points (RefreshSceneDepth). Returns (mean, sigma)."""
    sel = kf_row(m.meas_valid, k) & m.point_valid
    z = (m.point_pos @ kf_row(m.kf_R, k).T + kf_row(m.kf_t, k))[:, 2]
    n = torch.clamp(torch.sum(sel.to(torch.float32)), min=1.0)
    mean = torch.sum(torch.where(sel, z, 0.0)) / n
    var = torch.sum(torch.where(sel, z * z, 0.0)) / n - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def make_point_rays(center_level_xy: Tensor, level: Tensor, cam: atan.Camera):
    """Source-KF unit rays through a patch centre and its one-pixel
    neighbours, and the patch normal (-z, facing the camera). Returns
    (center_nc, right_nc, down_nc, normal_nc)."""
    p0 = levelops.level_zero_pos(center_level_xy, level)
    one = levelops.level_scale(level)[..., None]

    def unproj_ray(pix):
        z1 = atan.unproject(pix, cam)
        ray = torch.cat([z1, torch.ones_like(z1[..., :1])], dim=-1)
        return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)

    zero = torch.zeros_like(p0[..., 0])
    ones = torch.ones_like(p0[..., 0])
    dx = torch.stack([ones, zero], dim=-1)
    dy = torch.stack([zero, ones], dim=-1)
    center_nc = unproj_ray(p0)
    normal = torch.zeros_like(center_nc)
    normal[..., 2] = -1.0
    return (center_nc, unproj_ray(p0 + dx * one), unproj_ray(p0 + dy * one),
            normal)


def refresh_pixel_vectors(m: MapState) -> MapState:
    """World pixel-step vectors of every point (RefreshPixelVectors)."""
    src = m.point_src_kf.long()
    R = m.kf_R[src]
    t = m.kf_t[src]
    plane_pt_c = (R @ m.point_pos[..., None])[..., 0] + t
    normal = m.point_normal_nc
    cam_height = torch.abs(torch.sum(plane_pt_c * normal, dim=-1))

    def on_plane(v):
        r = torch.clamp(torch.abs(torch.sum(v * normal, dim=-1)), min=1e-9)
        return v * (cam_height / r)[..., None]

    center_p = on_plane(m.point_center_nc)
    Rt = R.transpose(-1, -2)
    right_w = (Rt @ (on_plane(m.point_right_nc) - center_p)[..., None])[..., 0]
    down_w = (Rt @ (on_plane(m.point_down_nc) - center_p)[..., None])[..., 0]
    return dataclasses.replace(m, point_right_w=right_w, point_down_w=down_w)


def closest_kf_distances(m: MapState, pose: SE3) -> Tensor:
    """Distance from ``pose``'s camera centre to every valid keyframe's
    (inf for invalid slots). ``m``: a MapState or a ``tracker.TrackView``
    (the fields read are among its 14)."""
    c = -(pose.R.transpose(-1, -2) @ pose.t[..., None])[..., 0]
    centers = -(m.kf_R.transpose(-1, -2) @ m.kf_t[..., None])[..., 0]
    d = torch.linalg.vector_norm(centers - c, dim=-1)
    return torch.where(m.kf_valid, d, float("inf"))


def kf_linear_dist(m: MapState, pose: SE3, depth_mean, k) -> Tensor:
    """Camera-centre distance from ``pose`` to keyframe ``k``
    (KeyFrameLinearDist; ``depth_mean`` is unused, as in the JAX package,
    where the caller divides by scene depth)."""
    c1 = -(pose.R.T @ pose.t)
    c2 = -(kf_row(m.kf_R, k).T @ kf_row(m.kf_t, k))
    return torch.linalg.vector_norm(c1 - c2)
