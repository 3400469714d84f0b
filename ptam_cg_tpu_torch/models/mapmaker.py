"""Mapping jobs of keyframe integration (port of the job functions of
``ptam_cg_tpu.models.mapmaker``; the ``MapMaker`` scheduler is not
ported yet).

Keyframe integration inserts the new keyframe, writes the tracker's
measurements, re-finds every map point in it (``refind_in_kf``), then
grows the map along epipolar segments against the closest keyframe, one
pyramid level at a time in the order 3, 0, 1, 2
(``add_points_epipolar``). Every data-dependent choice of the JAX program
is a masked form here: free map slots are ranked with cumulative sums and
written by ``map_state.scatter_drop``, so no host read decides a shape;
keyframe indices stay tensors (``map_state.kf_row``), so none is read on
the host either.
The window gathers go through kernel K2; the (C, N) ZMSSD cross term is a
plain float32 matrix product (TF32 must stay off).

``refind_in_kf``, ``add_points_epipolar`` and the integration programs
take an optional ``diag`` dict. When given, they record per point or per
candidate the ZMSSD of the best match, its gap to the second best, the
last squared subpixel step and (for candidates) the squared distance to
the nearest measurement that thins them, so a parity check can tell a
float-noise decision from a real difference (``utils/parity.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models.keyframe import FrameFeatures
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.ops import patch as patchops
from ptam_cg_tpu_torch.ops.gather import gather_windows
from ptam_cg_tpu_torch.utils import geometry
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor

MAX_SSD = 8 * 8 * 500.0

#: Epipolar expansion level order (AddSomeMapPoints: levels 3, 0, 1, 2).
EPI_LEVEL_ORDER = (3, 0, 1, 2)


def _kf_pose(m: MapState, k) -> SE3:
    return SE3(ms.kf_row(m.kf_R, k), ms.kf_row(m.kf_t, k))


def _second_min(scores: Tensor, best: Tensor) -> Tensor:
    """The smallest score of each row once its ``best`` entry is masked."""
    return torch.min(scores.scatter(1, best[:, None], patchops.BIG),
                     dim=-1).values


@functools.lru_cache(maxsize=None)
def _level_offsets_xy(H: int, W: int, device) -> Tensor:
    """(LEVELS, 2) atlas (x, y) of each level's top-left pixel (made once
    per device: a host-to-device copy waits for the device)."""
    return torch.tensor([[c, r] for (r, c) in levelops.level_offsets(H, W)],
                        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Keyframe distances and heuristics
# ---------------------------------------------------------------------------

def closest_kf(m: MapState, k) -> Tensor:
    """Index of the nearest other valid keyframe (ClosestKeyFrame); the
    first one on a tie, as ``jnp.argmin``."""
    d = ms.closest_kf_distances(m, _kf_pose(m, k))
    d = torch.where(torch.arange(d.shape[0], device=d.device) == k,
                    float("inf"), d)
    return torch.argmin(d)


def need_new_kf(m: MapState, pose: SE3, depth_mean, wiggle_depth_norm,
                max_dist_mult: float) -> Tensor:
    """IsNeedNewKeyFrame: the nearest keyframe, in units of scene depth,
    is farther than ``max_dist_mult * wiggle_depth_norm``."""
    d = ms.closest_kf_distances(m, pose)
    dist = torch.min(d) / torch.clamp(torch.as_tensor(depth_mean), min=1e-6)
    return dist > max_dist_mult * wiggle_depth_norm


# ---------------------------------------------------------------------------
# Epipolar map-point creation (one pyramid level at a time)
# ---------------------------------------------------------------------------

def add_points_epipolar(m: MapState, src_kf, tgt_kf, level: int,
                        cam: atan.Camera, image_size, wiggle_scale: float,
                        thin_radius: float = 10.0, diag: dict | None = None):
    """ThinCandidates + AddPointEpipolar for every candidate of ``src_kf``
    at ``level``: match along the epipolar segment in ``tgt_kf`` among its
    non-max corners by ZMSSD, refine to sub-pixel, triangulate, and add
    the accepted candidates as map points with measurements in both
    keyframes. Returns (new map, n_added, new-point mask (P,))."""
    W, H = image_size
    P = m.point_pos.shape[0]
    dev = m.point_pos.device
    src_kf = torch.as_tensor(src_kf, device=dev).long()
    tgt_kf = torch.as_tensor(tgt_kf, device=dev).long()
    scale = float(1 << level)
    cand_xy = ms.kf_row(m.kf_cand_xy, src_kf)[level].to(torch.float32)
    cand_ok = ms.kf_row(m.kf_cand_valid, src_kf)[level]          # (C,)
    C = cand_xy.shape[0]
    lev_c = torch.full((C,), level, dtype=torch.int64, device=dev)
    src_pose = _kf_pose(m, src_kf)
    tgt_pose = _kf_pose(m, tgt_kf)

    # --- ThinCandidates: drop candidates near measurements at this level
    # or one higher.
    meas_level = ms.kf_row(m.meas_level, src_kf)
    busy = ms.kf_row(m.meas_valid, src_kf) & ((meas_level == level)
                                              | (meas_level == level + 1))
    busy_pos = ms.kf_row(m.meas_pos, src_kf) / scale
    d2 = torch.sum((cand_xy[:, None, :] - busy_pos[None]) ** 2, dim=-1)
    thin_d2 = torch.min(torch.where(busy[None, :], d2, float("inf")),
                        dim=-1).values
    cand_ok = cand_ok & (thin_d2 >= thin_radius ** 2)

    # --- Source ray and epipolar segment in the target view.
    root_pos = levelops.level_zero_pos(cand_xy, lev_c)
    z1_src = atan.unproject(root_pos, cam)
    ray_sc = torch.cat([z1_src, torch.ones_like(z1_src[:, :1])], dim=-1)
    ray_sc = ray_sc / torch.linalg.vector_norm(ray_sc, dim=-1, keepdim=True)
    ray_tc = (ray_sc @ src_pose.R) @ tgt_pose.R.T

    depth_mean = ms.kf_row(m.kf_depth_mean, src_kf)
    depth_sigma = ms.kf_row(m.kf_depth_sigma, src_kf)
    start_depth = torch.clamp(depth_mean - depth_sigma, min=wiggle_scale)
    end_depth = torch.clamp(depth_mean + depth_sigma, max=40.0 * wiggle_scale)

    cam_center_w = -(src_pose.R.T @ src_pose.t)
    cam_center_t = tgt_pose.R @ cam_center_w + tgt_pose.t
    ray_start = cam_center_t[None] + start_depth * ray_tc
    ray_end = cam_center_t[None] + end_depth * ray_tc
    geom_ok = (ray_end[:, 2] > ray_start[:, 2]) & (ray_end[:, 2] > 0.0)
    # Nudge the start in front of the camera if needed.
    need = ray_start[:, 2] <= 0.0
    tshift = (0.001 - ray_start[:, 2]) / torch.where(
        torch.abs(ray_tc[:, 2]) < 1e-12, 1e-12, ray_tc[:, 2])
    ray_start = torch.where(need[:, None],
                            ray_start + tshift[:, None] * ray_tc, ray_start)

    v2a = ray_start[:, :2] / ray_start[:, 2:3]
    v2b = ray_end[:, :2] / ray_end[:, 2:3]
    along = v2a - v2b
    seg_len2 = torch.sum(along * along, dim=-1)
    geom_ok = geom_ok & (seg_len2 >= 1e-8)
    along = along / torch.sqrt(torch.clamp(seg_len2, min=1e-12))[:, None]
    normal = torch.stack([along[:, 1], -along[:, 0]], dim=-1)
    norm_dist = torch.sum(v2a * normal, dim=-1)
    geom_ok = geom_ok & (torch.abs(norm_dist) <= cam.largest_radius)
    pa = torch.sum(along * v2a, dim=-1)
    pb = torch.sum(along * v2b, dim=-1)
    min_len = torch.clamp(torch.minimum(pa, pb) - 0.05, -2.0, 2.0)
    max_len = torch.clamp(torch.maximum(pa, pb) + 0.05, -2.0, 2.0)

    # --- Source templates: unwarped 8x8 at the candidate (K2).
    cand_atlas = levelops.atlas_pos(cand_xy, lev_c, H, W)
    src_b = torch.stack(levelops.level_bounds(lev_c, H, W), dim=-1)
    eye = torch.eye(2, dtype=torch.float32, device=dev).expand(C, 2, 2)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, src_kf.expand(C), cand_atlas, eye, src_b)

    # --- Target corners at this level, on the z=1 plane.
    corners = ms.kf_row(m.kf_max_xy, tgt_kf)[level].to(torch.float32)
    corners_valid = ms.kf_row(m.kf_max_valid, tgt_kf)[level]     # (N,)
    N = corners.shape[0]
    lev_n = torch.full((N,), level, dtype=torch.int64, device=dev)
    corner_z1 = atan.unproject(levelops.level_zero_pos(corners, lev_n), cam)

    # Two-term dot products written out, so the CPU and the card round
    # them alike.
    def dot2(a, b):
        return a[None, :, 0] * b[:, None, 0] + a[None, :, 1] * b[:, None, 1]

    max_dist = cam.one_pixel_dist * (4.0 + 1.0 * scale)
    dd = norm_dist[:, None] - dot2(corner_z1, normal)            # (C, N)
    along_pos = dot2(corner_z1, along)
    pair_ok = ((dd * dd <= max_dist * max_dist)
               & (along_pos >= min_len[:, None])
               & (along_pos <= max_len[:, None])
               & corners_valid[None, :])

    # --- ZMSSD of every (candidate, corner) pair: one matrix product.
    tgt_atlas = ms.kf_row(m.kf_atlas, tgt_kf)
    corner_atlas = levelops.atlas_pos(corners, lev_n, H, W)
    origin = corner_atlas.to(torch.int32) - 4                   # (x, y)
    I = gather_windows(tgt_atlas, origin[:, 1], origin[:, 0],
                       8).reshape(N, 64)
    T = templates.reshape(C, 64)
    SA = torch.sum(T, dim=-1)
    SB = torch.sum(I, dim=-1)
    ST2 = torch.sum(T * T, dim=-1)
    SI2 = torch.sum(I * I, dim=-1)
    cross = T @ I.T                                              # (C, N)
    zmssd = ((2.0 * SA[:, None] * SB[None] - SA[:, None] ** 2
              - SB[None] ** 2) / 64.0
             + SI2[None] + ST2[:, None] - 2.0 * cross)
    zmssd = torch.where(pair_ok, zmssd, patchops.BIG)
    best_n = torch.argmin(zmssd, dim=-1)      # the first minimum, as jnp
    best_ssd = torch.gather(zmssd, 1, best_n[:, None])[:, 0]
    found = best_ssd < MAX_SSD

    # --- Sub-pixel refinement on the target (windows gathered by K2).
    tgt_b = torch.stack(levelops.level_bounds(lev_c, H, W), dim=-1)
    sp = patchops.subpix_refine(tgt_atlas, templates, corner_atlas[best_n],
                                tgt_b, max_its=10)
    accepted = cand_ok & geom_ok & tmpl_ok & found & sp.converged

    # --- Triangulate.
    offs = _level_offsets_xy(H, W, dev)[level]
    tgt_l0 = levelops.level_zero_pos(sp.pos - offs, lev_c)
    z1_tgt = atan.unproject(tgt_l0, cam)
    src_from_tgt = se3lib.mul(src_pose, se3lib.inv(tgt_pose))
    p_tgt = geometry.triangulate(src_from_tgt, z1_src, z1_tgt)
    p_world = se3lib.apply(se3lib.inv(tgt_pose), p_tgt)

    # --- Map slots for accepted candidates: the r-th accepted candidate
    # takes the r-th free slot; past the last free slot the index is P,
    # which every scatter below drops.
    free = ~m.point_valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    free_idx = ms.scatter_drop(
        torch.full((C,), P, dtype=torch.int64, device=dev),
        torch.where(free & (free_rank < C), free_rank, C),
        torch.arange(P, device=dev))
    rank = torch.cumsum(accepted.to(torch.int64), 0) - 1
    slot = torch.where(accepted, free_idx[torch.clamp(rank, 0, C - 1)], P)
    ok_slot = accepted & (slot < P)
    n_added = torch.sum(ok_slot.to(torch.int32))

    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(cand_xy, lev_c, cam)

    def scat(table, values):
        return ms.scatter_drop(table, slot, values)

    new_m = dataclasses.replace(
        m,
        point_pos=scat(m.point_pos, p_world),
        point_valid=scat(m.point_valid, True),
        point_src_kf=scat(m.point_src_kf, src_kf.expand(C)),
        point_src_level=scat(m.point_src_level, lev_c),
        point_center=scat(m.point_center, cand_xy),
        point_center_nc=scat(m.point_center_nc, c_nc),
        point_right_nc=scat(m.point_right_nc, r_nc),
        point_down_nc=scat(m.point_down_nc, d_nc),
        point_normal_nc=scat(m.point_normal_nc, nrm),
        point_inlier=scat(m.point_inlier, 0),
        point_outlier=scat(m.point_outlier, 0),
        point_source=scat(m.point_source, ms.SRC_EPIPOLAR))
    new_m = ms.refresh_pixel_vectors(new_m)

    # --- Measurements in both keyframes.
    new_m = ms.set_measurements(
        new_m, src_kf, slot, root_pos, lev_c, torch.ones_like(ok_slot),
        torch.full_like(lev_c, ms.SRC_ROOT), ok_slot)
    new_m = ms.set_measurements(
        new_m, tgt_kf, slot, tgt_l0, lev_c, torch.ones_like(ok_slot),
        torch.full_like(lev_c, ms.SRC_EPIPOLAR), ok_slot)

    if diag is not None:
        diag.update(cand_xy=cand_xy, ssd=best_ssd,
                    margin=_second_min(zmssd, best_n) - best_ssd,
                    step=sp.last_step, thin_d2=thin_d2)
    new_mask = scat(torch.zeros(P, dtype=torch.bool, device=dev), True)
    return new_m, n_added, new_mask


# ---------------------------------------------------------------------------
# Re-find data association
# ---------------------------------------------------------------------------

def refind_in_kf(m: MapState, k, point_mask: Tensor, cam: atan.Camera,
                 image_size, range_l0: float = 4.0,
                 diag: dict | None = None):
    """ReFind_Common over every selected point in keyframe ``k``: project,
    warp a template from its source keyframe, ZMSSD-search a radius of
    ``range_l0`` level-0 px (16x16 windows, 9x9 corner masks), sub-pixel
    refine above level 0. Failures are never retried in ``k``.
    Returns (map, n_found)."""
    W, H = image_size
    P = m.point_pos.shape[0]
    dev = m.point_pos.device
    k = torch.as_tensor(k, device=dev).long()
    pose = _kf_pose(m, k)

    active = (point_mask & m.point_valid & ms.kf_row(m.kf_valid, k)
              & ~ms.kf_row(m.meas_valid, k) & ~ms.kf_row(m.never_retry, k))

    p_cam = m.point_pos @ pose.R.T + pose.t
    z = p_cam[:, 2]
    z_ok = z > 0.001
    safe_z = torch.where(z_ok, z, 1.0)
    z1 = p_cam[:, :2] / safe_z[:, None]
    r_ok = torch.sum(z1 * z1, dim=-1) <= cam.largest_radius ** 2
    pix = atan.project(z1, cam)
    in_im = ((pix[:, 0] >= 0) & (pix[:, 1] >= 0)
             & (pix[:, 0] <= W) & (pix[:, 1] <= H))
    proj_ok = z_ok & r_ok & in_im

    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w, m.point_down_w,
        atan.project_derivs(z1, cam))
    level = warp.level
    scale = levelops.level_scale(level)

    src_level = m.point_src_level.long()
    src_center = levelops.atlas_pos(m.point_center, src_level, H, W)
    m2 = patchops.inv2x2(warp.warp_inv) * scale[..., None, None]
    src_b = torch.stack(levelops.level_bounds(src_level, H, W), dim=-1)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, m.point_src_kf, src_center, m2, src_b)

    searchable = active & proj_ok & warp.good & tmpl_ok
    centers = levelops.atlas_pos(levelops.level_n_pos(pix, level), level,
                                 H, W)
    radius = torch.ceil(range_l0 / scale)
    bounds = torch.stack(levelops.level_bounds(level, H, W), dim=-1)
    atlas = ms.kf_row(m.kf_atlas, k)
    res, win, win_origin = patchops.ssd_search(
        atlas, ms.kf_row(m.kf_corner_mask, k), templates, centers, radius,
        bounds, r_win=4, max_ssd=MAX_SSD)
    found = searchable & res.found

    # Sub-pixel refinement above level 0.
    sp = patchops.subpix_refine(atlas, templates, res.pos, bounds, max_its=8,
                                windows=win, win_origin=win_origin)
    use_sp = found & (level > 0)
    pos_atlas = torch.where(use_sp[:, None], sp.pos, res.pos)
    offs = _level_offsets_xy(H, W, dev)[level]
    pos_l0 = levelops.level_zero_pos(pos_atlas - offs, level)

    # Every failure is never retried in this keyframe.
    never = m.never_retry.clone()
    ms.set_kf_row(never, k, ms.kf_row(m.never_retry, k) | (active & ~found))
    new_m = ms.set_measurements(
        dataclasses.replace(m, never_retry=never), k,
        torch.arange(P, device=dev), pos_l0, level, use_sp,
        torch.full((P,), ms.SRC_REFIND, dtype=torch.int32, device=dev), found)
    if diag is not None:
        diag.update(ssd=res.ssd, margin=res.margin,
                    step=torch.where(use_sp, sp.last_step, 0.0))
    return new_m, torch.sum(found.to(torch.int32))


# ---------------------------------------------------------------------------
# Keyframe integration
# ---------------------------------------------------------------------------

def integrate_insert_program(m: MapState, features: FrameFeatures, pose: SE3,
                             meas_point: Tensor, meas_pos: Tensor,
                             meas_level: Tensor, meas_subpix: Tensor,
                             meas_valid: Tensor, depth_mean, depth_sigma,
                             cam: atan.Camera, image_size,
                             diag: dict | None = None):
    """Integration phase 0 (AddKeyFrameFromTopOfQueue): the first free
    keyframe slot, insert (in place), the tracker's measurements, then a
    re-find of every map point in the new keyframe.
    Returns (map, slot as a 0-dim int32 tensor)."""
    slot = torch.argmin(m.kf_valid.to(torch.int32))
    m = ms.insert_keyframe(m, slot, features, pose, depth_mean, depth_sigma)
    m = ms.set_measurements(
        m, slot, meas_point, meas_pos, meas_level, meas_subpix,
        torch.full_like(meas_level, ms.SRC_TRACKER), meas_valid)
    m, _ = refind_in_kf(m, slot, m.point_valid, cam, image_size, diag=diag)
    return m, slot.to(torch.int32)


def integrate_epi_program(m: MapState, slot, new_point_mask: Tensor, total,
                          level: int, cam: atan.Camera, image_size,
                          wiggle_scale: float, thin_radius: float,
                          diag: dict | None = None):
    """One epipolar level of keyframe integration (AddSomeMapPoints)
    against the keyframe closest to ``slot``.
    Returns (map, new-point mask, running total of added points)."""
    tgt = closest_kf(m, slot)
    m, n, mask = add_points_epipolar(m, slot, tgt, level, cam, image_size,
                                     wiggle_scale, thin_radius, diag=diag)
    return m, new_point_mask | mask, total + n


def integrate_keyframe_program(m: MapState, features: FrameFeatures,
                               pose: SE3, meas_point: Tensor,
                               meas_pos: Tensor, meas_level: Tensor,
                               meas_subpix: Tensor, meas_valid: Tensor,
                               depth_mean, depth_sigma,
                               new_point_mask: Tensor, cam: atan.Camera,
                               image_size, wiggle_scale: float,
                               thin_radius: float, diag: dict | None = None):
    """Whole keyframe integration: ``integrate_insert_program`` then the
    four ``integrate_epi_program`` levels. ``m``'s keyframe buffers are
    written in place. With ``diag``, its "refind" entry and one entry per
    level (keyed by the level) hold the jobs' diagnostics.
    Returns (map, new_point_mask | added, (slot, n_added) int32)."""
    def sub(key):
        if diag is None:
            return None
        return diag.setdefault(key, {})

    m, slot = integrate_insert_program(
        m, features, pose, meas_point, meas_pos, meas_level, meas_subpix,
        meas_valid, depth_mean, depth_sigma, cam, image_size,
        diag=sub("refind"))
    total = torch.zeros((), dtype=torch.int32, device=slot.device)
    for lev in EPI_LEVEL_ORDER:
        m, new_point_mask, total = integrate_epi_program(
            m, slot, new_point_mask, total, lev, cam, image_size,
            wiggle_scale, thin_radius, diag=sub(lev))
    return m, new_point_mask, torch.stack([slot, total.to(torch.int32)])

