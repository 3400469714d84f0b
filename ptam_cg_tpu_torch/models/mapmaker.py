"""The mapping engine (port of ``ptam_cg_tpu.models.mapmaker``): keyframe
integration, re-find, the epipolar job, bundle adjustment glue, bad-point
GC, the dominant-plane alignment, and the ``MapMaker`` that schedules them
(``step``): the keyframe queue, the phased integration, local and global
BA, the span re-finds of new points and of the failure queue, and GC.

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

Bundle adjustment extracts a compact ``BundleProblem`` from the dense
(keyframe, point) measurement matrix (``extract_bundle_compact``), runs LM
on it (``models/bundle.py``) and writes the result back with the
reference's outlier rules (``apply_bundle``). Every fixed-size selection
(``jnp.nonzero(size=...)``, ``lax.top_k``) is a cumulative-sum compaction
or a stable sort here, so no host read decides a shape and ties break as
in JAX: lower index first.

The ``MapMaker`` runs each job as a program of static buffers
(``MapPrograms``, the JAX MapMaker's jitted jobs): one CUDA graph replay
on the card, the same function eagerly otherwise (``models/graphs.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import (MAX_MEAS_PER_KF, BundleConfig,
                                      MapMakerConfig)
from ptam_cg_tpu_torch.models import bundle as bundlelib
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models.keyframe import FrameFeatures
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.ops import patch as patchops
from ptam_cg_tpu_torch.ops.gather import gather_windows
from ptam_cg_tpu_torch.parallel import sharded_ba
from ptam_cg_tpu_torch.utils import geometry
from ptam_cg_tpu_torch.utils import mest
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils import tree
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
    is farther than ``max_dist_mult * wiggle_depth_norm`` (a float or a
    0-dim tensor). ``m``: a MapState or a ``tracker.TrackView``."""
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
    graphs.note_call("add_points_epipolar")
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
    graphs.note_call("refind_in_kf")
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


def refind_all_kfs(m: MapState, mask2d: Tensor, cam: atan.Camera, image_size,
                   ks: range | None = None):
    """``refind_in_kf`` of every keyframe in ``ks`` (a range of slots, all
    K by default) that has work (``refind_span``). Returns (map, found
    count over the span as a 0-dim int32 tensor)."""
    if ks is None:
        ks = range(m.kf_valid.shape[0])
    k0 = torch.full((), ks.start, dtype=torch.int64,
                    device=m.point_pos.device)
    return refind_span(m, mask2d, k0, len(ks), cam, image_size)


def _store(bufs: MapState, new: MapState) -> MapState:
    """Write ``new`` into the map ``bufs`` field by field (a field that is
    its buffer already is not copied); returns ``bufs``."""
    for f in dataclasses.fields(bufs):
        buf, x = getattr(bufs, f.name), getattr(new, f.name)
        if x is not buf:
            buf.copy_(x)
    return bufs


def refind_span(m: MapState, mask2d: Tensor, k0: Tensor, width: int,
                cam: atan.Camera, image_size):
    """ReFindNewlyMade (a broadcast row of ``mask2d``) or
    ReFindFromFailureQueue (the failure mask) over the ``width`` slots
    from ``k0`` (a 0-dim int64 tensor): ``refind_in_kf`` of each slot with
    work, a valid keyframe with a point selected by its row of the (K, P)
    ``mask2d`` that is valid, not measured there and not marked
    never-retry there. Re-finding keyframe k writes only row k, so the
    span's ``has_work`` is computed once, and equals the JAX scan's
    per-step ``lax.cond``; a slot scanned again has no work left (each
    point it tried is now measured or never-retry). Eagerly ``has_work``
    is read on the host once; on the path a program is captured on, the
    slots are a ``graphs.loop`` (a WHILE node: JAX's scan) and each
    slot's re-find a ``graphs.if_block`` on its ``has_work`` (an IF node:
    the ``lax.cond``). Returns (map, found count as a 0-dim int32
    tensor)."""
    dev = m.point_pos.device
    slots = k0 + torch.arange(width, device=dev)
    has_work = (m.kf_valid[slots] & torch.any(
        mask2d[slots] & m.point_valid & ~m.meas_valid[slots]
        & ~m.never_retry[slots], dim=-1))
    total = torch.zeros((), dtype=torch.int32, device=dev)
    if not graphs.device_predicates():
        for slot, work in zip(slots, has_work.tolist()):
            if work:
                m, n = refind_in_kf(m, slot, ms.kf_row(mask2d, slot), cam,
                                    image_size)
                total = total + n
        return m, total
    i = torch.zeros((), dtype=torch.int64, device=dev)
    more = torch.ones((), dtype=torch.bool, device=dev)
    for _ in graphs.loop(lambda: more):
        with graphs.if_block(ms.kf_row(has_work, i)) as go:
            if go:
                slot = k0 + i
                new, n = refind_in_kf(m, slot, ms.kf_row(mask2d, slot), cam,
                                      image_size)
                m = _store(m, new)
                total.add_(n)
        i.add_(1)
        more.copy_(i < width)
    return m, total


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


def epipolar_job(m: MapState, src_kf, new_point_mask: Tensor, level: int,
                 cam: atan.Camera, image_size, wiggle_scale: float,
                 thin_radius: float, diag: dict | None = None):
    """AddSomeMapPoints: ``add_points_epipolar`` at ``level`` against the
    keyframe closest to ``src_kf``, chosen on the device.
    Returns (map, n_added, new_point_mask | added)."""
    tgt = closest_kf(m, src_kf)
    m, n, mask = add_points_epipolar(m, src_kf, tgt, level, cam, image_size,
                                     wiggle_scale, thin_radius, diag=diag)
    return m, n, new_point_mask | mask


def integrate_epi_program(m: MapState, slot, new_point_mask: Tensor, total,
                          level: int, cam: atan.Camera, image_size,
                          wiggle_scale: float, thin_radius: float,
                          diag: dict | None = None):
    """One epipolar level of keyframe integration (``epipolar_job`` from
    ``slot``). Returns (map, new-point mask, running total of added
    points)."""
    m, n, new_point_mask = epipolar_job(m, slot, new_point_mask, level, cam,
                                        image_size, wiggle_scale,
                                        thin_radius, diag=diag)
    return m, new_point_mask, total + n


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



# ---------------------------------------------------------------------------
# Bundle adjustment: masks, extraction, write-back
# ---------------------------------------------------------------------------

def local_ba_masks(m: MapState, newest, n_neighbors: int = 4):
    """Adjust, fixed and point masks of local BA (BundleAdjustRecent): the
    newest keyframe and its ``n_neighbors`` nearest non-fixed keyframes are
    adjusted; every other keyframe that measures one of their points is
    held fixed. Ties in distance take the lower index, as ``lax.top_k``."""
    K = m.kf_valid.shape[0]
    dev = m.kf_valid.device
    newest = torch.as_tensor(newest, device=dev).long()
    is_newest = torch.arange(K, device=dev) == newest
    d = torch.where(is_newest, float("inf"),
                    ms.closest_kf_distances(m, _kf_pose(m, newest)))
    idx = torch.sort(d, stable=True).indices[:min(n_neighbors, K)]
    near = ms.scatter_drop(torch.zeros(K, dtype=torch.bool, device=dev), idx,
                           torch.isfinite(d[idx]))
    adjust = ((near & ~m.kf_fixed) | is_newest) & m.kf_valid
    pts = torch.any(m.meas_valid & adjust[:, None], dim=0) & m.point_valid
    observers = torch.any(m.meas_valid & pts[None, :], dim=1)
    return adjust, observers & ~adjust & m.kf_valid, pts


#: The smallest BA point cap (``MapMaker._ba_caps``' first floor).
_TIER_P_FLOOR = 1024


def _first_true(mask: Tensor, size: int, fill: int) -> Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` of a 1-D mask:
    the indices of its first ``size`` true entries in order, then
    ``fill``; int64, no host read."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    return ms.scatter_drop(
        torch.full((size,), fill, dtype=torch.int64, device=mask.device),
        torch.where(mask & (rank < size), rank, size),
        torch.arange(mask.shape[0], device=mask.device))


def _select_measurements(m: MapState, include: Tensor, max_meas: int,
                         n: Tensor):
    """``max_meas`` (k, p) measurement indices from the (K, P) ``include``
    table: row-major when they all fit, else PRIORITIZED (ROOT provenance
    first, then measurements of scarcely measured points, then newer
    keyframes; ties to the lower flat index, as ``lax.top_k``). Both are
    computed and one is selected on the device."""
    K, P = include.shape
    dev = include.device
    flat = _first_true(include.reshape(-1), max_meas, 0)
    if max_meas < K * P:
        cnt = torch.sum(include.to(torch.float32), dim=0)           # (P,)
        cnt = torch.clamp(cnt, min=1.0)
        kk = torch.arange(K, dtype=torch.float32, device=dev)
        # Tensor divisions, so the CPU and the card round alike.
        score = (2.0 * (m.meas_source == ms.SRC_ROOT).to(torch.float32)
                 + (torch.full_like(cnt, 4.0) / cnt)[None, :]
                 + 0.5 * (kk / torch.full_like(kk, float(K)))[:, None]
                 + 1.0)
        score = torch.where(include, score, 0.0).reshape(-1)
        top = torch.sort(score, descending=True, stable=True).indices
        flat = torch.where(n <= max_meas, flat, top[:max_meas])
    return (flat // P).to(torch.int32), (flat % P).to(torch.int32)


def _meas_fields(m: MapState, k_idx: Tensor, p_idx: Tensor,
                 mvalid: Tensor) -> dict:
    """The measurement fields of a BundleProblem, read at the global
    (k, p) indices, but its camera and point indices."""
    kl, pl = k_idx.long(), p_idx.long()
    return dict(meas_pos=m.meas_pos[kl, pl],
                meas_sqrt_inv_noise=1.0 / levelops.level_scale(
                    m.meas_level[kl, pl]),
                meas_valid=mvalid, meas_bad=torch.zeros_like(mvalid))


def _include(m: MapState, adjust_kf, fixed_kf, point_mask):
    incl_kf = adjust_kf | fixed_kf
    pt_ok = point_mask & m.point_valid
    include = m.meas_valid & incl_kf[:, None] & pt_ok[None, :]
    return incl_kf, pt_ok, include, torch.sum(include.to(torch.int32))


def extract_bundle(m: MapState, adjust_kf: Tensor, fixed_kf: Tensor,
                   point_mask: Tensor, max_meas: int):
    """Dense measurement matrix -> masked full-capacity BundleProblem
    (BundleAdjust's ID mapping). Returns (problem, meas_k (M,), meas_p (M,),
    n_selected): the true measurement count before the ``max_meas`` cap;
    past the cap the selection is prioritized (``_select_measurements``)."""
    incl_kf, pt_ok, include, n = _include(m, adjust_kf, fixed_kf, point_mask)
    k_idx, p_idx = _select_measurements(m, include, max_meas, n)
    mvalid = torch.arange(max_meas, device=n.device) < n
    prob = bundlelib.BundleProblem(
        cam_R=m.kf_R, cam_t=m.kf_t, cam_fixed=fixed_kf | ~adjust_kf,
        cam_valid=incl_kf, pt_pos=m.point_pos, pt_valid=pt_ok,
        meas_cam=k_idx, meas_pt=p_idx,
        **_meas_fields(m, k_idx, p_idx, mvalid))
    return prob, k_idx, p_idx, n


def extract_bundle_compact(m: MapState, adjust_kf: Tensor, fixed_kf: Tensor,
                           point_mask: Tensor, max_cams: int, max_pts: int,
                           max_meas: int):
    """``extract_bundle`` with the included cameras and observed points
    gathered into (max_cams, max_pts, max_meas)-shaped buffers, so an LM
    step costs what the live map needs, not its capacity.

    Returns ``(prob, meas_k, meas_p, cam_idx, pt_idx, counts)``: ``meas_k``
    and ``meas_p`` are global (K, P) indices, ``cam_idx``/``pt_idx`` map a
    compact slot to its global index (K / P in an unused slot), and
    ``counts`` is the int32 (n_cams, n_pts, n_meas) of true pre-cap sizes.
    """
    K, P = m.meas_valid.shape
    dev = m.meas_valid.device
    incl_kf, pt_ok, include, n = _include(m, adjust_kf, fixed_kf, point_mask)
    pt_used = torch.any(include, dim=0)
    cam_idx = _first_true(incl_kf, max_cams, K)
    pt_idx = _first_true(pt_used, max_pts, P)
    # Global -> compact slot maps; an unincluded or overflowing entry keeps
    # the out-of-range cap value, and its measurements are masked below.
    cam_slot = ms.scatter_drop(
        torch.full((K,), max_cams, dtype=torch.int64, device=dev), cam_idx,
        torch.arange(max_cams, device=dev))
    pt_slot = ms.scatter_drop(
        torch.full((P,), max_pts, dtype=torch.int64, device=dev), pt_idx,
        torch.arange(max_pts, device=dev))

    k_idx, p_idx = _select_measurements(m, include, max_meas, n)
    mc, mp = cam_slot[k_idx.long()], pt_slot[p_idx.long()]
    mvalid = ((torch.arange(max_meas, device=dev) < n) & (mc < max_cams)
              & (mp < max_pts))
    cam_g = torch.clamp(cam_idx, max=K - 1)     # clamped gathers; the fill
    pt_g = torch.clamp(pt_idx, max=P - 1)       # slots stay invalid
    prob = bundlelib.BundleProblem(
        cam_R=m.kf_R[cam_g], cam_t=m.kf_t[cam_g],
        cam_fixed=(fixed_kf | ~adjust_kf)[cam_g] | (cam_idx >= K),
        cam_valid=incl_kf[cam_g] & (cam_idx < K), pt_pos=m.point_pos[pt_g],
        pt_valid=pt_used[pt_g] & (pt_idx < P), meas_cam=mc.to(torch.int32),
        meas_pt=mp.to(torch.int32), **_meas_fields(m, k_idx, p_idx, mvalid))
    counts = torch.stack([torch.sum(incl_kf.to(torch.int32)),
                          torch.sum(pt_used.to(torch.int32)), n])
    return (prob, k_idx, p_idx, cam_idx.to(torch.int32),
            pt_idx.to(torch.int32), counts)


def apply_bundle(m: MapState, prob: bundlelib.BundleProblem, meas_k: Tensor,
                 meas_p: Tensor, adjust_kf: Tensor, point_mask: Tensor,
                 cam_idx: Tensor | None = None, pt_idx: Tensor | None = None):
    """Write BA results back and handle outliers by provenance: a ROOT
    outlier, or an outlier of a point with at most 2 measurements (counted
    before removal), trashes the point; a tracker or epipolar outlier is
    retried through the failure queue; any other is never retried.
    ``cam_idx``/``pt_idx`` are ``extract_bundle_compact``'s slot maps (None
    for the dense extract). Returns (map, failure mask (K, P))."""
    K, P = m.meas_valid.shape
    pt_ok = point_mask & m.point_valid
    if cam_idx is None:
        cam_R, cam_t, pt_pos = prob.cam_R, prob.cam_t, prob.pt_pos
    else:
        # Compact results back to capacity space; fill slots drop.
        cam_R = ms.scatter_drop(m.kf_R, cam_idx.long(), prob.cam_R)
        cam_t = ms.scatter_drop(m.kf_t, cam_idx.long(), prob.cam_t)
        pt_pos = ms.scatter_drop(m.point_pos, pt_idx.long(), prob.pt_pos)

    out = prob.meas_bad & prob.meas_valid
    flat = torch.where(out, meas_k.long() * P + meas_p.long(), K * P)
    out2d = ms.scatter_drop(torch.zeros(K * P, dtype=torch.bool,
                                        device=flat.device), flat,
                            True).reshape(K, P)
    src = m.meas_source
    good_count = torch.sum(m.meas_valid.to(torch.int32), dim=0)    # (P,)
    root_out = torch.any(out2d & (src == ms.SRC_ROOT), dim=0)
    point_bad = torch.any(out2d, dim=0) & (root_out | (good_count <= 2))
    retry = (out2d & ((src == ms.SRC_TRACKER) | (src == ms.SRC_EPIPOLAR))
             & ~point_bad[None, :])
    never = out2d & ~retry & ~point_bad[None, :]
    new_m = dataclasses.replace(
        m, kf_R=torch.where(adjust_kf[:, None, None], cam_R, m.kf_R),
        kf_t=torch.where(adjust_kf[:, None], cam_t, m.kf_t),
        point_pos=torch.where(pt_ok[:, None], pt_pos, m.point_pos),
        meas_valid=m.meas_valid & ~out2d & ~point_bad[None, :],
        point_valid=m.point_valid & ~point_bad,
        never_retry=m.never_retry | never)
    return ms.refresh_pixel_vectors(new_m), retry


def apply_bundle_job(m: MapState, prob, meas_k, meas_p, adjust_kf, point_mask,
                     failure_mask, cam_idx=None, pt_idx=None):
    """``apply_bundle`` and the failure-queue accumulation."""
    out, retry = apply_bundle(m, prob, meas_k, meas_p, adjust_kf, point_mask,
                              cam_idx, pt_idx)
    return out, failure_mask | retry


def handle_bad_points(m: MapState,
                      cfg: MapMakerConfig = MapMakerConfig()) -> MapState:
    """Outlier-count GC (HandleBadPoints): a point with more than
    ``bad_point_outlier_min`` tracker outliers, and more outliers than
    inliers, is trashed and its measurements erased."""
    bad = (m.point_valid & (m.point_outlier > cfg.bad_point_outlier_min)
           & (m.point_outlier > m.point_inlier))
    return dataclasses.replace(m, point_valid=m.point_valid & ~bad,
                               meas_valid=m.meas_valid & ~bad[None, :])


def plane_aligner(m: MapState, u: Tensor) -> SE3:
    """RANSAC of the dominant plane, and the SE3 that puts it at z=0
    (CalcPlaneAligner). Each row of the (n_ransacs, P) uniforms ``u`` ranks
    the valid points; a trial's 3 highest-ranked points span its plane
    (ties to the lower index, as ``lax.top_k``). The best trial's inliers
    (within 0.05) give the normal: the smallest eigenvector of their
    covariance, facing -z. Fewer than 10 valid points give the identity."""
    valid = m.point_valid
    pts = m.point_pos
    dev = pts.device
    n = torch.sum(valid.to(torch.int32))

    r = torch.where(valid[None], u, -1.0)
    idx3 = torch.sort(r, dim=-1, descending=True, stable=True).indices[:, :3]
    pa, pb, pc = pts[idx3[:, 0]], pts[idx3[:, 1]], pts[idx3[:, 2]]
    mean3 = (pa + pb + pc) / 3.0
    nrm = torch.linalg.cross(pc - pa, pb - pa, dim=-1)
    nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.where(nlen < 1e-12, 1.0, nlen)

    diff = pts[None] - mean3[:, None]                       # (T, P, 3)
    ndist = torch.clamp(torch.abs(torch.sum(diff * nrm[:, None], dim=-1)),
                        max=0.05)
    dist_sq = torch.sum(diff * diff, dim=-1)
    scores = torch.sum(torch.where(valid[None] & (dist_sq > 0), ndist, 0.0),
                       dim=-1)
    scores = torch.where(nlen[:, 0] < 1e-12, float("inf"), scores)
    best = torch.argmin(scores).reshape(1)  # the first minimum, as jnp
    bmean, bnorm = mean3[best][0], nrm[best][0]

    diffb = pts - bmean
    inl = (valid & (torch.abs(diffb @ bnorm) < 0.05)
           & (torch.sum(diffb * diffb, dim=-1) > 0))
    wn = torch.clamp(torch.sum(inl.to(torch.float32)), min=1.0)
    mean_in = torch.sum(torch.where(inl[:, None], pts, 0.0), dim=0) / wn
    d = (pts - mean_in) * inl[:, None]
    normal = geometry.smallest_eigvec(d.T @ d)
    normal = torch.where(normal[2] > 0, -normal, normal)

    # Gram-Schmidt rotation with the normal as its z row.
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    r0 = eye[0] - normal * normal[0]
    r0 = r0 / torch.clamp(torch.linalg.vector_norm(r0), min=1e-12)
    r1 = torch.linalg.cross(normal, r0, dim=-1)
    R = torch.stack([r0, r1, normal])
    t = -(R @ mean_in)
    few = n < 10
    return SE3(torch.where(few, eye, R), torch.where(few, 0.0, t))


def apply_global_transform(m: MapState, T: SE3) -> MapState:
    """ApplyGlobalTransformationToMap: keyframe poses compose with T^-1,
    points move by T."""
    Tinv = se3lib.inv(T)
    new = dataclasses.replace(
        m, kf_R=m.kf_R @ Tinv.R,
        kf_t=(m.kf_R @ Tinv.t[:, None])[..., 0] + m.kf_t,
        point_pos=m.point_pos @ T.R.T + T.t)
    return ms.refresh_pixel_vectors(new)


# ---------------------------------------------------------------------------
# The MapMaker's programs (the JAX MapMaker's jitted jobs) as CUDA graphs
# ---------------------------------------------------------------------------

#: Chunk programs ``ChunkPrograms`` keeps for each thread (one per
#: problem shape and layout).
MAX_CHUNK_GRAPHS = 8


class ChunkPrograms:
    """BA's LM chunk programs (``bundle.ChunkProgram``: one per problem
    shape, ``MeasLayout``, config, estimator and camera) and the
    point-sharded step's (``sharded_ba.ShardedPrograms``: one per shard
    shape, layout, config, estimator and mesh), kept apart from any one
    MapMaker. The JAX package caches its chunk programs for the process
    (``bundle._cached_lm_chunk``, ``sharded_ba.cached_sharded_lm_chunk``),
    so a reset's new MapMaker compiles none again; an engine makes one
    ``ChunkPrograms`` and hands it to each MapMaker it builds, whose
    chunks then find the graphs of the keys seen before.

    The programs are kept apart by the thread that calls them. A thread
    calls its programs one at a time on its own stream, so no program's
    static buffers take two calls at once, even when a reset leaves the
    old MapMaker's pass running BA on the mapping worker while the new
    MapMaker's init runs BA on the tracking thread. Each thread's chunk
    graphs share a memory pool that the cache owns, so it outlives every
    MapMaker (the sharded programs' graphs have pools of their own). The
    last ``MAX_CHUNK_GRAPHS`` programs of each thread are kept."""

    def __init__(self):
        #: {thread ident: (memory pool, {key: program}, oldest first)}
        self._threads = {}

    def kept(self) -> collections.OrderedDict:
        """This thread's programs by key, the last used last."""
        return self._kept(None)[1]

    def _kept(self, device):
        kept = self._threads.get(threading.get_ident())
        if kept is None:
            pool = (torch.cuda.graph_pool_handle()
                    if device is not None and device.type == "cuda"
                    else None)
            kept = self._threads[threading.get_ident()] = (
                pool, collections.OrderedDict())
        return kept

    def _get(self, key, device, make):
        pool, progs = self._kept(device)
        prog = progs.get(key)
        if prog is None:
            prog = progs[key] = make(pool)
            while len(progs) > MAX_CHUNK_GRAPHS:
                progs.popitem(last=False)
        progs.move_to_end(key)
        return prog

    def chunk(self, state: bundlelib.LMState, cam: atan.Camera,
              ba_cfg: BundleConfig, kind: int, graphs_on: bool,
              debug_dir: str | None = None) -> bundlelib.ChunkProgram:
        """The chunk program of ``state``'s shape and layout under
        ``ba_cfg``, ``kind`` and ``cam`` (a new one the first time)."""
        key = bundlelib.ChunkProgram.key_of(state, ba_cfg, kind) + (id(cam),)
        c, p, n_meas, n_pt, n_pair = key[:5]
        label = f"lm_chunk_c{c}_p{p}_m{n_meas}_npt{n_pt}_npair{n_pair}"

        def make(pool):
            prog = bundlelib.ChunkProgram(
                state, cam, ba_cfg, kind, graphs_on,
                None if debug_dir is None
                else os.path.join(debug_dir, f"{label}.dot"), pool)
            prog.label = label
            return prog
        return self._get(key, state.problem.pt_pos.device, make)

    def sharded(self, state: bundlelib.LMState, mesh, cam: atan.Camera,
                ba_cfg: BundleConfig, kind: int, graphs_on: bool,
                debug_dir: str | None = None) -> sharded_ba.ShardedPrograms:
        """The sharded LM step's programs of ``state``'s shard shape and
        layout under ``ba_cfg``, ``kind`` and ``cam`` on ``mesh``."""
        key = ("sharded",) + sharded_ba.ShardedPrograms.key_of(
            state, mesh, ba_cfg, kind) + (id(cam),)
        return self._get(key, state.problem.pt_pos.device,
                         lambda pool: sharded_ba.ShardedPrograms(
                             state, mesh, cam, ba_cfg, kind, graphs_on,
                             debug_dir))


@dataclasses.dataclass
class _Tier:
    """A BA tier's static buffers: the extraction's outputs (the problem
    and its index maps and counts) and the adjusted problem's tables that
    the write-back reads."""
    prob: bundlelib.BundleProblem
    mk: Tensor
    mp: Tensor
    cam_idx: Tensor
    pt_idx: Tensor
    counts: Tensor
    final: tuple        # (cam_R, cam_t, pt_pos, meas_bad) after LM


class MapPrograms:
    """The MapMaker's jobs as programs of static buffers (JAX's
    ``pinned(fn)`` programs, mapmaker.py:845-941): the integration's
    insert and its four epipolar levels, the span re-find (a graph per
    span width), the epipolar job per level, local BA's masks, the
    extraction and the write-back per BA tier, GC and the plane alignment;
    and BA's LM chunks (``bundle.ChunkProgram``, a graph per problem shape
    and layout; with a mesh, ``sharded_ba.ShardedPrograms``, four graphs
    per shard shape and layout), which ``chunk_programs`` keeps
    (``ChunkPrograms``: the engine's, which outlives the MapMaker, or one
    of the MapMaker's own).

    The map (``map``), the failure and new-point masks and every job's
    other inputs are static buffers; each program writes its results into
    them, so no map is copied in or out of a job. On the card with
    ``graphs`` a program is captured at its first call (``graphs.Graph``,
    the MapMaker's graphs sharing one memory pool: they run one at a time
    in the order the scheduler calls them, and each one's results are read
    or copied before the next runs) and replayed after; otherwise it runs
    eagerly on the same buffers. ``captures``: (label, capture seconds) of
    each capture the MapMaker made, its chunks' included. ``debug_dir``:
    where each graph's DOT dump goes."""

    def __init__(self, m: MapState, cam: atan.Camera, image_size,
                 cfg: MapMakerConfig, kind: int, graphs_on: bool,
                 debug_dir: str | None = None,
                 chunk_programs: ChunkPrograms | None = None):
        dev = m.point_pos.device
        self.device = dev
        self.graphs = graphs.on_card(dev, graphs_on)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.graphs and dev.type == "cuda" else None)
        self.cam, self.image_size = cam, image_size
        self.cfg, self.kind = cfg, kind
        self.debug_dir = debug_dir
        K, P = m.meas_valid.shape

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        b, i32, i64 = torch.bool, torch.int32, torch.int64
        self.map = ms.copy_map(m)
        self.failure, self.new_pts, self.refind = z((K, P), b), z(P, b), \
            z((K, P), b)
        self.slot, self.tot, self.packed = z((), i32), z((), i32), z(2, i32)
        self.k0, self.src, self.newest = z((), i64), z((), i64), z((), i64)
        self.adjust, self.fixed, self.pmask = z(K, b), z(K, b), z(P, b)
        self.insert = None          # the insert's inputs, at the first one
        self.u = None               # the plane aligner's uniforms
        self.tiers = {}
        self.jobs = {}
        self.chunk_programs = (ChunkPrograms() if chunk_programs is None
                               else chunk_programs)
        self.captures = []

    def _path(self, label: str):
        if self.debug_dir is None:
            return None
        return os.path.join(self.debug_dir, f"{label}.dot")

    def _get(self, label: str, fn, inputs: tuple) -> graphs.Job:
        job = self.jobs.get(label)
        if job is None:
            job = self.jobs[label] = graphs.Job(
                label, fn, inputs, self.device, self.graphs,
                self._path(label), self.pool)
        return job

    def run(self, label: str, fn, inputs: tuple):
        """The job ``label`` (``fn`` of the static ``inputs``): a replay,
        captured at its first call, or an eager call."""
        job = self._get(label, fn, inputs)
        capture = job.will_capture()
        out = job.run()
        if capture:
            self.captures.append((label, job.graph.capture_s))
        return out

    def capture(self, label: str, fn, inputs: tuple) -> None:
        """Capture the job ``label`` now if it runs as a graph and is not
        captured yet; the capture runs nothing on its buffers."""
        job = self._get(label, fn, inputs)
        if job.will_capture():
            job.capture()
            self.captures.append((label, job.graph.capture_s))

    @property
    def chunks(self) -> collections.OrderedDict:
        """The chunk programs this thread has used, by key."""
        return self.chunk_programs.kept()

    def chunk(self, state: bundlelib.LMState,
              ba_cfg: BundleConfig) -> bundlelib.ChunkProgram:
        """The chunk program of ``state``'s shape and layout under
        ``ba_cfg`` (the console may replace the MapMaker's)."""
        return self.chunk_programs.chunk(state, self.cam, ba_cfg, self.kind,
                                         self.graphs, self.debug_dir)

    def sharded(self, state: bundlelib.LMState, mesh,
                ba_cfg: BundleConfig) -> sharded_ba.ShardedPrograms:
        """The sharded LM step's programs (``sharded_ba.ShardedPrograms``)
        of ``state``'s shard shape and layout under ``ba_cfg``; the
        captures they make for this MapMaker are listed in ``captures``."""
        prog = self.chunk_programs.sharded(state, mesh, self.cam, ba_cfg,
                                           self.kind, self.graphs,
                                           self.debug_dir)
        prog.captures = self.captures
        return prog

    def chunk_call(self, prog, state, iter_limit: int, f):
        capture = prog.will_capture()
        out = prog(state, iter_limit, f)
        if capture and prog.graph is not None:
            self.captures.append((prog.label, prog.graph.capture_s))
        return out

    def tier(self, caps) -> _Tier:
        """The BA tier ``caps``' buffers, made from an eager extraction of
        the current buffers the first time."""
        t = self.tiers.get(caps)
        if t is None:
            prob, mk, mp, cam_idx, pt_idx, counts = graphs.clone(
                extract_bundle_compact(self.map, self.adjust, self.fixed,
                                       self.pmask, *caps))
            final = tuple(getattr(prob, f).clone() for f in (
                "cam_R", "cam_t", "pt_pos", "meas_bad"))
            t = self.tiers[caps] = _Tier(prob, mk, mp, cam_idx, pt_idx,
                                         counts, final)
        return t


def _insert_fn(cam, image_size):
    def fn(m, feat, R, t, point, pos, level, subpix, valid, dmean, dsigma,
           slot, tot):
        new, s = integrate_insert_program(m, feat, SE3(R, t), point, pos,
                                          level, subpix, valid, dmean,
                                          dsigma, cam, image_size)
        _store(m, new)
        slot.copy_(s)
        tot.zero_()
    return fn


def _epi_fn(level: int, pack: bool, cam, image_size, wiggle, thin):
    def fn(m, slot, npm, tot, packed):
        new, npm2, tot2 = integrate_epi_program(m, slot, npm, tot, level,
                                                cam, image_size, wiggle,
                                                thin)
        _store(m, new)
        npm.copy_(npm2)
        tot.copy_(tot2)
        if pack:
            packed.copy_(torch.stack([slot, tot2.to(torch.int32)]))
    return fn


def _refind_fn(width: int, cam, image_size):
    def fn(m, mask2d, k0):
        new, total = refind_span(m, mask2d, k0, width, cam, image_size)
        _store(m, new)
        return total
    return fn


def _epipolar_fn(level: int, cam, image_size, wiggle, thin):
    def fn(m, src, npm):
        new, n, npm2 = epipolar_job(m, src, npm, level, cam, image_size,
                                    wiggle, thin)
        _store(m, new)
        npm.copy_(npm2)
        return n
    return fn


def _local_masks_fn(m, newest, adjust, fixed, pts):
    a, f, p = local_ba_masks(m, newest)
    adjust.copy_(a)
    fixed.copy_(f)
    pts.copy_(p)


def _extract_fn(caps):
    def fn(m, adjust, fixed, pmask, tier):
        out = extract_bundle_compact(m, adjust, fixed, pmask, *caps)
        bufs = (tier.prob, tier.mk, tier.mp, tier.cam_idx, tier.pt_idx,
                tier.counts)
        for buf, x in zip(tree.tensors(bufs), tree.tensors(out)):
            buf.copy_(x)
    return fn


def _apply_fn(m, failure, tier, adjust, pmask):
    cam_R, cam_t, pt_pos, meas_bad = tier.final
    prob = dataclasses.replace(tier.prob, cam_R=cam_R, cam_t=cam_t,
                               pt_pos=pt_pos, meas_bad=meas_bad)
    new, fail2 = apply_bundle_job(m, prob, tier.mk, tier.mp, adjust, pmask,
                                  failure, tier.cam_idx, tier.pt_idx)
    _store(m, new)
    failure.copy_(fail2)


def _gc_fn(cfg):
    def fn(m):
        _store(m, handle_bad_points(m, cfg))
    return fn


def _plane_fn(m, u):
    _store(m, apply_global_transform(m, plane_aligner(m, u)))


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------

class _HostCopy:
    """A small device tensor on its way to the host: a copy into pinned
    memory started without waiting, under an event. A CPU tensor is
    complete already."""

    def __init__(self, t: Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def read(self) -> list:
        """The values; blocks until the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


class MapMaker:
    """The mapping side's priority scheduler (MapMaker::run) over its jobs:
    keyframe integration in five phases, local and global BA in chunks,
    re-find of new points and of the failure queue in 16-slot spans, and
    bad-point GC. The caller (the engine, once a frame) calls ``step``; a
    keyframe waiting in ``kf_queue`` aborts a BA run between chunks, as the
    reference's abort flag does. Stereo init uses the BA, expansion and
    plane-alignment methods directly.

    ``mesh``: a ``parallel.mesh.Mesh``. With more than one rank on it,
    global BA runs point-sharded over its ranks (``parallel/
    sharded_ba.py``): the extracted problem is sharded when its first
    chunk starts, chunks go through ``sharded_ba.sharded_lm_chunk`` and the
    result is unsharded before it is applied. Local BA stays on one rank.
    Every rank runs the same MapMaker on the same inputs, so each host
    decision that gates a collective must come out the same on every rank.
    Deterministic mode has none that depends on timing. In latency mode
    each is agreed over the mesh (``_agree``, one all_reduce on a host
    scalar): a pass goes ahead only when the last dispatch has completed
    on every rank (MIN), an integration's read lands only when it has
    reached every rank's host (MIN), a keyframe queued on any rank aborts
    BA (MAX), and the chunk sizer uses the slowest rank's chunk time
    (MAX). The point capacity, and every power-of-two BA point cap, must
    divide the mesh size (checked here).

    ``deterministic``: True makes every gate block and runs BA in fixed
    ``ba_steps_per_pass`` chunks, so a run is a pure function of its inputs
    (the parity contract); False (latency mode) skips a pass while the
    last mapping dispatch is still running on the card and sizes chunks
    from a measured per-step time to fit ``ba_latency_budget_ms``. None
    picks deterministic for a map on the CPU and latency mode on the card.
    A CUDA event recorded after each mapping dispatch is the gate
    (``_last_dispatch``), and the packed (slot, n_added) of an integration
    comes back through pinned memory under an event; for a map on the CPU
    both have completed when the call returns. A BA chunk reads its flags
    on the host as it runs (``bundle.lm_chunk``), so it has ended when its
    dispatch returns, and a poll needs no readiness check.

    ``graphs``: run the jobs as CUDA graphs on the card (``MapPrograms``,
    the JAX MapMaker's jitted programs): each job is one replay, a BA chunk
    one replay and one host read. False runs them eagerly on the same
    buffers (to compare); the CPU always does. The map, once a job has
    run, is the programs' buffers, which the next job writes in place:
    ``map`` is then a map the MapMaker owns, and a caller that keeps a map
    past the next job copies it (``map_state.copy_map``).
    ``graph_debug_dir``: a directory for each graph's DOT dump.
    ``chunk_programs``: the ``ChunkPrograms`` that keeps BA's chunk
    programs (the engine passes its own, so that they outlive a reset;
    default: one of the MapMaker's own).

    ``seed`` seeds ``generator``, a ``torch.Generator`` on the map's
    device, which draws the plane aligner's uniforms when the caller gives
    none (the JAX MapMaker splits a PRNG key made from the same seed), and
    the numpy generator of the failure-queue draw, as in the JAX package.
    """

    def __init__(self, m: MapState, cam: atan.Camera, image_size,
                 cfg: MapMakerConfig = MapMakerConfig(),
                 ba_cfg: BundleConfig = BundleConfig(),
                 max_ba_meas: int | None = None, seed: int = 0,
                 deterministic: bool | None = None, mesh=None,
                 mesh_axis: str = "mp", graphs: bool = True,
                 graph_debug_dir: str | None = None,
                 chunk_programs: ChunkPrograms | None = None):
        self.map = m
        self.graphs = graphs
        self.graph_debug_dir = graph_debug_dir
        self.chunk_programs = (ChunkPrograms() if chunk_programs is None
                               else chunk_programs)
        self._progs = None
        self.cam = cam
        self.image_size = image_size
        self.cfg = cfg
        self.ba_cfg = ba_cfg
        self._kind = mest.estimator_id(ba_cfg.mestimator)
        self.deterministic = (not m.point_pos.is_cuda if deterministic is None
                              else deterministic)
        K, P = m.meas_valid.shape
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._use_sharded = mesh is not None and mesh.shape[mesh_axis] > 1
        if self._use_sharded:
            D = mesh.shape[mesh_axis]
            smallest = min(_TIER_P_FLOOR, bundlelib.pow2ceil(P))
            if P % D or smallest % D:
                raise ValueError(
                    f"point capacity {P} (BA point caps down to {smallest})"
                    f" not divisible by mesh size {D}")
        #: Global-BA measurement capacity: keyframe capacity x the
        #: per-keyframe budget; past it extraction prioritizes and warns.
        self.max_ba_meas = (min(K * MAX_MEAS_PER_KF, K * P)
                            if max_ba_meas is None else max_ba_meas)
        dev = m.meas_valid.device
        #: (K, P) measurements BA rejected that re-find should retry.
        self.failure_mask = torch.zeros(K, P, dtype=torch.bool, device=dev)
        #: Points added by epipolar expansion, not yet re-found elsewhere.
        self.new_point_mask = torch.zeros(P, dtype=torch.bool, device=dev)
        #: Host-side flags: an expansion added points / a BA run filled
        #: the failure mask (so the scheduler never reads a mask to know).
        self._new_points_pending = False
        self._failures_pending = False
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self._rng = np.random.default_rng(seed)
        # BA size tiers (power-of-two caps, see _ba_caps); the floors only
        # ratchet up (overflow escalation).
        self._tier_c_floor = 4
        self._tier_p_floor = _TIER_P_FLOOR
        self._tier_m_floor = 4096
        #: Host-side live point-count estimate; the engine refreshes it.
        self._n_points_hint = 0
        #: True measurement count of the last BA extract.
        self._last_n_sel = 0
        #: Host-side keyframe count and mirror of ``map.good`` (read here
        #: once; stereo init sets both, integration counts keyframes).
        self._n_kfs_host = int(torch.sum(m.kf_valid.to(torch.int32)))
        self.good_host = bool(m.good)
        #: Keyframe distances are measured in units of this (stereo init
        #: sets it to wiggle_scale / scene depth).
        self.wiggle_depth_norm = 1.0
        #: Keyframes waiting for integration: (features, pose, meas,
        #: depth_mean, depth_sigma); a non-empty queue aborts BA.
        self.kf_queue: list = []
        #: In-flight phased integration: {"slot", "tot", "phase"}.
        self._integrate_job = None
        #: The last integration's (slot, n_added) on its way to the host.
        self._pending_integrate = None
        #: Event recorded after the last mapping dispatch on the card.
        self._last_dispatch = None
        #: Re-find spans: 16-slot windows over the keyframes; when K is
        #: not a multiple of 16 the last window ends at K and re-scans
        #: slots of the one before it (a no-op there).
        span = min(16, K)
        self._span_ks = [range(k0, k0 + span)
                         for k0 in range(0, K - span + 1, span)]
        if K % span:
            self._span_ks.append(range(K - span, K))
        #: In-flight span re-find: {"mask2d": (K, P) bool, "i": span}.
        self._refind_task = None
        #: In-flight BA job (see _ba_start/_ba_poll).
        self._ba_job = None
        self._map_dirty = False
        self.converged_recent = True
        self.converged_full = True
        #: Set when BA blows up numerically: the engine must ditch the map.
        self.reset_requested = False
        #: Per-LM-step wall time EMA (ms) in latency mode; None until the
        #: first chunk ends.
        self._ba_step_ms = None

    def _agree(self, value, op=dist.ReduceOp.MAX):
        """A host decision every rank of a multi-rank mesh shares (``op``
        over the ranks' values); ``value`` itself without one."""
        if not self._use_sharded:
            return value
        return type(value)(self.mesh.agree(value, op))

    def _note_dispatch(self):
        """Record the scheduler's backpressure event after a mapping
        dispatch on the card (see ``step``)."""
        if self.map.point_pos.is_cuda:
            self._last_dispatch = torch.cuda.Event()
            self._last_dispatch.record()

    @property
    def programs(self) -> MapPrograms:
        """The jobs' programs and buffers, made at the first job (again if
        the config, the camera or the image size was replaced)."""
        key = (id(self.cfg), id(self.cam), tuple(self.image_size))
        if self._progs is None or self._progs_key != key:
            self._progs = MapPrograms(self.map, self.cam, self.image_size,
                                      self.cfg, self._kind, self.graphs,
                                      self.graph_debug_dir,
                                      self.chunk_programs)
            self._progs_key = key
        return self._progs

    def _load(self) -> MapPrograms:
        """The programs, their buffers holding ``map`` and the masks (a
        copy only of what is not the buffers already)."""
        p = self.programs
        graphs.fill_tree(p.map, self.map)
        graphs.fill(p.failure, self.failure_mask)
        graphs.fill(p.new_pts, self.new_point_mask)
        return p

    def _unload(self) -> None:
        """After a job: the map and masks are the programs' buffers."""
        p = self._progs
        self.map, self.failure_mask, self.new_point_mask = \
            p.map, p.failure, p.new_pts

    def _job(self, label: str, fn, inputs: tuple, writes: bool = True):
        """Run a job of the loaded programs; one that ``writes`` the map
        leaves ``map`` and the masks the buffers it wrote."""
        out = self._progs.run(label, fn, inputs)
        if writes:
            self._unload()
        return out

    def queue_size(self) -> int:
        return len(self.kf_queue)

    def integrating(self) -> bool:
        """A keyframe is queued or its integration is under way."""
        return bool(self.kf_queue) or self._integrate_job is not None \
            or self._pending_integrate is not None

    def n_kfs(self) -> int:
        return self._n_kfs_host

    # -- BA: one run, started, then advanced chunk by chunk ---------------
    def bundle_adjust(self, adjust_kf, fixed_kf, point_mask, recent: bool,
                      full: bool = False, sharded: bool = False):
        """A BA run to convergence or abort; point-sharded over the mesh
        with ``sharded``."""
        self._ba_start(adjust_kf, fixed_kf, point_mask, recent, full,
                       sharded)
        while self._ba_job is not None:
            self._ba_poll(block=True)

    def _ba_caps(self):
        """Power-of-two problem caps from host-known sizes: the keyframe
        count, the live point-count hint and the last extract's true
        measurement count, with margins and the ratcheting floors, clamped
        to the map's capacity and ``max_ba_meas``."""
        K, P = self.map.meas_valid.shape
        n_c = max(self._n_kfs_host + len(self.kf_queue), self._tier_c_floor)
        c_cap = min(bundlelib.pow2ceil(n_c), bundlelib.pow2ceil(K))
        n_p = max(int(self._n_points_hint * 1.5) + 64, self._tier_p_floor)
        p_cap = min(bundlelib.pow2ceil(n_p), bundlelib.pow2ceil(P))
        n_m = max(int(self._last_n_sel * 1.5), c_cap * 256,
                  self._tier_m_floor)
        m_cap = min(bundlelib.pow2ceil(n_m),
                    bundlelib.pow2ceil(self.max_ba_meas))
        return c_cap, p_cap, m_cap

    def _ba_start(self, adjust_kf, fixed_kf, point_mask, recent: bool,
                  full: bool = False, sharded: bool = False):
        """Extract the problem; the first LM chunk goes out at the next
        ``_ba_poll``."""
        caps = self._ba_caps()
        p = self._load()
        graphs.fill(p.adjust, adjust_kf)
        graphs.fill(p.fixed, fixed_kf)
        graphs.fill(p.pmask, point_mask)
        tier = p.tier(caps)
        self._job("extract_c{}_p{}_m{}".format(*caps), _extract_fn(caps),
                  (p.map, p.adjust, p.fixed, p.pmask, tier), writes=False)
        self._ba_job = dict(tier=tier, prob=tier.prob, adjust=p.adjust,
                            pmask=p.pmask, recent=recent, full=full,
                            counts=tier.counts, caps=caps, state=None,
                            iters_done=0, sharded=sharded)
        self._note_dispatch()

    def _ba_init_state(self):
        job = self._ba_job
        prob = job.pop("prob")
        if job["sharded"]:
            # Shard on the host (reads the measurement table once a run).
            shard, perm = sharded_ba.shard_problem(
                prob, self.mesh, self.mesh_axis, return_perm=True)
            job.update(orig_prob=prob, perm=perm)
            job["state"] = sharded_ba.init_sharded_lm(shard, self.mesh,
                                                      self.ba_cfg)
        else:
            job["state"] = bundlelib.init_lm(prob, self.ba_cfg)
        job["flags"] = bundlelib.INIT_FLAGS
        self._ba_dispatch_chunk()

    def _chunk_steps(self) -> int:
        """LM iterations for the next chunk: a fixed ``ba_steps_per_pass``
        in deterministic mode; in latency mode the measured per-step time
        fitted into ``ba_latency_budget_ms`` (capped at ba_steps_per_pass),
        and a 1-step probe before any measurement."""
        if self.deterministic:
            return self.cfg.ba_steps_per_pass
        if self._ba_step_ms is None:
            return 1
        return max(1, min(self.cfg.ba_steps_per_pass,
                          int(self.cfg.ba_latency_budget_ms
                              / max(self._ba_step_ms, 1e-3))))

    def _chunk_target(self, job) -> int:
        """The chunk's iteration limit: iterations so far plus the chunk's
        steps (all of them for a full run), capped at the maximum."""
        if job["full"]:
            return self.ba_cfg.max_iterations
        return min(job["iters_done"] + self._chunk_steps(),
                   self.ba_cfg.max_iterations)

    def _ba_dispatch_chunk(self):
        job = self._ba_job
        t0 = time.perf_counter()
        job["iters_before"] = job["iters_done"]
        if job["sharded"]:
            progs = self.programs.sharded(job["state"], self.mesh,
                                          self.ba_cfg)
            job["state"], job["flags"] = sharded_ba.sharded_lm_chunk(
                job["state"], self.mesh, self.cam, self.ba_cfg, self._kind,
                self._chunk_target(job), job["flags"], progs)
        elif self.programs.graphs:
            # The program of the config in force now: the console may
            # replace it between chunks.
            progs = self.programs
            job["state"], job["flags"] = progs.chunk_call(
                progs.chunk(job["state"], self.ba_cfg), job["state"],
                self._chunk_target(job), job["flags"])
        else:
            job["state"], job["flags"] = bundlelib.lm_chunk(
                job["state"], self.cam, self.ba_cfg, self._kind,
                self._chunk_target(job), job["flags"])
        job["seconds"] = time.perf_counter() - t0

    def _ba_poll(self, block: bool = False):
        """Advance the in-flight BA job by one chunk. Returns True while
        busy."""
        job = self._ba_job
        if job is None:
            return False
        if job["state"] is None:
            # Extracted, LM not started: a keyframe queued meanwhile
            # aborts for free.
            if self._agree(bool(self.kf_queue)) and not block:
                self._ba_job = None
                return False
            self._ba_init_state()
            return True
        if job["counts"] is not None:
            n_c, n_p, n_sel = job["counts"].tolist()
            job["counts"] = None
            c_cap, p_cap, m_cap = job["caps"]
            self._last_n_sel = n_sel
            # Tier escalation: an undersized cap ratchets its floor so the
            # next extract covers everything (this pass ran on a correct,
            # prioritized subset); only the largest tier warns.
            if n_c > c_cap:
                self._tier_c_floor = max(self._tier_c_floor, n_c)
            if n_p > p_cap:
                self._tier_p_floor = max(self._tier_p_floor, int(n_p * 1.25))
            if n_sel > m_cap:
                self._tier_m_floor = max(self._tier_m_floor,
                                         int(n_sel * 1.25))
            if n_sel > m_cap and m_cap >= self.max_ba_meas:
                warnings.warn(
                    f"BA measurement capacity exceeded: {n_sel} selected > "
                    f"max_ba_meas={self.max_ba_meas}; this pass optimizes a "
                    f"PRIORITIZED subset (ROOT provenance, scarce points, "
                    f"newest KFs first). Raise MapMaker(max_ba_meas=...) to "
                    f"cover the full set.", RuntimeWarning, stacklevel=2)
        conv, iters, failed, accepted = job["flags"]
        n_new = iters - job["iters_before"]
        if not self.deterministic and n_new > 0:
            seconds = self._agree(job["seconds"])
        if not self.deterministic and n_new > 0 and seconds < 5.0:
            per_ms = seconds / n_new * 1000.0
            self._ba_step_ms = (per_ms if self._ba_step_ms is None
                                else 0.7 * self._ba_step_ms + 0.3 * per_ms)
        job["iters_done"] = iters
        if failed:
            # Cholesky/NaN blow-up: ditch the map; nothing is applied.
            self.reset_requested = True
            self._ba_job = None
            return False
        if not (conv or self._agree(bool(self.kf_queue))
                or iters >= self.ba_cfg.max_iterations):
            self._ba_dispatch_chunk()
            return True
        prob = job["state"].problem
        if job["sharded"]:
            # Back in extraction order, so the write-back indexes the
            # outlier flags as the one-rank path does.
            prob = sharded_ba.unshard_measurements(
                job["orig_prob"], prob, job["perm"], self.mesh)
        p, tier = self._load(), job["tier"]
        for buf, x in zip(tier.final, (prob.cam_R, prob.cam_t, prob.pt_pos,
                                       prob.meas_bad)):
            graphs.fill(buf, x)
        self._job("apply_c{}_p{}_m{}".format(*job["caps"]), _apply_fn,
                  (p.map, p.failure, tier, job["adjust"], job["pmask"]))
        self._note_dispatch()
        self._failures_pending = True
        self._map_dirty = True
        if accepted > 0:
            if job["recent"]:
                self.converged_recent = False
            self.converged_full = False
        if conv:
            self.converged_recent = True
            if not job["recent"]:
                self.converged_full = True
        self._ba_job = None
        return False

    def bundle_adjust_all(self, full: bool = False, start_only: bool = False):
        """Global BA over every valid keyframe (BundleAdjustAll); fixed
        keyframes stay fixed. Point-sharded with a multi-rank mesh."""
        valid = self.map.kf_valid
        adjust, fixed = valid & ~self.map.kf_fixed, valid & self.map.kf_fixed
        if start_only:
            self._ba_start(adjust, fixed, self.map.point_valid, False, full,
                           self._use_sharded)
        else:
            self.bundle_adjust(adjust, fixed, self.map.point_valid, False,
                               full, self._use_sharded)

    def bundle_adjust_recent(self, newest, start_only: bool = False):
        """Local BA (BundleAdjustRecent): the newest keyframe and its 4
        nearest adjusted, the other observers fixed; a map of fewer than 8
        keyframes counts as converged."""
        if self.n_kfs() < 8:
            self.converged_recent = True
            return
        p = self._load()
        graphs.fill(p.newest, torch.as_tensor(newest))
        self._job(*self._local_masks_job(), writes=False)
        adjust, fixed, pts = p.adjust, p.fixed, p.pmask
        if start_only:
            self._ba_start(adjust, fixed, pts, True)
        else:
            self.bundle_adjust(adjust, fixed, pts, True)

    def _local_masks_job(self):
        p = self.programs
        return ("local_masks", _local_masks_fn,
                (p.map, p.newest, p.adjust, p.fixed, p.pmask))

    def add_some_map_points(self, src_kf: int, level: int) -> int:
        """One epipolar expansion of keyframe ``src_kf`` at ``level``
        against its closest keyframe (AddSomeMapPoints). Returns the number
        of points added (one host read, as in the JAX package)."""
        p = self._load()
        graphs.fill(p.src, torch.as_tensor(src_kf))
        n = int(self._job(f"epipolar_l{level}", _epipolar_fn(
            level, self.cam, self.image_size, self.cfg.wiggle_scale,
            self.cfg.thin_candidates_radius), (p.map, p.src, p.new_pts)))
        if n > 0:
            self._new_points_pending = True
        return n

    def plane_align(self, u: Tensor | None = None):
        """Move the map so its dominant plane is z=0 (CalcPlaneAligner and
        ApplyGlobalTransformationToMap). ``u``: the (plane_aligner_ransacs,
        P) uniforms, drawn from ``generator`` when not given."""
        if u is None:
            u = torch.rand((self.cfg.plane_aligner_ransacs,
                            self.map.point_pos.shape[0]),
                           generator=self.generator,
                           device=self.map.point_pos.device)
        p = self._load()
        if p.u is None:
            p.u = torch.empty_like(u)
        graphs.fill(p.u, u)
        self._job("plane_align", _plane_fn, (p.map, p.u))

    def handle_bad_points(self):
        """Bad-point GC, run only after the map changed (``mark_dirty``)."""
        if not self._map_dirty:
            return
        self._load()
        self._job(*self._gc_job())
        self._note_dispatch()
        self._map_dirty = False

    def _gc_job(self):
        return "gc", _gc_fn(self.cfg), (self.programs.map,)

    def mark_dirty(self):
        self._map_dirty = True

    # -- span re-find tasks -------------------------------------------------
    # The scheduler snapshots the selection mask and re-finds one 16-slot
    # span a pass. Map updates between spans are safe: a span skips points
    # already measured (``refind_all_kfs``).

    def _start_refind_task(self, mask2d: Tensor):
        """The task's selection, copied into the programs' buffer."""
        self.programs.refind.copy_(mask2d)
        self._refind_task = dict(i=0)

    def _refind_advance(self):
        task = self._refind_task
        ks = self._span_ks[task["i"]]
        p = self._load()
        p.k0.fill_(ks.start)
        self._job(*self._refind_job(len(ks)))
        self._note_dispatch()
        task["i"] += 1
        if task["i"] >= len(self._span_ks):
            self._refind_task = None

    def _refind_job(self, width: int):
        p = self.programs
        return (f"refind_w{width}", _refind_fn(width, self.cam,
                                               self.image_size),
                (p.map, p.refind, p.k0))

    def refind_newly_made(self, spread: bool = False):
        """ReFindNewlyMade: re-find the expansion's new points in every
        keyframe. With ``spread`` the spans are left to later passes;
        otherwise they all run now (the same result)."""
        if self._new_points_pending and self._refind_task is None:
            K = self.map.kf_valid.shape[0]
            self._start_refind_task(self.new_point_mask.expand(
                K, self.new_point_mask.shape[0]))
            self.new_point_mask = torch.zeros_like(self.new_point_mask)
            self._new_points_pending = False
        if not spread:
            while self._refind_task is not None:
                self._refind_advance()

    def refind_from_failure_queue(self, spread: bool = False):
        """ReFindFromFailureQueue: retry the measurements BA rejected."""
        if self._failures_pending and self._refind_task is None:
            self._start_refind_task(self.failure_mask)
            self.failure_mask = torch.zeros_like(self.failure_mask)
            self._failures_pending = False
        if not spread:
            while self._refind_task is not None:
                self._refind_advance()

    # -- phased keyframe integration ----------------------------------------
    # AddKeyFrameFromTopOfQueue as five dispatches, one a scheduler pass:
    # insert + tracker measurements + re-find in the new keyframe, then
    # one epipolar level each (order 3, 0, 1, 2). The last packs (slot,
    # n_added), read by a later pass (``_drain_integrate``).

    def add_keyframe(self, features: FrameFeatures, pose: SE3, meas: dict,
                     depth_mean, depth_sigma):
        """MapMaker::AddKeyFrame: enqueue; a queued keyframe aborts BA.
        ``meas``: the tracker's measurements, a dict of point, pos, level,
        subpix and valid."""
        self.kf_queue.append((features, pose, meas, depth_mean, depth_sigma))

    def _integrate_start(self):
        """Phase 0: pop the queue; insert, tracker measurements and the
        re-find in the new keyframe."""
        if not self.kf_queue:
            return None
        if self._n_kfs_host >= self.map.kf_valid.shape[0]:
            return None     # keyframe capacity exhausted
        features, pose, meas, dmean, dsigma = self.kf_queue.pop(0)
        p = self._load()
        dev = p.device
        args = (features, pose.R, pose.t, meas["point"], meas["pos"],
                meas["level"], meas["subpix"], meas["valid"],
                torch.as_tensor(dmean, dtype=torch.float32, device=dev),
                torch.as_tensor(dsigma, dtype=torch.float32, device=dev))
        if p.insert is None:
            p.insert = graphs.clone(args)
        graphs.fill_tree(p.insert, args)
        self._job("insert", _insert_fn(self.cam, self.image_size),
                  (p.map, *p.insert, p.slot, p.tot))
        self._n_kfs_host += 1
        self._integrate_job = dict(phase=0)
        self._note_dispatch()
        self.converged_recent = False
        self.converged_full = False
        return None

    def _integrate_advance(self):
        """One epipolar level; the last one packs (slot, n_added) and
        starts its copy to the host."""
        job = self._integrate_job
        ph = job["phase"]
        last = ph == len(EPI_LEVEL_ORDER) - 1
        p = self._load()
        self._job(*self._epi_job(ph))
        if not last:
            job["phase"] = ph + 1
        else:
            self._pending_integrate = _HostCopy(p.packed)
            self._integrate_job = None
        self._note_dispatch()

    def _epi_job(self, ph: int):
        """The integration's phase ``ph``: an epipolar level, the last of
        which packs (slot, n_added)."""
        p, lev = self.programs, EPI_LEVEL_ORDER[ph]
        return (f"epi_l{lev}", _epi_fn(
            lev, ph == len(EPI_LEVEL_ORDER) - 1, self.cam, self.image_size,
            self.cfg.wiggle_scale, self.cfg.thin_candidates_radius),
            (p.map, p.slot, p.new_pts, p.tot, p.packed))

    def capture_jobs(self) -> None:
        """Capture now the jobs whose shapes the map's capacity fixes, so
        that no scheduler pass stalls on their capture: an integration's
        four epipolar levels, the span re-finds, local BA's masks and GC.
        (The insert is captured with its first keyframe, and BA's
        extraction, write-back and chunks with their tier and layout.)
        Each capture's warm-up runs on copies of the buffers: the map does
        not change. Nothing to do unless the programs are graphs."""
        p = self.programs
        if not p.graphs:
            return
        for ph in range(len(EPI_LEVEL_ORDER)):
            p.capture(*self._epi_job(ph))
        for w in sorted({len(ks) for ks in self._span_ks}):
            p.capture(*self._refind_job(w))
        p.capture(*self._local_masks_job())
        p.capture(*self._gc_job())

    def integrate_keyframe(self):
        """A whole integration with every phase now (the synchronous
        entry; the scheduler advances one phase a pass)."""
        if self._integrate_job is None:
            before = self._n_kfs_host
            self._integrate_start()
            if self._n_kfs_host == before:
                return None     # nothing to integrate / capacity full
        while self._integrate_job is not None:
            self._integrate_advance()
        return None

    def _drain_integrate(self, block: bool = False):
        """Land an integration whose (slot, n_added) has reached the host
        (or wait for it with ``block``). Returns the new keyframe slot, or
        None."""
        p = self._pending_integrate
        if p is None:
            return None
        if not block and not self._agree(p.ready(), dist.ReduceOp.MIN):
            return None
        slot, n_added = p.read()
        self._pending_integrate = None
        if n_added > 0:
            self._new_points_pending = True
        return slot

    def drain_all(self):
        """Run every in-flight and pending mapping job to its end: phased
        integrations, deferred reads, BA chunks, queued keyframes, span
        re-finds. For benches and tests that want a quiescent map; the
        engine never calls it. Returns the last integrated slot, or None."""
        last_slot = None
        while True:
            if self._integrate_job is not None:
                while self._integrate_job is not None:
                    self._integrate_advance()
            elif self._pending_integrate is not None:
                slot = self._drain_integrate(block=True)
                if slot is not None:
                    last_slot = slot
            elif self._ba_job is not None:
                self._ba_poll(block=True)
            elif self._refind_task is not None:
                self._refind_advance()
            elif self.kf_queue:
                self.integrate_keyframe()
            else:
                break
        return last_slot

    # -- the priority loop ----------------------------------------------------
    def step(self, newest_kf: int | None = None):
        """One pass of the mapping priority hierarchy (MapMaker::run): at
        most one bounded mapping dispatch a pass, two under keyframe-queue
        pressure. In order: land a finished integration's read; advance an
        in-flight integration; advance (or finish, or abort) BA; start the
        next queued integration; local BA of ``newest_kf`` until it
        converges; an in-flight span re-find; re-find of new points; global
        BA until it converges; now and then (one pass in 20, drawn from the
        numpy generator) the failure queue; else bad-point GC. Returns the
        slot of a keyframe whose integration landed this pass, or None."""
        if self.reset_requested or not self.good_host:
            return None
        # Backpressure: while the last mapping dispatch still runs on the
        # card, latency mode dispatches nothing (it may still land an
        # integration's read); deterministic mode waits for it instead,
        # so which passes do work never depends on device timing.
        if self._last_dispatch is not None:
            if self.deterministic:
                self._last_dispatch.synchronize()
            elif not self._agree(self._last_dispatch.query(),
                                 dist.ReduceOp.MIN):
                if self._pending_integrate is not None:
                    return self._drain_integrate()
                return None
            self._last_dispatch = None
        ret = None
        if self._pending_integrate is not None:
            ret = self._drain_integrate(block=self.deterministic)
            if ret is None:
                return None     # the read is still on its way
        if self._integrate_job is not None:
            # Queued keyframes speed the phases up, capped at two a pass.
            for _ in range(1 + min(1, len(self.kf_queue))):
                if self._integrate_job is None:
                    break
                self._integrate_advance()
            return ret
        if self._ba_job is not None:
            # Nothing else runs while BA owns the map, except an
            # integration once an abort has finished it.
            if self._ba_poll():
                return ret
            if self.kf_queue:
                self._integrate_push()
            return ret
        if self.kf_queue:
            self._integrate_push()
            return ret
        if not self.converged_recent and newest_kf is not None:
            self.bundle_adjust_recent(newest_kf, start_only=True)
            return ret
        if self._refind_task is not None:
            self._refind_advance()
            return ret
        if self.converged_recent and self._new_points_pending:
            self.refind_newly_made(spread=True)
            return ret
        if self.converged_recent and not self.converged_full:
            self.bundle_adjust_all(start_only=True)
            return ret
        if (self.converged_recent and self.converged_full
                and self._failures_pending and self._rng.integers(20) == 0):
            self.refind_from_failure_queue(spread=True)
            return ret
        self.handle_bad_points()
        return ret

    def _integrate_push(self):
        """Start the next queued integration; with more keyframes queued,
        advance one more phase this pass (two dispatches at most)."""
        self._integrate_start()
        for _ in range(min(1, len(self.kf_queue))):
            if self._integrate_job is None:
                break
            self._integrate_advance()
