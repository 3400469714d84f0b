"""Map bootstrap: trail tracking and two-view stereo initialization (port
of ``ptam_cg_tpu.models.initializer``).

- Trails: 9x9 MiniPatch SSD tracking of the strongest level-0 Shi-Tomasi
  candidates with a married forward/backward match, batched over every
  trail with the windowed search (``patch.ssd_search`` with
  ``zero_mean=False``; its image and corner-mask windows are one K2
  launch) and integer-centred patch cuts (one K2 launch each).
- Stereo init: homography MLESAC on the surviving trails, a wiggle-scaled
  baseline, sub-pixel alignment of every trail in the second view,
  triangulation, 5 global bundle adjustments, epipolar expansion at every
  level, bundle adjustment to convergence, and the dominant plane moved
  to z=0.

Draws are inputs: ``init_from_stereo`` takes the MLESAC uniforms and the
plane aligner's, and draws from the ``MapMaker``'s generator only those it
is not given. It reads on the host where the JAX function does: the
homography's success, the baseline's length, the point count, the
scene depth and the bundle adjustments' flags.
"""

from __future__ import annotations

import dataclasses

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import MINI_PATCH_SIZE, InitConfig
from ptam_cg_tpu_torch.models import homography as homoglib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models.keyframe import FrameFeatures
from ptam_cg_tpu_torch.models.mapmaker import MapMaker
from ptam_cg_tpu_torch.ops import patch as patchops
from ptam_cg_tpu_torch.ops.gather import gather_windows
from ptam_cg_tpu_torch.utils import geometry
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor

MINI_MAX_SSD = 100000.0      # MiniPatch SSD cap (ImageProcess.h)
TRAIL_RANGE = 10             # MiniPatch search radius, level-0 px


@dataclasses.dataclass
class TrailState:
    init_pos: Tensor   # (N, 2) level-0 position in the first keyframe
    cur_pos: Tensor    # (N, 2) current position
    patch: Tensor      # (N, 9, 9) MiniPatch cut at trail start
    valid: Tensor      # (N,) bool


def _extract_patches(atlas: Tensor, pos: Tensor, size: int):
    """Integer-centred (N, size, size) patches at atlas positions ``pos``
    (N, 2), top-left ``int(pos) - size // 2`` (GetImageROI), in one K2
    launch. A patch whose window leaves the atlas is not ``ok``; the
    gather clamps its origin. Returns (patches float32, ok (N,))."""
    Ha, Wa = atlas.shape
    o = pos.to(torch.int32) - size // 2          # truncates toward zero
    x0, y0 = o[:, 0], o[:, 1]
    ok = (x0 >= 0) & (y0 >= 0) & (x0 + size <= Wa) & (y0 + size <= Ha)
    return gather_windows(atlas, y0, x0, size).to(torch.float32), ok


def _image_bounds(n: int, image_size, device) -> Tensor:
    W, H = image_size
    b = torch.zeros((n, 4), dtype=torch.float32, device=device)
    b[:, 2] = float(W)
    b[:, 3] = float(H)
    return b


def trail_start(frame: FrameFeatures, image_size,
                max_trails: int = 1000) -> TrailState:
    """Trails at the strongest level-0 Shi-Tomasi candidates
    (TrailTracking_Start); the candidate list is sorted already."""
    n = min(max_trails, frame.cand_xy.shape[1])
    pos = frame.cand_xy[0, :n].to(torch.float32)
    patches, pok = _extract_patches(frame.atlas, pos, MINI_PATCH_SIZE)
    return TrailState(init_pos=pos, cur_pos=pos, patch=patches,
                      valid=frame.cand_valid[0, :n] & pok)


def trail_advance(trails: TrailState, prev_frame: FrameFeatures,
                  cur_frame: FrameFeatures, image_size,
                  diag: dict | None = None):
    """One frame of trail tracking with married matching
    (TrailTracking_Advance): search each trail's MiniPatch around its
    position in the current frame, cut the patch found there and search
    it back in the previous frame; a trail survives when the backward
    match lands within sqrt(2) px of where it started. ``diag``, when
    given, receives per trail the forward and backward searches' best SSD
    and its gap to the second best, and the squared return distance, so a
    parity check can tell a float-noise decision from a real difference.
    Returns (trails, number of good trails as a 0-dim int32 tensor)."""
    N = trails.cur_pos.shape[0]
    dev = trails.cur_pos.device
    bounds = _image_bounds(N, image_size, dev)
    radius = torch.full((N,), float(TRAIL_RANGE), device=dev)

    def search(frame, patch, pos):
        res, _, _ = patchops.ssd_search(
            frame.atlas, frame.corner_mask, patch, pos, radius, bounds,
            r_win=TRAIL_RANGE, max_ssd=MINI_MAX_SSD, zero_mean=False,
            patch_size=MINI_PATCH_SIZE)
        return res

    fwd = search(cur_frame, trails.patch, trails.cur_pos)
    back_patch, bok = _extract_patches(cur_frame.atlas, fwd.pos,
                                       MINI_PATCH_SIZE)
    bwd = search(prev_frame, back_patch, fwd.pos)
    ret = torch.sum((bwd.pos - trails.cur_pos) ** 2, dim=-1)
    good = trails.valid & fwd.found & bok & bwd.found & (ret <= 2.0)
    if diag is not None:
        diag.update(fwd_ssd=fwd.ssd, fwd_margin=fwd.margin, bwd_ssd=bwd.ssd,
                    bwd_margin=bwd.margin, ret=ret)
    new = dataclasses.replace(
        trails, cur_pos=torch.where(good[:, None], fwd.pos, trails.cur_pos),
        valid=good)
    return new, torch.sum(good.to(torch.int32))


def trails_to_matches(trails: TrailState, cam: atan.Camera,
                      cap: int) -> homoglib.Matches:
    """Trail pairs as z=1-plane homography matches in ``cap`` slots
    (MapMaker::InitFromStereo's match list)."""
    n = min(trails.init_pos.shape[0], cap)
    pad = cap - n
    dev = trails.init_pos.device
    first = atan.unproject(trails.init_pos[:n], cam)
    second = atan.unproject(trails.cur_pos[:n], cam)
    jac = atan.project_derivs(second, cam)
    z2 = torch.zeros((pad, 2), dtype=torch.float32, device=dev)
    eye = torch.eye(2, dtype=torch.float32, device=dev).expand(pad, 2, 2)
    return homoglib.Matches(
        first=torch.cat([first, z2]), second=torch.cat([second, z2]),
        pixel_jac=torch.cat([jac, eye]),
        valid=torch.cat([trails.valid[:n],
                         torch.zeros(pad, dtype=torch.bool, device=dev)]))


def init_from_stereo(mapmaker: MapMaker, first: FrameFeatures,
                     second: FrameFeatures, trails: TrailState,
                     u_mlesac: Tensor | None = None,
                     u_plane: Tensor | None = None,
                     cfg: InitConfig = InitConfig(),
                     stats: dict | None = None) -> SE3 | None:
    """Stereo initialization (MapMaker::InitFromStereo) into
    ``mapmaker.map``, which must be empty. ``u_mlesac``: the
    (mlesac_trials, max_matches) MLESAC uniforms; ``u_plane``: the plane
    aligner's; each not given is drawn from ``mapmaker.generator``.
    Returns keyframe 1's pose (the tracker's new pose), or None when the
    pair does not initialize. ``stats``, when given, receives the
    homography result and the number of bundle adjustments run."""
    cam = mapmaker.cam
    W, H = mapmaker.image_size
    m = mapmaker.map
    P = m.point_pos.shape[0]
    dev = m.point_pos.device

    if u_mlesac is None:
        u_mlesac = torch.rand((cfg.mlesac_trials, cfg.max_matches),
                              generator=mapmaker.generator, device=dev)
    matches = trails_to_matches(trails, cam, cfg.max_matches)
    res = homoglib.compute(matches, u_mlesac, cfg.mlesac_sigma,
                           cfg.refine_iterations)
    n_ba = 0
    if stats is not None:
        stats.update(homography=res, n_ba=n_ba)
    if not bool(res.success):
        return None
    se3 = res.se3_second_from_first
    tnorm = float(torch.linalg.vector_norm(se3.t))
    if tnorm < 1e-6:
        return None
    wiggle = mapmaker.cfg.wiggle_scale
    se3 = SE3(se3.R, se3.t * (wiggle / tnorm))

    # The two keyframes, the first fixed at the origin.
    m = ms.insert_keyframe(m, 0, first, se3lib.identity(dev), fixed=True)
    m = ms.insert_keyframe(m, 1, second, se3)

    # Sub-pixel alignment of every trail in the second view.
    n = min(trails.init_pos.shape[0], cfg.max_matches)
    init_pos = trails.init_pos[:n]
    tmpl, tok = _extract_patches(first.atlas, init_pos, 8)
    sp = patchops.subpix_refine(second.atlas, tmpl, trails.cur_pos[:n],
                                _image_bounds(n, (W, H), dev), max_its=10)
    ok = trails.valid[:n] & tok & sp.converged

    v2_first = atan.unproject(init_pos, cam)
    v2_second = atan.unproject(sp.pos, cam)
    p_world = geometry.triangulate(se3, v2_second, v2_first)
    ok = ok & (p_world[:, 2] > 0.0)

    # Points in the first n map slots.
    slot = torch.where(ok, torch.arange(n, device=dev), P)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(init_pos, zeros_i.long(), cam)

    def scat(table, values):
        return ms.scatter_drop(table, slot, values)

    m = dataclasses.replace(
        m, point_pos=scat(m.point_pos, p_world),
        point_valid=scat(m.point_valid, True),
        point_src_kf=scat(m.point_src_kf, zeros_i),
        point_src_level=scat(m.point_src_level, zeros_i),
        point_center=scat(m.point_center, init_pos),
        point_center_nc=scat(m.point_center_nc, c_nc),
        point_right_nc=scat(m.point_right_nc, r_nc),
        point_down_nc=scat(m.point_down_nc, d_nc),
        point_normal_nc=scat(m.point_normal_nc, nrm),
        point_source=scat(m.point_source, ms.SRC_ROOT),
        good=torch.ones((), dtype=torch.bool, device=dev))
    m = ms.refresh_pixel_vectors(m)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    m = ms.set_measurements(m, 0, slot, init_pos, zeros_i, ones,
                            torch.full_like(zeros_i, ms.SRC_ROOT), ok)
    m = ms.set_measurements(m, 1, slot, sp.pos, zeros_i, ones,
                            torch.full_like(zeros_i, ms.SRC_TRAIL), ok)
    mapmaker.map = m
    mapmaker.good_host = True
    mapmaker._n_kfs_host = 2
    if int(torch.sum(m.point_valid.to(torch.int32))) < 4:
        return None

    def bundle_adjust() -> bool:
        """A global BA run; True when it failed numerically (the pair is
        too ill-conditioned to initialize from; the reference's
        InitFromStereo fails there too)."""
        nonlocal n_ba
        mapmaker.bundle_adjust_all(full=True)
        n_ba += 1
        if stats is not None:
            stats["n_ba"] = n_ba
        failed = mapmaker.reset_requested
        mapmaker.reset_requested = False
        return failed

    for _ in range(5):
        if bundle_adjust():
            return None

    # Scene depth of both keyframes and the wiggle normalization.
    (d0, s0), (d1, s1) = (ms.scene_depth_for_kf(mapmaker.map, k)
                          for k in (0, 1))
    m = mapmaker.map
    mapmaker.map = dataclasses.replace(
        m, kf_depth_mean=torch.cat([torch.stack([d0, d1]),
                                    m.kf_depth_mean[2:]]),
        kf_depth_sigma=torch.cat([torch.stack([s0, s1]),
                                  m.kf_depth_sigma[2:]]))
    mapmaker.wiggle_depth_norm = wiggle / max(float(d0), 1e-6)

    # Epipolar expansion from the second keyframe at every level.
    for lev in (0, 3, 1, 2):
        mapmaker.add_some_map_points(1, lev)

    # Global BA to convergence.
    mapmaker.converged_full = False
    for _ in range(20):
        if mapmaker.converged_full:
            break
        if bundle_adjust():
            return None

    mapmaker.plane_align(u_plane)
    m = mapmaker.map
    return SE3(m.kf_R[1], m.kf_t[1])
