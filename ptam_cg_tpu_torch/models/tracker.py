"""The per-frame tracking step on tensors (port of
``ptam_cg_tpu.models.tracker``).

Stages, as in the JAX package: PVS classification of every map point,
random top-k coarse and fine subsets, warped templates, windowed ZMSSD
search, subpixel refinement, 2x10 Tukey Gauss-Newton iterations, the
motion model with the SBI rotation seed, and the quality state machine.

Where the JAX package branches or loops on device values, the port uses
masked, fixed-count forms, so the step issues no host sync:

- the coarse search and coarse pose solve always run; ``torch.where``
  selects the skip branch's zeros / input pose, which is exact;
- the subpixel loop runs its full count with settled points frozen,
  which equals the JAX early exit exactly;
- the Gauss-Newton loop runs its full count but freezes the pose once the
  JAX loop would have exited, which matches it to float noise.

Random subsets: the coarse and fine uniforms can be passed in (parity
tests hand in JAX's draws); otherwise they are drawn from the
``torch.Generator`` carried in ``TrackerState``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ptam_cg_tpu_torch.config import FrontendConfig, LEVELS, TrackerConfig
from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.models import keyframe as kflib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models.keyframe import TrackFeatures
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.ops import patch as patchops
from ptam_cg_tpu_torch.ops import sbi as sbiops
from ptam_cg_tpu_torch.utils import mest
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor

COARSE_CAP = 128           # >= 2 * coarse_max (just-recovered doubling)
FINE_CAP = 1024
TRACK_CAP = COARSE_CAP + FINE_CAP

QUALITY_BAD = 0
QUALITY_DODGY = 1
QUALITY_GOOD = 2

R_WIN = 16                 # coarse search window radius (level px)
FINE_R_WIN = 11            # fine search window radius (level px)
MAX_SSD = 8 * 8 * 500.0


@dataclasses.dataclass
class TrackerState:
    pose: SE3                  # camera from world
    velocity: Tensor           # (6,) twist per frame
    msd_vel: Tensor            # () scene-depth-scaled velocity magnitude
    lost_frames: Tensor        # () int32
    quality: Tensor            # () int32 QUALITY_*
    just_recovered: Tensor     # () bool
    depth_mean: Tensor         # ()
    depth_sigma: Tensor        # ()
    generator: torch.Generator  # draws the per-frame subset uniforms


def init_tracker_state(pose: SE3 | None = None, seed: int = 0,
                       device="cuda") -> TrackerState:
    """A tracker state at ``pose`` (the identity on ``device`` when not
    given; a given pose keeps its own device) with zero velocity, GOOD
    quality and a generator seeded with ``seed``."""
    if pose is None:
        pose = se3lib.identity(device)
    dev = pose.R.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def scalar(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device=dev)

    return TrackerState(
        pose=pose, velocity=torch.zeros(6, dtype=torch.float32, device=dev),
        msd_vel=scalar(0.0), lost_frames=scalar(0, torch.int32),
        quality=scalar(QUALITY_GOOD, torch.int32),
        just_recovered=scalar(False, torch.bool),
        depth_mean=scalar(1.0), depth_sigma=scalar(1.0), generator=gen)


@dataclasses.dataclass
class TrackResult:
    pose: SE3
    # Measurements over the working set (TRACK_CAP entries):
    meas_point: Tensor       # (T,) int64 map point index
    meas_pos: Tensor         # (T, 2) level-0 found position
    meas_level: Tensor       # (T,) int64
    meas_subpix: Tensor      # (T,) bool
    meas_valid: Tensor       # (T,) bool
    attempted: Tensor        # (LEVELS,) int32
    found: Tensor            # (LEVELS,) int32
    did_coarse: Tensor       # () bool
    depth_mean: Tensor       # ()
    depth_sigma: Tensor      # ()
    inlier_delta: Tensor     # (P,) int32
    outlier_delta: Tensor    # (P,) int32
    # Per-measurement search diagnostics (not in the JAX TrackResult):
    # the ZMSSD of the best candidate, the gap to the second best, and
    # the squared last subpixel step. Parity checks use them to tell a
    # near-tie from a real difference.
    meas_ssd: Tensor         # (T,)
    meas_ssd_margin: Tensor  # (T,)
    meas_subpix_step: Tensor  # (T,)


def validate_config(cfg: TrackerConfig) -> None:
    """Reject configs whose search radii exceed the static windows, and
    the bf16 options (TPU-only, not ported)."""
    worst_coarse = math.ceil(2.0 * cfg.coarse_range / (1 << (LEVELS - 2)))
    if worst_coarse > R_WIN - 1:
        raise ValueError(
            f"TrackerConfig.coarse_range={cfg.coarse_range} needs a search "
            f"radius of {worst_coarse} level-px at level {LEVELS - 2}, but "
            f"the window is R_WIN={R_WIN} (usable radius {R_WIN - 1}).")
    worst_fine = math.ceil(max(cfg.fine_range_after_coarse,
                               cfg.fine_range_no_coarse))
    if worst_fine > FINE_R_WIN - 1:
        raise ValueError(
            f"TrackerConfig fine range {worst_fine} exceeds the fine window "
            f"FINE_R_WIN={FINE_R_WIN} (usable radius {FINE_R_WIN - 1}).")
    if cfg.zmssd_bf16_cross:
        raise NotImplementedError(
            "TrackerConfig.zmssd_bf16_cross is not ported")


def _topk_pad(keys: Tensor, cap: int) -> Tensor:
    """top-k indices, zero-padded to ``cap`` for maps smaller than it."""
    k = min(cap, keys.shape[0])
    idx = torch.topk(keys, k).indices
    if k < cap:
        idx = torch.cat([idx, idx.new_zeros(cap - k)])
    return idx


def _project_points(pose: SE3, pts_w: Tensor, cam: atan.Camera, image_size):
    W, H = image_size
    p_cam = pts_w @ pose.R.T + pose.t
    z = p_cam[..., 2]
    z_ok = z > 0.001
    safe_z = torch.where(z_ok, z, 1.0)
    z1 = p_cam[..., :2] / safe_z[..., None]
    r_ok = torch.sum(z1 * z1, dim=-1) <= cam.largest_radius ** 2
    pix = atan.project(z1, cam)
    in_im = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
             & (pix[..., 0] <= W) & (pix[..., 1] <= H))
    ok = z_ok & r_ok & in_im & atan.project_valid(z1, cam)
    return p_cam, z1, pix, ok


def _pose_jacobian(p_cam: Tensor, cam_derivs: Tensor) -> Tensor:
    """(N, 2, 6) d(pixel)/d(left-multiplied twist)."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    gen = se3lib.motion_jacobian(p_cam)                     # (N, 6, 3)
    plane = (gen[..., :2] - p_cam[..., None, :2]
             * gen[..., 2:] * inv_z[..., None, None]) * inv_z[..., None, None]
    return cam_derivs @ plane.transpose(-1, -2)


def _search_subset(m: MapState, frame: TrackFeatures, pose: SE3,
                   cam: atan.Camera, image_size, idx: Tensor, active: Tensor,
                   range_l0, subpix_its: int, subpix_level3_only: bool,
                   r_win: int) -> dict:
    """Template warp + windowed ZMSSD + subpix for a subset of points."""
    W, H = image_size
    pts_w = m.point_pos[idx]
    p_cam, z1, pix, proj_ok = _project_points(pose, pts_w, cam, image_size)
    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w[idx], m.point_down_w[idx],
        atan.project_derivs(z1, cam))
    level = warp.level
    scale = levelops.level_scale(level)

    src_level = m.point_src_level[idx].long()
    src_center = levelops.atlas_pos(m.point_center[idx], src_level, H, W)
    m2 = patchops.inv2x2(warp.warp_inv) * scale[..., None, None]
    src_bounds = torch.stack(levelops.level_bounds(src_level, H, W), dim=-1)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, m.point_src_kf[idx], src_center, m2, src_bounds)
    attempted = active & proj_ok & warp.good & tmpl_ok

    centers = levelops.atlas_pos(levelops.level_n_pos(pix, level), level, H, W)
    radius = torch.ceil(range_l0 / scale)
    bounds = torch.stack(levelops.level_bounds(level, H, W), dim=-1)
    res, win, win_origin = patchops.ssd_search(
        frame.atlas, frame.corner_mask, templates, centers, radius, bounds,
        r_win=r_win, max_ssd=MAX_SSD)
    found = attempted & res.found

    pos_atlas = res.pos
    subpix_done = torch.zeros_like(found)
    step = torch.zeros_like(res.ssd)
    if subpix_its > 0:
        ref = patchops.subpix_refine(frame.atlas, templates, res.pos, bounds,
                                     max_its=subpix_its, windows=win,
                                     win_origin=win_origin)
        use = found & (level == LEVELS - 1) if subpix_level3_only else found
        found = torch.where(use, found & ref.converged, found)
        pos_atlas = torch.where(use[:, None], ref.pos, pos_atlas)
        subpix_done = use
        step = ref.last_step

    # Atlas coords -> level coords -> level-0 coords.
    pos_level = pos_atlas - (levelops.atlas_pos(torch.zeros_like(pos_atlas),
                                                level, H, W))
    return dict(found=found, attempted=attempted,
                pos_l0=levelops.level_zero_pos(pos_level, level),
                level=level, subpix=subpix_done & found,
                ssd=res.ssd, margin=res.margin, step=step)


def _gn_pose_iterations(pose: SE3, cam: atan.Camera, image_size,
                        pts_w: Tensor, found: Tensor, v2found: Tensor,
                        level: Tensor, n_iters: int, override_after: int,
                        override_val: float, mest_kind: int = mest.TUKEY):
    """Tukey-reweighted Gauss-Newton pose loop. Runs ``n_iters``
    iterations; once the JAX loop would have exited (in the override-sigma
    regime with a ~zero update) the pose and weights stay frozen.
    Returns (pose, final weights)."""
    sqrt_inv_noise = 1.0 / levelops.level_scale(level)
    dev = pts_w.device
    eye6 = 100.0 * torch.eye(6, dtype=torch.float32, device=dev)
    R, t = pose.R, pose.t
    w = torch.zeros(pts_w.shape[0], dtype=torch.float32, device=dev)
    settled = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(n_iters):
        pose_i = SE3(R, t)
        p_cam, z1, pix, proj_ok = _project_points(pose_i, pts_w, cam,
                                                  image_size)
        J = _pose_jacobian(p_cam, atan.project_derivs(z1, cam))
        err = (v2found - pix) * sqrt_inv_noise[:, None]
        ok = found & proj_ok
        err_sq = torch.sum(err * err, dim=-1)
        if it > override_after:
            sigma_sq = torch.full((), override_val, dtype=torch.float32,
                                  device=dev)
        else:
            sigma_sq = mest.find_sigma_squared(err_sq, ok, mest_kind,
                                               approx=True)
        w_i = torch.where(ok, mest.weight(err_sq, sigma_sq, mest_kind), 0.0)
        Js = J * sqrt_inv_noise[:, None, None]
        JTJ = torch.einsum("n,nij,nik->jk", w_i, Js, Js) + eye6
        rhs = torch.einsum("n,nij,ni->j", w_i, Js, err)
        upd = torch.linalg.solve_ex(JTJ, rhs).result
        new = se3lib.mul(se3lib.se3_exp(upd), pose_i)
        R = torch.where(settled, R, new.R)
        t = torch.where(settled, t, new.t)
        w = torch.where(settled, w, w_i)
        if it > override_after:
            settled = settled | (torch.sum(upd * upd) < 1e-10)
    return SE3(R, t), w


def local_point_mask(m: MapState, pose: SE3, n_nearest: int = 4) -> Tensor:
    """Points measured by the ``n_nearest`` valid keyframes nearest
    ``pose`` (the PVS restriction of TrackMapLocal). Ties in distance take
    the lower index, as ``lax.top_k``."""
    d = ms.closest_kf_distances(m, pose)
    neg = torch.where(torch.isfinite(d), -d, float("-inf"))
    idx = torch.sort(neg, descending=True, stable=True).indices[
        :min(n_nearest, d.shape[0])]
    near = torch.zeros_like(m.kf_valid)
    near[idx] = True
    near = near & m.kf_valid
    return torch.any(m.meas_valid & near[:, None], dim=0) & m.point_valid


def track_map(m: MapState, frame: TrackFeatures, pose: SE3, cam: atan.Camera,
              image_size, msd_vel: Tensor, just_recovered: Tensor,
              cfg: TrackerConfig = TrackerConfig(), *,
              rand_coarse: Tensor | None = None,
              rand_fine: Tensor | None = None,
              generator: torch.Generator | None = None,
              point_filter: Tensor | None = None) -> TrackResult:
    """Two-stage coarse/fine map tracking (Tracker::TrackMap).

    ``rand_coarse`` / ``rand_fine``: (P,) uniforms ranking the random
    subsets; each one not given is drawn from ``generator``.
    ``point_filter``: an optional (P,) mask restricting the PVS
    (``local_point_mask`` for TrackMapLocal).
    """
    validate_config(cfg)
    W, H = image_size
    P = m.point_pos.shape[0]
    dev = m.point_pos.device
    if rand_coarse is None:
        rand_coarse = torch.rand(P, generator=generator, device=dev)
    if rand_fine is None:
        rand_fine = torch.rand(P, generator=generator, device=dev)
    mest_kind = mest.estimator_id(cfg.mestimator)

    # ---- PVS: classify every map point ----
    p_cam, z1, pix, proj_ok = _project_points(pose, m.point_pos, cam,
                                              image_size)
    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w, m.point_down_w,
        atan.project_derivs(z1, cam))
    pvs = m.point_valid & proj_ok & warp.good
    if point_filter is not None:
        pvs = pvs & point_filter
    level = warp.level

    # ---- coarse stage ----
    n_coarse_target = torch.where(just_recovered, 2 * cfg.coarse_max,
                                  cfg.coarse_max)
    coarse_range = torch.where(just_recovered, 2.0 * cfg.coarse_range,
                               cfg.coarse_range)
    coarse_eligible = pvs & (level >= LEVELS - 2)
    n_eligible = torch.sum(coarse_eligible.to(torch.int32))
    coarse_keys = torch.where(coarse_eligible,
                              level.to(torch.float32) * 10.0 + rand_coarse,
                              float("-inf"))
    coarse_idx = _topk_pad(coarse_keys, COARSE_CAP)
    slot = torch.arange(COARSE_CAP, device=dev)
    coarse_active = ((slot < n_coarse_target) & coarse_eligible[coarse_idx]
                     & (slot < min(COARSE_CAP, P)))

    try_coarse = (not cfg.disable_coarse) & (
        (msd_vel >= cfg.coarse_min_velocity) | just_recovered)
    do_coarse = try_coarse & (n_eligible > cfg.coarse_min)

    # The search always runs; when the gate is off its results are masked
    # to the skip branch's zeros.
    cres = _search_subset(m, frame, pose, cam, image_size, coarse_idx,
                          coarse_active, coarse_range, cfg.coarse_subpix_its,
                          subpix_level3_only=False, r_win=R_WIN)
    for key in ("found", "attempted", "subpix"):
        cres[key] = cres[key] & do_coarse
    cres["pos_l0"] = torch.where(do_coarse, cres["pos_l0"], 0.0)
    cres["level"] = torch.where(do_coarse, cres["level"], 0)
    n_coarse_found = torch.sum(cres["found"].to(torch.int32))
    did_coarse = do_coarse & (n_coarse_found >= cfg.coarse_min)

    coarse_pts = m.point_pos[coarse_idx]
    coarse_pose, _ = _gn_pose_iterations(
        pose, cam, image_size, coarse_pts, cres["found"], cres["pos_l0"],
        cres["level"], cfg.pose_iterations, override_after=5,
        override_val=1.0, mest_kind=mest_kind)
    pose_after_coarse = SE3(torch.where(did_coarse, coarse_pose.R, pose.R),
                            torch.where(did_coarse, coarse_pose.t, pose.t))

    # ---- fine stage ----
    # Coarse points stay in the iteration set whenever the coarse search
    # ran. An add, not a set: padded duplicate indices must not erase
    # true entries.
    coarse_used = coarse_active & do_coarse
    in_coarse = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
        0, coarse_idx, coarse_used.to(torch.int32)) > 0
    fine_eligible = pvs & ~in_coarse
    fine_keys = torch.where(
        fine_eligible,
        (level == LEVELS - 1).to(torch.float32) * 10.0 + rand_fine,
        float("-inf"))
    fine_idx = _topk_pad(fine_keys, FINE_CAP)
    n_fine_allowed = torch.clamp(
        cfg.max_patches_per_frame - torch.sum(coarse_used.to(torch.int32)),
        min=0)
    fslot = torch.arange(FINE_CAP, device=dev)
    fine_active = ((fslot < n_fine_allowed) & fine_eligible[fine_idx]
                   & (fslot < min(FINE_CAP, P)))
    fine_range = torch.where(did_coarse, cfg.fine_range_after_coarse,
                             cfg.fine_range_no_coarse)
    fres = _search_subset(m, frame, pose_after_coarse, cam, image_size,
                          fine_idx, fine_active, fine_range, subpix_its=8,
                          subpix_level3_only=not cfg.subpix_all,
                          r_win=FINE_R_WIN)

    # ---- combined GN over coarse + fine measurements ----
    def both(key):
        return torch.cat([cres[key], fres[key]])

    all_idx = torch.cat([coarse_idx, fine_idx])
    all_found = both("found")
    all_level = both("level")
    all_pts = m.point_pos[all_idx]
    final_pose, final_w = _gn_pose_iterations(
        pose_after_coarse, cam, image_size, all_pts, all_found,
        both("pos_l0"), all_level, cfg.pose_iterations, override_after=5,
        override_val=16.0, mest_kind=mest_kind)

    def count(index, values, n):
        return torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, index, values.to(torch.int32))

    # Outlier accounting at the last iteration.
    inlier_delta = count(all_idx, all_found & (final_w > 0.0), P)
    outlier_delta = count(all_idx, all_found & (final_w == 0.0), P)
    attempted = count(all_level, both("attempted"), LEVELS)
    found_stats = count(all_level, all_found, LEVELS)

    # ---- scene depth ----
    zs = _project_points(final_pose, all_pts, cam, image_size)[0][..., 2]
    nf = torch.sum(all_found.to(torch.float32))
    zsum = torch.sum(torch.where(all_found, zs, 0.0))
    zsq = torch.sum(torch.where(all_found, zs * zs, 0.0))
    depth_ok = nf > 20
    nf1 = torch.clamp(nf, min=1.0)
    mean = torch.where(depth_ok, zsum / nf1, 1.0)
    sigma = torch.where(
        depth_ok, torch.sqrt(torch.clamp(zsq / nf1 - mean * mean, min=1e-12)),
        1.0)

    return TrackResult(
        pose=final_pose, meas_point=all_idx, meas_pos=both("pos_l0"),
        meas_level=all_level, meas_subpix=both("subpix"),
        meas_valid=all_found, attempted=attempted, found=found_stats,
        did_coarse=did_coarse, depth_mean=mean, depth_sigma=sigma,
        inlier_delta=inlier_delta, outlier_delta=outlier_delta,
        meas_ssd=both("ssd"), meas_ssd_margin=both("margin"),
        meas_subpix_step=both("step"))


@dataclasses.dataclass
class FrameOutput:
    state: TrackerState
    result: TrackResult
    sbi_score: Tensor


def track_frame(state: TrackerState, m: MapState, frame: TrackFeatures,
                prev_sbi: sbiops.SBI, cam: atan.Camera, image_size,
                cam_params: Tensor, cfg: TrackerConfig = TrackerConfig(),
                wiggle_scale: float = 0.1, *,
                rand_coarse: Tensor | None = None,
                rand_fine: Tensor | None = None) -> FrameOutput:
    """Motion-model predict (with the SBI rotation seed), track_map,
    motion-model update and quality assessment (Tracker::TrackFrame).
    Uniforms not passed in are drawn from ``state.generator``. With
    ``cfg.track_local``, the PVS is restricted to the points of the
    ``cfg.track_local_kfs`` keyframes nearest the predicted pose
    (TrackMapLocal)."""
    W, H = image_size
    dev = state.velocity.device
    sbi_size = ((H >> 3) // 2, (W >> 3) // 2)

    start_pose = state.pose
    vel = state.velocity
    if cfg.use_rotation_estimator:
        rot, score = sbiops.calc_sbi_rotation(frame.sbi_track, prev_sbi,
                                              cam_params, sbi_size, 10)
        vel = torch.cat([torch.zeros(2, dtype=torch.float32, device=dev),
                         vel[2:3], se3lib.so3_log(rot.R)])
    else:
        score = torch.zeros((), dtype=torch.float32, device=dev)
    pred_pose = se3lib.mul(se3lib.se3_exp(vel), start_pose)
    res = track_map(m, frame, pred_pose, cam, image_size, state.msd_vel,
                    state.just_recovered, cfg, rand_coarse=rand_coarse,
                    rand_fine=rand_fine, generator=state.generator,
                    point_filter=(local_point_mask(m, pred_pose,
                                                   cfg.track_local_kfs)
                                  if cfg.track_local else None))

    # ---- UpdateMotionModel ----
    motion = se3lib.se3_log(se3lib.mul(res.pose, se3lib.inv(start_pose)))
    if cfg.use_constant_velocity:
        new_vel = motion
    else:
        new_vel = 0.9 * (0.5 * motion + 0.5 * state.velocity)
    depth = torch.clamp(res.depth_mean, min=1e-6)
    v6 = torch.cat([new_vel[:3] * (1.0 / depth), new_vel[3:]])
    msd_vel = torch.linalg.vector_norm(v6)

    # ---- AssessTrackingQuality ----
    total_att = torch.sum(res.attempted)
    total_found = torch.sum(res.found)
    large_att = torch.sum(res.attempted[2:])
    large_found = torch.sum(res.found[2:])
    frac = total_found / torch.clamp(total_att, min=1).to(torch.float32)
    large_frac = torch.where(
        large_att > 10,
        large_found / torch.clamp(large_att, min=1).to(torch.float32), frac)
    kf_dist = torch.min(ms.closest_kf_distances(m, res.pose))
    far_from_map = kf_dist > cfg.quality_max_kf_dist_mult * wiggle_scale
    quality = torch.where(
        (total_found == 0) | (total_att == 0), QUALITY_BAD,
        torch.where(frac > cfg.tracking_quality_good, QUALITY_GOOD,
                    torch.where(large_frac < cfg.tracking_quality_lost,
                                QUALITY_BAD,
                                torch.where(far_from_map, QUALITY_BAD,
                                            QUALITY_DODGY)))).to(torch.int32)
    lost = torch.where(quality == QUALITY_BAD, state.lost_frames + 1,
                       0).to(torch.int32)
    new_state = TrackerState(
        pose=res.pose, velocity=new_vel, msd_vel=msd_vel, lost_frames=lost,
        quality=quality, just_recovered=torch.zeros_like(state.just_recovered),
        depth_mean=res.depth_mean, depth_sigma=res.depth_sigma,
        generator=state.generator)
    return FrameOutput(state=new_state, result=res, sbi_score=score)


@dataclasses.dataclass
class FusedFrameOutput:
    state: TrackerState
    result: TrackResult
    sbi_score: Tensor
    sbi: sbiops.SBI          # relocalizer SBI of this frame
    sbi_track: sbiops.SBI    # rotation-estimator SBI (next frame's prev)


def track_frame_from_image(state: TrackerState, m: MapState, im: Tensor,
                           prev_sbi: sbiops.SBI, cam: atan.Camera, image_size,
                           cam_params: Tensor,
                           cfg: TrackerConfig = TrackerConfig(),
                           frontend_cfg: FrontendConfig = FrontendConfig(),
                           wiggle_scale: float = 0.1, *,
                           rand_coarse: Tensor | None = None,
                           rand_fine: Tensor | None = None
                           ) -> FusedFrameOutput:
    """The per-frame step: frontend build (pyramid atlas, FAST corner mask,
    SBIs) then ``track_frame``."""
    ff = kflib.build_frame_tracking(im, frontend_cfg)
    out = track_frame(state, m, ff, prev_sbi, cam, image_size, cam_params,
                      cfg, wiggle_scale, rand_coarse=rand_coarse,
                      rand_fine=rand_fine)
    return FusedFrameOutput(state=out.state, result=out.result,
                            sbi_score=out.sbi_score, sbi=ff.sbi,
                            sbi_track=ff.sbi_track)
