"""SLAMEngine: the frame loop (port of ``ptam_cg_tpu.models.engine``).

The reference's System frame loop and the Tracker's state machine
(src/System.cc:54-110, src/Tracker.cc:86-307), run synchronously: each
frame goes through one stage, then through one pass of the mapping
scheduler (``MapMaker.step``), whose queued keyframe aborts a long BA run
between chunks as the reference's abort flag does.

- NOT_STARTED: on an init request (``request_init``, or at once with
  ``auto_init_frames``) the frame's level-0 candidates start trails.
- TRAIL_TRACKING: trails follow each frame; fewer than ``min_trails``
  survivors reset; after ``auto_init_frames`` frames (or on a request)
  ``init_from_stereo`` builds the two-keyframe map, and the engine tracks
  from its second pose. A failed init resets.
- TRACKING: each frame is built and tracked, with the tracker's inlier
  and outlier counts added to the map. Its decisions are deferred one
  frame, as the JAX engine makes them with ``decision_interval=1``: the
  previous frame's info vector ``[quality, lost, n_found, need_kf,
  n_points]`` is read on the host once, at the start of the next frame;
  relocalization (``attempt_recovery`` on that frame's SBI) runs when it
  has been lost for more than ``max_lost_frames``, and a keyframe (a full
  ``build_frame`` of that frame's image) is queued when the heuristics
  ask for one. A BA failure (``MapMaker.reset_requested``) ditches the
  map.

Not ported, on purpose: ``decision_interval``, the readiness-gated
decision reads, the ``_inflight`` drain and the ``_wiggle_dev`` cache work
around a networked TPU, where every blocking read costs ~20 ms; on a
local card one read a frame is the design. ``async_mapping=True`` raises:
the port writes the map in place (``map_state.insert_keyframe``), so a
mapping thread needs a copy or a double-buffered map (a later slice).
``mesh`` (point-sharded global BA) is not a parameter.

Draws are an input (``Draws``): the engine takes each random draw from one
object, so a parity test can hand in JAX's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import EngineConfig
from ptam_cg_tpu_torch.models import initializer as initlib
from ptam_cg_tpu_torch.models import keyframe as kflib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models import mapmaker as mmlib
from ptam_cg_tpu_torch.models import relocalizer as reloclib
from ptam_cg_tpu_torch.models import tracker as trklib
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


class Stage(enum.Enum):
    NOT_STARTED = 0          # waiting for an init request
    TRAIL_TRACKING = 1       # between the two init keyframes
    TRACKING = 2             # map good, normal operation


class FrameInfo(NamedTuple):
    pose: SE3                # camera from world (a copy)
    stage: str
    quality: int
    n_found: int
    n_points: int
    n_kfs: int
    added_kf: bool
    relocalized: bool


class Draws:
    """The engine's random draws, from ``torch.Generator``s on ``device``
    seeded as the JAX engine seeds its PRNG keys: the engine's (``seed``)
    draws MLESAC's uniforms and each new tracker stream's seed, the
    tracker's (``seed + 1``) the per-frame coarse and fine uniforms, and
    the MapMaker's (``seed``) the plane aligner's. A replacement needs the
    same five methods."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.seed = seed
        self.device = torch.device(device)
        self._engine = self._generator(seed)
        self._tracker = self._generator(seed + 1)
        self._mapmaker = self._generator(seed)

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _rand(self, g: torch.Generator, shape) -> Tensor:
        return torch.rand(shape, generator=g, device=self.device)

    def rekey_tracker(self):
        """A new tracker stream: after a successful init and at reset."""
        self._tracker = self._generator(int(torch.randint(
            0, 2 ** 62, (), generator=self._engine, device=self.device)))

    def reset_mapmaker(self):
        """The MapMaker is rebuilt with ``seed`` at reset: its stream
        restarts."""
        self._mapmaker = self._generator(self.seed)

    def track(self, P: int):
        """A tracked frame's (coarse, fine) uniforms, two (P,)."""
        return self._rand(self._tracker, P), self._rand(self._tracker, P)

    def mlesac(self, trials: int, n: int) -> Tensor:
        return self._rand(self._engine, (trials, n))

    def plane(self, n_ransacs: int, P: int) -> Tensor:
        return self._rand(self._mapmaker, (n_ransacs, P))


def _copy_pose(pose: SE3) -> SE3:
    return SE3(pose.R.clone(), pose.t.clone())


class SLAMEngine:
    """Frames in (``process_frame``), poses and a growing map out.

    ``deterministic``: True makes the MapMaker's every gate block and its
    BA chunks fixed-size, so a replay gives the same map whatever the
    timing; None picks it on the CPU and latency mode on the card
    (``MapMaker``). ``draws``: the source of every random draw (default
    ``Draws(seed, device)``).
    """

    def __init__(self, cfg: EngineConfig = EngineConfig(), image_size=None,
                 max_points: int = 2048, max_kfs: int = 16, seed: int = 0,
                 auto_init_frames: int | None = 6,
                 deterministic: bool | None = None, device="cuda",
                 draws=None, async_mapping: bool = False):
        if async_mapping:
            raise NotImplementedError(
                "async_mapping is not ported: the map is written in place, "
                "so a mapping thread needs a double-buffered map")
        trklib.validate_config(cfg.tracker)
        if cfg.frontend.atlas_bf16:
            raise NotImplementedError("FrontendConfig.atlas_bf16 is not ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self._seed = seed
        self._deterministic = deterministic
        self._capacity = (max_points, max_kfs)
        self.image_size = tuple(image_size or cfg.camera.image_size)
        self.cam = atan.make_camera(cfg.camera.params, self.image_size,
                                    self.device)
        self.cam_params = torch.tensor(cfg.camera.params, dtype=torch.float32,
                                       device=self.device)
        W, H = self.image_size
        self._sbi_size = ((H >> 3) // 2, (W >> 3) // 2)
        self.draws = Draws(seed, self.device) if draws is None else draws
        self.auto_init_frames = auto_init_frames
        self.frame_idx = 0
        self.prev_features = None
        self._trail_start_idx = None
        self._new_map()

    def _new_map(self):
        """An empty map, a new MapMaker and a new tracker state."""
        P, K = self._capacity
        self.map = ms.empty_map(self.image_size, P, K, self.device)
        self.mapmaker = mmlib.MapMaker(
            self.map, self.cam, self.image_size, self.cfg.mapmaker,
            self.cfg.bundle, seed=self._seed,
            deterministic=self._deterministic)
        self.stage = Stage.NOT_STARTED
        self.tracker_state = trklib.init_tracker_state(device=self.device)
        self.trails = None
        self.first_features = None
        self.frames_since_kf = 0
        self.newest_kf = None
        #: The previous TRACKING frame: its image, tracking output and
        #: info vector, whose decisions this frame makes.
        self._pending = None
        self._prev_sbi_track = None
        self._n_points_host = 0
        self._last_quality = trklib.QUALITY_GOOD
        self._last_n_found = 0
        self._init_requested = self.auto_init_frames is not None

    def request_init(self):
        """The reference's spacebar (src/Tracker.cc:311-347)."""
        self._init_requested = True

    def reset(self):
        """Full reset (Tracker::Reset and the MapMaker's reset)."""
        self._new_map()
        self.draws.reset_mapmaker()
        self.draws.rekey_tracker()

    def _build(self, im: Tensor) -> kflib.FrameFeatures:
        return kflib.build_frame(
            im, self.cfg.frontend,
            float(self.cfg.mapmaker.candidate_min_shi_tomasi_score))

    def _to_device(self, im) -> Tensor:
        """The frame as float32 on the engine's device; a host frame is
        copied without a host sync (through pinned memory to the card),
        in its own dtype, and cast there."""
        if not isinstance(im, Tensor):
            im = torch.from_numpy(np.ascontiguousarray(im))
        if im.device != self.device:
            if self.device.type == "cuda":
                im = im.pin_memory().to(self.device, non_blocking=True)
            else:
                im = im.to(self.device)
        return im.to(torch.float32)

    def _read_info(self, info: Tensor):
        """The one host read of a tracked frame's decision scalars."""
        quality, lost, n_found, need_kf, n_points = info.tolist()
        self._last_quality, self._last_n_found = quality, n_found
        self._n_points_host = n_points
        # Keep the MapMaker's BA size tiers fed with the live point count.
        self.mapmaker._n_points_hint = n_points
        return quality, lost, n_found, need_kf

    def process_frame(self, im) -> FrameInfo:
        """One frame (System::UpdateFrame -> Tracker::TrackFrame): an (H, W)
        uint8 or float32 image, on the host or on the device."""
        im = self._to_device(im)
        cfg = self.cfg
        features = None
        if self.stage != Stage.TRACKING:
            features = self._build(im)
        added_kf = relocalized = False
        n_found = 0
        quality = None

        if self.stage == Stage.NOT_STARTED:
            if self._init_requested:
                self.trails = initlib.trail_start(
                    features, self.image_size,
                    cfg.tracker.max_initial_trails)
                self.first_features = features
                self._trail_start_idx = self.frame_idx
                self.stage = Stage.TRAIL_TRACKING
                self._init_requested = False

        elif self.stage == Stage.TRAIL_TRACKING:
            self.trails, n_good = initlib.trail_advance(
                self.trails, self.prev_features, features, self.image_size)
            n_found = int(n_good)
            if n_found < cfg.tracker.min_trails:
                self.reset()
            elif self._init_requested or (
                    self.auto_init_frames is not None
                    and self.frame_idx - self._trail_start_idx
                    >= self.auto_init_frames):
                self._init(features)

        elif self.stage == Stage.TRACKING:
            if self.mapmaker.reset_requested:
                # BA failed numerically: the map is corrupt, ditch it
                # (src/MapMaker.cc:887-892, src/Tracker.cc:67-77).
                self.reset()
                self.frame_idx += 1
                return FrameInfo(
                    pose=se3lib.identity(self.device), stage=self.stage.name,
                    quality=trklib.QUALITY_BAD, n_found=0, n_points=0,
                    n_kfs=0, added_kf=False, relocalized=False)
            relocalized, added_kf = self._track(im)
            quality, n_found = self._last_quality, self._last_n_found

        if features is not None:
            self.prev_features = features
        self.frame_idx += 1
        if quality is not None:
            n_points, q = self._n_points_host, quality
        else:   # not yet tracking, or the frame that initialized
            n_points = int(torch.sum(self.map.point_valid.to(torch.int32)))
            q = int(self.tracker_state.quality)
        return FrameInfo(
            pose=_copy_pose(self.tracker_state.pose), stage=self.stage.name,
            quality=q, n_found=n_found, n_points=n_points,
            n_kfs=self.mapmaker.n_kfs(), added_kf=added_kf,
            relocalized=relocalized)

    def _init(self, features: kflib.FrameFeatures):
        """Stereo init from the first trail frame and this one."""
        cfg = self.cfg
        u_mlesac = self.draws.mlesac(cfg.init.mlesac_trials,
                                     cfg.init.max_matches)
        u_plane = self.draws.plane(cfg.mapmaker.plane_aligner_ransacs,
                                   self._capacity[0])
        self.mapmaker.map = self.map
        pose2 = initlib.init_from_stereo(
            self.mapmaker, self.first_features, features, self.trails,
            u_mlesac, u_plane, cfg.init)
        self.map = self.mapmaker.map
        self._init_requested = False
        if pose2 is None:
            self.reset()
            return
        self.stage = Stage.TRACKING
        self.tracker_state = trklib.init_tracker_state(_copy_pose(pose2))
        self.draws.rekey_tracker()
        self.newest_kf = 1
        self.frames_since_kf = 0
        self._prev_sbi_track = features.sbi_track
        self._pending = None
        self._n_points_host = int(torch.sum(
            self.map.point_valid.to(torch.int32)))
        self.mapmaker._n_points_hint = self._n_points_host

    def _track(self, im: Tensor):
        """A TRACKING frame: the previous frame's decisions, this frame's
        build and track, the map's inlier/outlier counts, one mapping
        pass. Returns (relocalized, added_kf)."""
        cfg = self.cfg
        mm = self.mapmaker
        st = self.tracker_state
        p = self._pending
        relocalized = added_kf = False
        self.frames_since_kf += 1
        if p is not None:
            quality, lost, _, need_kf = self._read_info(p["info"])
            # Relocalize if lost (src/Tracker.cc:168-207), from the SBI of
            # the frame whose quality said lost.
            if lost > cfg.tracker.max_lost_frames:
                rr = reloclib.attempt_recovery(
                    self.map, p["out"].sbi, self.cam_params, self._sbi_size,
                    cfg.reloc.max_score, cfg.reloc.esm_iterations)
                if bool(rr.success):
                    st = dataclasses.replace(
                        st, pose=SE3(rr.pose.R, rr.pose.t),
                        velocity=torch.zeros_like(st.velocity),
                        just_recovered=torch.ones_like(st.just_recovered),
                        lost_frames=torch.zeros_like(st.lost_frames))
                    self.tracker_state = st
                    relocalized = True
            # Keyframe heuristics for that frame (src/Tracker.cc:146-166).
            if (quality == trklib.QUALITY_GOOD and need_kf
                    and self.frames_since_kf
                    > cfg.tracker.min_frames_between_kfs
                    and mm.queue_size() < cfg.mapmaker.max_queue_size
                    and mm.n_kfs() + mm.queue_size()
                    < self.map.kf_R.shape[0]):
                res, pst = p["out"].result, p["out"].state
                meas = dict(point=res.meas_point, pos=res.meas_pos,
                            level=res.meas_level, subpix=res.meas_subpix,
                            valid=res.meas_valid)
                mm.add_keyframe(self._build(p["im"]), pst.pose, meas,
                                pst.depth_mean, pst.depth_sigma)
                self.frames_since_kf = 0
                added_kf = True

        # This frame: build and track, then the decision scalars.
        P = self.map.point_pos.shape[0]
        rand_coarse, rand_fine = self.draws.track(P)
        fo = trklib.track_frame_from_image(
            st, self.map, im, self._prev_sbi_track, self.cam,
            self.image_size, self.cam_params, cfg.tracker, cfg.frontend,
            cfg.mapmaker.wiggle_scale, rand_coarse=rand_coarse,
            rand_fine=rand_fine)
        res = fo.result
        need_kf = mmlib.need_new_kf(
            self.map, fo.state.pose, fo.state.depth_mean,
            mm.wiggle_depth_norm, cfg.mapmaker.max_kf_dist_wiggle_mult)
        info = torch.stack([x.to(torch.int64) for x in (
            fo.state.quality, fo.state.lost_frames,
            torch.sum(res.meas_valid.to(torch.int32)), need_kf,
            torch.sum(self.map.point_valid.to(torch.int32)))])
        self.tracker_state = fo.state
        self._prev_sbi_track = fo.sbi_track
        self.map = dataclasses.replace(
            self.map, point_inlier=self.map.point_inlier + res.inlier_delta,
            point_outlier=self.map.point_outlier + res.outlier_delta)
        # Let bad-point GC look at the new counts now and then.
        if self.frame_idx % 20 == 0:
            mm.mark_dirty()
        if p is None:
            # The first tracked frame after init reports its own info.
            self._read_info(info)
        self._pending = dict(im=im, out=fo, info=info)

        # One mapping pass.
        mm.map = self.map
        slot = mm.step(self.newest_kf)
        self.map = mm.map
        if slot is not None:
            self.newest_kf = slot
        return relocalized, added_kf
