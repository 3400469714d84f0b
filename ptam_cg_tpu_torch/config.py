"""Typed configuration for the whole engine (the port's own copy).

A field-for-field copy of ``ptam_cg_tpu/config.py``: the same capacity
constants and frozen dataclasses with the same defaults, the TPU-only
fields included (``FrontendConfig.pallas_stencils``, ``atlas_bf16``,
``TrackerConfig.zmssd_bf16_cross``, ``BundleConfig.soff_tiles``), so the
port imports nothing of the JAX package. ``tests/test_torch_config.py``
holds the two equal.

Every tunable keeps the reference's name (in snake_case) and default
(ref: config/settings.cfg). Static capacity constants (MAX_*) replace the
reference's variable-length vectors: fixed-capacity arrays plus validity
masks keep every shape static.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Static shape capacities (compile-time constants).
# ---------------------------------------------------------------------------

#: Pyramid levels (ref: include/KeyFrame.h:34  LEVELS=4).
LEVELS: int = 4

#: Max FAST corners kept per pyramid level (fixed capacity + mask).
#: Level 0 of a 640x480 frame commonly yields ~2-4k corners at threshold 10.
MAX_CORNERS: Tuple[int, ...] = (4096, 2048, 1024, 512)

#: Max nonmax-suppressed corners per level (ref uses full list; we cap).
MAX_NONMAX_CORNERS: Tuple[int, ...] = (2048, 1024, 512, 256)

#: Max Shi-Tomasi candidates per level (map-point candidates,
#: ref: src/KeyFrame.cc:72-78).
MAX_CANDIDATES: int = 512

#: Fixed map capacities (points / keyframes / measurements); the reference's
#: dynamically-grown vectors + trash list (ref: include/Map.h:8-13,32-46)
#: become validity masks over these.
MAX_POINTS: int = 8192
MAX_KEYFRAMES: int = 128
#: Max measurements per keyframe (ref: meas map per KF, unbounded).
MAX_MEAS_PER_KF: int = 1024

#: Patch sizes (ref: src/PatchFinder.cc:14-19 8x8; src/ImageProcess.h 9x9 mini).
PATCH_SIZE: int = 8
MINI_PATCH_SIZE: int = 9

#: SBI (SmallBlurryImage) size: quarter of level 3 = 1/16 scale of 640x480
#: (ref: src/ImageProcess.cc:279-304).
SBI_SHAPE: Tuple[int, int] = (30, 40)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """ATAN camera parameters, normalized by image size.

    ref: include/ATANCamera.h:59-64, config/camera.cfg.
    [fx fy cx cy w]; defaults are the reference's calibrated camera.cfg.
    """

    params: Tuple[float, float, float, float, float] = (
        1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
    image_size: Tuple[int, int] = (640, 480)  # (width, height)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """ref: config/settings.cfg:11-25 + code defaults in src/Tracker.cc."""

    max_initial_trails: int = 1000
    rotation_estimator_blur: float = 0.75
    use_rotation_estimator: bool = True
    use_constant_velocity: bool = True
    coarse_min: int = 20          # ref: src/Tracker.cc:491-496
    coarse_max: int = 60
    coarse_range: float = 30.0
    coarse_subpix_its: int = 8
    disable_coarse: bool = False
    coarse_min_velocity: float = 0.006
    max_patches_per_frame: int = 1000   # ref: src/Tracker.cc:596
    tracking_quality_good: float = 0.3  # ref: src/Tracker.cc:1090
    tracking_quality_lost: float = 0.13
    mestimator: str = "tukey"
    #: GN iterations per stage (ref: src/Tracker.cc:552,615).
    pose_iterations: int = 10
    #: Fine-stage search range in px: 5 if coarse already ran (pose is
    #: good), else 10 (ref: src/Tracker.cc:578 "mbDidCoarse ? 5 : 10").
    fine_range_after_coarse: float = 5.0
    fine_range_no_coarse: float = 10.0
    #: Lost-frame count that triggers relocalization (ref: src/Tracker.cc:129).
    max_lost_frames: int = 2
    #: Min frames between keyframes (ref: src/Tracker.cc:163 "20 frames").
    min_frames_between_kfs: int = 20
    #: Trail-init minimum surviving trails (ref: src/Tracker.cc:328-332).
    min_trails: int = 10
    #: TrackMapLocal: restrict the PVS to points measured by the
    #: ``track_local_kfs`` keyframes nearest the predicted pose
    #: (ref: src/Tracker.cc:700-857 — a variant with no automatic
    #: activation in the reference either; enable via config).
    track_local: bool = False
    track_local_kfs: int = 4
    #: DODGY-branch lost check: camera further than this multiple of
    #: WiggleScale from the nearest KF -> BAD (ref: src/Tracker.cc:1098).
    quality_max_kf_dist_mult: float = 10.0
    #: Sub-pixel-refine EVERY fine-stage measurement, not only level-3.
    #: The reference restricts subpix to level-3 fine points purely for
    #: CPU cost (ref: src/Tracker.cc:586-607); the batched TPU search
    #: computes the refinement for all points anyway, and using it removes
    #: the systematic integer-corner quantization bias. Set False for
    #: strict reference-behavior parity.
    subpix_all: bool = True
    #: Compute the ZMSSD cross-correlation term's products in bfloat16
    #: (f32 accumulation). Image values are uint8-in-spec so products are
    #: near-exact; halves the VPU element width of the hottest remaining
    #: tracking-loop op (~0.5 ms of the ~3.3 ms track program).
    #: Perf experiment — see BASELINE.md ledger for the measured outcome.
    zmssd_bf16_cross: bool = False


@dataclasses.dataclass(frozen=True)
class MapMakerConfig:
    """ref: config/settings.cfg:27-30 + src/MapMaker.cc defaults."""

    candidate_min_shi_tomasi_score: float = 400.0
    wiggle_scale: float = 0.1            # ref: src/MapMaker.cc:34
    max_kf_dist_wiggle_mult: float = 1.0  # cfg overrides code 0.05
    plane_aligner_ransacs: int = 100
    #: Outlier GC thresholds (ref: src/MapMaker.cc:131-153).
    bad_point_outlier_min: int = 20
    #: Candidate thinning exclusion radius px (ref: src/MapMaker.cc:415-441).
    thin_candidates_radius: float = 10.0
    #: KF queue cap before tracker stops adding (ref: src/Tracker.cc:163).
    max_queue_size: int = 3
    #: Max LM iterations per mapping priority pass. The reference's BA
    #: runs on its own CPU thread and is preempted by the abort flag
    #: (ref: src/MapMaker.cc:486-487); in the synchronous engine a BA
    #: pass shares the frame budget, so it runs at most this many inner
    #: iterations (as ONE device dispatch) and resumes next pass.
    ba_steps_per_pass: int = 5
    #: Wall-clock budget (ms) for one BA chunk dispatch: the scheduler
    #: sizes each chunk's iteration count from a measured per-step EMA
    #: so the chip is never held by BA for much longer than one frame
    #: interval — the tracker keeps its latency through global BA like
    #: the reference's two-thread split (ref: src/MapMaker.cc:57-114).
    #: ba_steps_per_pass stays the hard per-chunk cap.
    ba_latency_budget_ms: float = 15.0


@dataclasses.dataclass(frozen=True)
class BundleConfig:
    """ref: src/Bundle.cc:40-42 + settings.cfg:32."""

    mestimator: str = "tukey"
    max_iterations: int = 20
    update_squared_convergence_limit: float = 1e-6
    #: LM lambda schedule (ref: src/Bundle.cc:601-611).
    lambda_initial: float = 1e-4  # ref: Bundle ctor mdLambda (src/Bundle.cc:108)
    lambda_good_mult: float = 0.3
    lambda_bad_mult: float = 2.0
    lambda_factor_initial: float = 2.0
    #: Robust sigma floor in px (ref: src/Bundle.cc:234 min 0.4).
    min_sigma: float = 0.4
    #: Memory-lean LM step (round 5). At the 500-KF north star the
    #: default step's peak working set is ~5 GB (dense W 1.8 GB + the
    #: full (C6, 3P) WV product 1.8 GB + a (M, C) one-hot 1.0 GB); on
    #: the shared-service backend that pressure costs ~7-15 s per call
    #: of non-device overhead while the actual device compute is
    #: ~0.4 s. ``soff_tiles`` > 1 accumulates the Schur S_off over P in
    #: that many tiles via lax.scan — the full WV never materializes —
    #: and ``u_chunks`` > 1 likewise chunks the U one-hot dot over M.
    #: Both fall back to the dense path unless P (resp. M) is exactly
    #: divisible. 0 = off (the right choice at product tiers, where the
    #: temps are small and the scan is pure overhead).
    soff_tiles: int = 0
    u_chunks: int = 0


@dataclasses.dataclass(frozen=True)
class RelocConfig:
    """ref: config/settings.cfg:34, src/Relocaliser.cc:37."""

    max_score: float = 9e6
    #: ESM iterations for SBI alignment.
    esm_iterations: int = 10


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Stereo-init / homography tunables (ref: src/HomographyInit.cc)."""

    mlesac_trials: int = 300       # ref: src/HomographyInit.cc:188
    mlesac_sigma: float = 5.0      # MLESAC error tolerance (ref: :43)
    refine_iterations: int = 5     # ref: :57-58
    max_matches: int = 1024        # static capacity for trail matches


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """FAST / Shi-Tomasi frontend (ref: src/KeyFrame.cc:35-42)."""

    fast_thresholds: Tuple[int, ...] = (10, 15, 15, 10)
    #: ZMSSD acceptance: 8*8*500 (ref: src/PatchFinder.cc:18-19).
    max_ssd_per_pixel: float = 500.0
    #: Sub-pixel convergence limit px (ref: src/PatchFinder.cc:252).
    subpix_conv_limit: float = 0.03
    #: Max sub-pixel iterations (ref: src/PatchFinder.cc:255 - 10).
    subpix_max_its: int = 10
    #: MiniPatch SSD cap (ref: src/ImageProcess.h:39 100000) and default
    #: trail search range (ref: include/ImageProcess.h:43 10 px).
    mini_patch_max_ssd: float = 100000.0
    mini_patch_range: int = 10
    #: Store the packed pyramid atlas in bfloat16: halves the HBM traffic
    #: of the window gathers and runs the one-hot row/column selection
    #: dots at bf16 MXU rate. The reference's image precision is uint8
    #: (ref: src/ImageProcess.cc:130-163 operates on byte images), so the
    #: ~0.5-graylevel bf16 rounding is within spec; all ZMSSD/subpix math
    #: stays float32 (gathers convert on output).
    atlas_bf16: bool = False
    #: Use the fused Pallas row-band stencils (ops/pallas_kernels.py)
    #: for the per-level FAST corner+score and Shi-Tomasi maps instead
    #: of the dense XLA shift-and-blend formulation. Only takes effect
    #: on a real TPU backend (falls back to XLA elsewhere); parity is
    #: bound by tests/test_fast.py. Off by default pending a measured
    #: win on the frontend dispatch.
    pallas_stencils: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level bundle of all subsystem configs."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapmaker: MapMakerConfig = dataclasses.field(default_factory=MapMakerConfig)
    bundle: BundleConfig = dataclasses.field(default_factory=BundleConfig)
    reloc: RelocConfig = dataclasses.field(default_factory=RelocConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> EngineConfig:
    return EngineConfig()
