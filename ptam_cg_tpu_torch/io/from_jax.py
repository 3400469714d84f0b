"""Build the port's state objects from the JAX package's, passed as numpy.

Each function takes a dict of field name -> ``np.ndarray`` (nested
NamedTuples as nested dicts), as ``as_numpy_tree`` makes from a JAX
NamedTuple, and returns the port's dataclass on ``device`` (the card
unless the caller passes ``device="cpu"``). Nothing here imports JAX:
``as_numpy_tree`` only calls ``np.asarray`` on the leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptam_cg_tpu_torch.camera.atan import Camera
from ptam_cg_tpu_torch.io.checkpoint import tensor_of
from ptam_cg_tpu_torch.config import BundleConfig
from ptam_cg_tpu_torch.models import bundle, homography, initializer
from ptam_cg_tpu_torch.models.keyframe import FrameFeatures, TrackFeatures
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.models.tracker import TrackerState
from ptam_cg_tpu_torch.ops.sbi import SBI
from ptam_cg_tpu_torch.utils.se3 import SE3


def as_numpy_tree(obj):
    """NamedTuple (nested) -> dict of numpy arrays; other leaves go
    through ``np.asarray``."""
    if hasattr(obj, "_asdict"):
        return {k: as_numpy_tree(v) for k, v in obj._asdict().items()}
    return np.asarray(obj)


def tensor(a, device="cuda") -> torch.Tensor:
    """A writable copy of a numpy array as a tensor of the same dtype
    (an ml_dtypes bfloat16 array, a JAX bfloat16 atlas's, as
    ``torch.bfloat16``)."""
    return tensor_of(np.asarray(a), device)


def _fields(cls, d: dict, device) -> dict:
    return {f.name: tensor(d[f.name], device) for f in dataclasses.fields(cls)}


def se3_from_numpy(d: dict, device="cuda") -> SE3:
    return SE3(tensor(d["R"], device), tensor(d["t"], device))


def camera_from_numpy(d: dict, device="cuda") -> Camera:
    return Camera(**_fields(Camera, d, device))


def sbi_from_numpy(d: dict, device="cuda") -> SBI:
    return SBI(tensor(d["template"], device), tensor(d["jac"], device))


def track_features_from_numpy(d: dict, device="cuda") -> TrackFeatures:
    """From a JAX TrackFeatures or FrameFeatures (extra fields ignored)."""
    return TrackFeatures(atlas=tensor(d["atlas"], device),
                         corner_mask=tensor(d["corner_mask"], device),
                         sbi=sbi_from_numpy(d["sbi"], device),
                         sbi_track=sbi_from_numpy(d["sbi_track"], device))


def frame_features_from_numpy(d: dict, device="cuda") -> FrameFeatures:
    """From a JAX FrameFeatures."""
    fields = {f.name: tensor(d[f.name], device)
              for f in dataclasses.fields(FrameFeatures)
              if f.name not in ("sbi", "sbi_track")}
    return FrameFeatures(**fields, sbi=sbi_from_numpy(d["sbi"], device),
                         sbi_track=sbi_from_numpy(d["sbi_track"], device))


def map_state_from_numpy(d: dict, device="cuda") -> MapState:
    """From a JAX MapState (a TrackView lacks fields the port keeps)."""
    return MapState(**_fields(MapState, d, device))


def tracker_state_from_numpy(d: dict, device="cuda",
                             seed: int = 0) -> TrackerState:
    """From a JAX TrackerState. Its PRNG key has no torch counterpart: the
    port's state gets a fresh generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrackerState(
        pose=se3_from_numpy(d["pose"], device),
        velocity=tensor(d["velocity"], device),
        msd_vel=tensor(d["msd_vel"], device),
        lost_frames=tensor(d["lost_frames"], device),
        quality=tensor(d["quality"], device),
        just_recovered=tensor(d["just_recovered"], device),
        depth_mean=tensor(d["depth_mean"], device),
        depth_sigma=tensor(d["depth_sigma"], device),
        generator=gen)


def bundle_problem_from_numpy(d: dict, device="cuda") -> bundle.BundleProblem:
    """From a JAX BundleProblem."""
    return bundle.BundleProblem(**_fields(bundle.BundleProblem, d, device))


def lm_state_from_numpy(d: dict, device="cuda",
                        cfg: BundleConfig = BundleConfig()) -> bundle.LMState:
    """From a JAX LMState; the port's measurement layout is built from its
    problem (one host read)."""
    state = bundle.init_lm(bundle_problem_from_numpy(d["problem"], device),
                           cfg)
    return dataclasses.replace(state, **{
        f.name: tensor(d[f.name], device) for f in dataclasses.fields(state)
        if f.name not in ("problem", "layout")})


def trail_state_from_numpy(d: dict, device="cuda") -> initializer.TrailState:
    """From a JAX TrailState."""
    return initializer.TrailState(**_fields(initializer.TrailState, d,
                                            device))


def matches_from_numpy(d: dict, device="cuda") -> homography.Matches:
    """From JAX homography Matches."""
    return homography.Matches(**_fields(homography.Matches, d, device))


def homography_result_from_numpy(d: dict, device="cuda"
                                 ) -> homography.HomographyResult:
    """From a JAX HomographyResult."""
    return homography.HomographyResult(
        se3_second_from_first=se3_from_numpy(d["se3_second_from_first"],
                                             device),
        H=tensor(d["H"], device), n_inliers=tensor(d["n_inliers"], device),
        success=tensor(d["success"], device))
