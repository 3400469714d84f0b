"""Frame builds (port of ``ptam_cg_tpu.models.keyframe``).

``build_frame_tracking`` is the per-frame build the tracker reads
(MakeKeyFrame_Lite: pyramid atlas, FAST corner mask, SBIs).
``build_frame`` is the full keyframe build: the same, plus per level the
3x3 non-max corner list and the Shi-Tomasi candidate list
(MakeKeyFrame_Rest). FAST runs through kernel K1, one launch over the
whole pyramid atlas (the per-frame build asks it for the corner mask
alone; the keyframe build also for the scores and the corner counts), and
Shi-Tomasi through kernel K3, one launch over the atlas.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ptam_cg_tpu_torch.config import (LEVELS, MAX_CANDIDATES,
                                      MAX_NONMAX_CORNERS, FrontendConfig)
from ptam_cg_tpu_torch.ops import fast as fastops
from ptam_cg_tpu_torch.ops import image as imops
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.ops import sbi as sbiops

Tensor = torch.Tensor

#: Uniform per-level capacity of the non-max corner lists.
NONMAX_CAP = max(MAX_NONMAX_CORNERS)
CAND_CAP = MAX_CANDIDATES


@dataclasses.dataclass
class TrackFeatures:
    """What the tracker reads from a frame."""

    atlas: Tensor            # (Ha, W) packed pyramid, float32 or bfloat16
    corner_mask: Tensor      # (Ha, W) bool raw FAST corners, all levels
    sbi: sbiops.SBI          # relocalizer SBI (blur 2.5)
    sbi_track: sbiops.SBI    # rotation-estimator SBI (blur 0.75)


@dataclasses.dataclass
class FrameFeatures:
    """A keyframe's full build: ``TrackFeatures`` plus the lists."""

    atlas: Tensor            # (Ha, W) packed pyramid, float32 or bfloat16
    corner_mask: Tensor      # (Ha, W) bool raw FAST corners, all levels
    corner_count: Tensor     # (LEVELS,) int32
    max_xy: Tensor           # (LEVELS, NONMAX_CAP, 2) int32 level coords
    max_score: Tensor        # (LEVELS, NONMAX_CAP) float32 FAST score
    max_valid: Tensor        # (LEVELS, NONMAX_CAP) bool
    cand_xy: Tensor          # (LEVELS, CAND_CAP, 2) int32 level coords
    cand_score: Tensor       # (LEVELS, CAND_CAP) float32 Shi-Tomasi
    cand_valid: Tensor       # (LEVELS, CAND_CAP) bool
    sbi: sbiops.SBI          # relocalizer SBI (blur 2.5)
    sbi_track: sbiops.SBI    # rotation-estimator SBI (blur 0.75)


def make_frame_lite(im: Tensor, cfg: FrontendConfig = FrontendConfig(),
                    scores: bool = True):
    """Pyramid + FAST on every level (kernel K1, one launch over the
    atlas). Returns (pyramid, atlas, corner_mask, score maps, corner
    counts); with ``scores`` False the last two are None and K1 writes
    the corner mask alone."""
    pyramid = imops.build_pyramid(im, LEVELS)
    atlas = levelops.pack_atlas(pyramid)
    corner_mask, score_atlas, counts = fastops.fast_atlas(
        atlas, cfg.fast_thresholds, scores=scores)
    if not scores:
        return pyramid, atlas, corner_mask, None, None
    h, w = im.shape
    maps = tuple(levelops.unpack_level(score_atlas, lev, h, w)
                 for lev in range(LEVELS))
    return pyramid, atlas, corner_mask, maps, counts


def make_frame_rest(pyramid: Tuple[Tensor, ...], scores: Tuple[Tensor, ...],
                    st_maps: Tuple[Tensor, ...],
                    candidate_min_score: float = 400.0,
                    sbi_blur: float = 2.5):
    """Per level: the non-max corner list, and the candidates (non-max
    corners at least 10 px inside a level larger than 20x20, Shi-Tomasi
    score ``st_maps[lev]`` above ``candidate_min_score``); then the SBI.
    Returns ((max_xy, max_score, max_valid), (cand_xy, cand_score,
    cand_valid), SBI), the lists stacked over levels."""
    maxes, cands = [], []
    for lev in range(LEVELS):
        keep = fastops.nonmax_3x3(scores[lev])
        maxes.append(fastops.corners_from_mask(keep, scores[lev], NONMAX_CAP,
                                               tile=2))
        st = st_maps[lev]
        hl, wl = pyramid[lev].shape
        border = torch.zeros((hl, wl), dtype=torch.bool, device=st.device)
        if hl > 20 and wl > 20:
            border[10:-10, 10:-10] = True
        cand_mask = keep & border & (st > candidate_min_score)
        cands.append(fastops.corners_from_mask(cand_mask, st, CAND_CAP,
                                               tile=2))

    def stack(lists):
        return tuple(torch.stack([getattr(c, f) for c in lists])
                     for f in ("xy", "score", "valid"))

    return stack(maxes), stack(cands), sbiops.make_sbi(pyramid[3], sbi_blur)


def _stored(atlas: Tensor, cfg: FrontendConfig) -> Tensor:
    """The atlas as a frame stores it: bfloat16 with ``cfg.atlas_bf16``
    (every later read goes through K2, which returns float32 windows)."""
    return atlas.to(torch.bfloat16) if cfg.atlas_bf16 else atlas


def build_frame(im: Tensor, cfg: FrontendConfig = FrontendConfig(),
                candidate_min_score: float = 400.0, sbi_blur: float = 2.5,
                track_blur: float = 0.75) -> FrameFeatures:
    """Full keyframe build of one (H, W) float32 frame (Lite + Rest). With
    ``cfg.atlas_bf16`` the atlas is stored in bfloat16 after K1 and K3
    have read it in float32."""
    pyramid, atlas, corner_mask, scores, counts = make_frame_lite(im, cfg)
    st_atlas = imops.shi_tomasi_atlas(atlas)          # kernel K3
    h, w = im.shape
    st_maps = tuple(levelops.unpack_level(st_atlas, lev, h, w)
                    for lev in range(LEVELS))
    (mx, ms, mv), (cx, cs, cv), the_sbi = make_frame_rest(
        pyramid, scores, st_maps, candidate_min_score, sbi_blur)
    return FrameFeatures(
        atlas=_stored(atlas, cfg), corner_mask=corner_mask,
        corner_count=counts,
        max_xy=mx, max_score=ms, max_valid=mv,
        cand_xy=cx, cand_score=cs, cand_valid=cv, sbi=the_sbi,
        sbi_track=sbiops.make_sbi(pyramid[3], track_blur))


def build_frame_tracking(im: Tensor, cfg: FrontendConfig = FrontendConfig(),
                         sbi_blur: float = 2.5,
                         track_blur: float = 0.75) -> TrackFeatures:
    """Pyramid atlas + corner mask + both SBIs of one (H, W) float32 frame
    (the atlas in bfloat16 after K1 with ``cfg.atlas_bf16``)."""
    pyramid, atlas, corner_mask, _, _ = make_frame_lite(im, cfg,
                                                        scores=False)
    return TrackFeatures(atlas=_stored(atlas, cfg), corner_mask=corner_mask,
                         sbi=sbiops.make_sbi(pyramid[3], sbi_blur),
                         sbi_track=sbiops.make_sbi(pyramid[3], track_blur))
