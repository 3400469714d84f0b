"""Relocalization after lost tracking (port of
``ptam_cg_tpu.models.relocalizer``): score the frame's SmallBlurryImage
against every keyframe's by SSD, ESM-align it to the best one, turn the
SE2 into a camera rotation and propose pose = rotation * best keyframe's
pose. Success when the ESM score is under ``max_score`` (Reloc2.MaxScore,
9e6) and the best keyframe is valid.

The scan over keyframes is one batched reduction, and the best keyframe
stays a tensor: nothing is read on the host. The ESM is one launch of
kernel K5 on the card (``kernels/sbi_esm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.ops import sbi as sbiops
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


@dataclasses.dataclass
class RelocResult:
    pose: SE3          # proposed camera-from-world pose
    best_kf: Tensor    # () int64
    score: Tensor      # () final ESM score
    success: Tensor    # () bool


def attempt_recovery(m: MapState, cur_sbi: sbiops.SBI, cam_params: Tensor,
                     sbi_size: Tuple[int, int], max_score: float = 9e6,
                     esm_iterations: int = 10) -> RelocResult:
    """Relocaliser::AttemptRecovery."""
    diff = m.kf_sbi - cur_sbi.template[None]
    ssd = torch.sum(diff * diff, dim=(-2, -1))
    ssd = torch.where(m.kf_valid, ssd, float("inf"))
    best = torch.argmin(ssd)                # the first minimum, as jnp

    target = sbiops.SBI(template=ms.kf_row(m.kf_sbi, best),
                        jac=ms.kf_row(m.kf_sbi_jac, best))
    rot, score = sbiops.calc_sbi_rotation(cur_sbi, target, cam_params,
                                          sbi_size, esm_iterations)
    best_pose = SE3(ms.kf_row(m.kf_R, best), ms.kf_row(m.kf_t, best))
    return RelocResult(
        pose=se3lib.mul(rot, best_pose), best_kf=best, score=score,
        success=(score < max_score) & ms.kf_row(m.kf_valid, best))
