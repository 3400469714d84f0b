"""Trajectory evaluation: Sim(3) alignment and ATE (port of
``ptam_cg_tpu.utils.evaluate``).

A monocular map is defined up to a similarity, so the absolute trajectory
error is measured after a least-squares Sim(3) alignment (Umeyama) of the
camera centres, the TUM RGB-D protocol. The alignment runs in float64
numpy, as in the JAX package; it takes tensors (any device) or arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ptam_cg_tpu_torch.utils.se3 import SE3


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def camera_centers(poses: SE3) -> torch.Tensor:
    """Batched camera centres in world coordinates: -R^T t."""
    return -torch.einsum("nji,nj->ni", poses.R, poses.t)


def align_sim3(est, gt):
    """Umeyama similarity alignment of the (N, 3) ``est`` onto ``gt``.
    Returns (s, R, t) with gt ~= s * R @ est + t."""
    est, gt = _f64(est), _f64(gt)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(gc.T @ ec / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (ec ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_centers, gt_centers) -> float:
    """ATE RMSE (in the ground truth's units) after Sim(3) alignment."""
    s, R, t = align_sim3(est_centers, gt_centers)
    est, gt = _f64(est_centers), _f64(gt_centers)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))
