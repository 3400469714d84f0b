"""Homography two-view initialization (port of
``ptam_cg_tpu.models.homography``): MLESAC over 4-point DLT homographies,
Tukey-weighted refinement, the Faugeras-Lustman decomposition into 8
(R, t, n, d) candidates and the two-round visibility choice with a
Sampson tiebreak.

The 300 MLESAC trials are one batch of 9x9 null-space solves
(``geometry.smallest_eigvec``, a fixed-sweep Jacobi: nothing syncs or
raises), and the 3x3 SVD of the decomposition is ``geometry.svd3``. The
trials' uniforms are an input (``u``, (trials, N)); each ranking that
JAX takes with ``lax.top_k`` or ``argsort`` is a stable sort here, so ties
go to the lower index as there. Nothing is read on the host.

Matches are z=1-plane coordinates in both views with the 2x2 pixel
projection jacobian at the second view's match for error scaling.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ptam_cg_tpu_torch.utils import geometry
from ptam_cg_tpu_torch.utils import mest
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.geometry import spd_solve
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


@dataclasses.dataclass
class Matches:
    first: Tensor      # (N, 2) z=1-plane coords in view 1
    second: Tensor     # (N, 2) z=1-plane coords in view 2
    pixel_jac: Tensor  # (N, 2, 2) d(pixel)/d(plane) at the match
    valid: Tensor      # (N,) bool


@dataclasses.dataclass
class HomographyResult:
    se3_second_from_first: SE3
    H: Tensor          # (3, 3) refined homography (second = H @ first)
    n_inliers: Tensor  # () int32
    success: Tensor    # () bool


def _unproj(v: Tensor) -> Tensor:
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def _dlt_rows(first: Tensor, second: Tensor) -> Tensor:
    """Two DLT rows per correspondence (HomographyFromMatches).
    first/second: (..., 2) -> (..., 2, 9)."""
    x, y = first[..., 0], first[..., 1]
    u, v = second[..., 0], second[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r0 = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], -1)
    r1 = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], -1)
    return torch.stack([r0, r1], dim=-2)


def _h_from_rows(rows: Tensor) -> Tensor:
    """Null space of stacked DLT rows (..., R, 9) -> (..., 3, 3)."""
    AtA = rows.transpose(-1, -2) @ rows
    h = geometry.smallest_eigvec(AtA)
    return h.reshape(*h.shape[:-1], 3, 3)


def homography_from_matches(m: Matches) -> Tensor:
    """All-inlier DLT homography (masked)."""
    rows = _dlt_rows(m.first, m.second)                 # (N, 2, 9)
    rows = rows * m.valid[:, None, None].to(rows.dtype)
    return _h_from_rows(rows.reshape(-1, 9))


def _transfer(H: Tensor, first: Tensor) -> Tensor:
    """(..., N, 2) z=1-plane images of ``first`` (N, 2) under H (..., 3, 3),
    the depth guarded away from 0."""
    proj = _unproj(first) @ H.transpose(-1, -2)
    z = proj[..., 2]
    z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    return proj[..., :2] / z[..., None]


def _pixel_errors(H: Tensor, m: Matches) -> Tensor:
    """Squared pixel-scaled transfer error per match (MLESACScore)."""
    err = m.second - _transfer(H, m.first)
    pix = (m.pixel_jac @ err[..., None])[..., 0]
    return torch.sum(pix * pix, dim=-1)


def _top_k_stable(keys: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest entries of each row, largest first,
    ties to the lower index (``lax.top_k``)."""
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def mlesac_homography(m: Matches, u: Tensor, max_pixel_error: float = 5.0
                      ) -> Tensor:
    """Batched MLESAC (BestHomographyFromMatches_MLESAC): one trial a row
    of the (trials, N) uniforms ``u``, which rank the valid matches; each
    trial's 4 highest-ranked matches give a DLT homography, scored by the
    capped squared pixel error over all matches."""
    trials = u.shape[0]
    err_cap = max_pixel_error * max_pixel_error
    n_valid = torch.clamp(torch.sum(m.valid.to(torch.int32)), min=1)

    keys = torch.where(m.valid[None, :], u, -1.0)
    idx4 = _top_k_stable(keys, 4)                       # (trials, 4)
    rows = _dlt_rows(m.first[idx4], m.second[idx4]).reshape(trials, 8, 9)
    Hs = _h_from_rows(rows)                             # (trials, 3, 3)

    err = m.second[None] - _transfer(Hs, m.first)       # (trials, N, 2)
    pix = (m.pixel_jac[None] @ err[..., None])[..., 0]
    sq = torch.sum(pix * pix, dim=-1)
    score = torch.sum(torch.where(m.valid[None], torch.clamp(sq, max=err_cap),
                                  0.0), dim=-1)
    best = torch.argmin(score)                  # the first minimum, as jnp
    H_ransac = Hs[best.reshape(1)][0]
    # Few matches: plain DLT on everything.
    H_all = homography_from_matches(m)
    return torch.where(n_valid < 10, H_all, H_ransac)


def refine_homography(H: Tensor, m: Matches, inlier: Tensor) -> Tensor:
    """One Tukey-weighted least-squares iteration
    (RefineHomographyWithInliers)."""
    up = _unproj(m.first)                               # (N, 3)
    proj = up @ H.T
    denom = proj[..., 2]
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    v2 = proj[..., :2] / denom[..., None]
    err = (m.pixel_jac @ (m.second - v2)[..., None])[..., 0]     # (N, 2)
    err_sq = torch.sum(err * err, dim=-1)

    # d(v2)/d(H entries), rows as the reference builds them.
    zero = torch.zeros_like(up)
    jx = torch.cat([up / denom[..., None], zero,
                    -up * (proj[..., 0] / (denom * denom))[..., None]], -1)
    jy = torch.cat([zero, up / denom[..., None],
                    -up * (proj[..., 1] / (denom * denom))[..., None]], -1)
    J = m.pixel_jac @ torch.stack([jx, jy], dim=-2)     # (N, 2, 9)

    sigma_sq = mest.find_sigma_squared(err_sq, inlier, mest.TUKEY)
    w = torch.where(inlier, mest.weight(err_sq, sigma_sq, mest.TUKEY), 0.0)
    JTJ = torch.einsum("n,nij,nik->jk", w, J, J)
    rhs = torch.einsum("n,nij,ni->j", w, J, err)
    # The JAX package's ridge: it damps only the homography's scale gauge,
    # which the transfer error ignores, and keeps the system SPD.
    ridge = 1.0 + 1e-5 * torch.trace(JTJ) / 9.0
    eye = torch.eye(9, dtype=JTJ.dtype, device=JTJ.device)
    upd = spd_solve(JTJ + ridge * eye, rhs)
    return H + upd.reshape(3, 3)


@functools.lru_cache(maxsize=None)
def _candidate_signs(device):
    """The candidates' sign patterns (e1, e3), made once per device: a
    host-to-device copy waits for the device."""
    return (torch.tensor([1.0, -1.0, 1.0, -1.0], device=device),
            torch.tensor([1.0, 1.0, -1.0, -1.0], device=device))


def decompose_homography(H: Tensor):
    """Faugeras-Lustman decomposition into 8 candidates
    (DecomposeHomography). Returns (R (8, 3, 3), t (8, 3), n (8, 3),
    d (8,), ok ())."""
    U, diag, V = geometry.svd3(H)
    dev = H.device
    d1, d2, d3 = torch.abs(diag[0]), torch.abs(diag[1]), torch.abs(diag[2])
    s = geometry.det3(U) * geometry.det3(V)
    # Equal singular values: fail, as the reference does.
    ok = (torch.abs(d1 - d2) > 1e-6 * d1) & (torch.abs(d2 - d3) > 1e-6 * d1)

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    x3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    e1, e3 = _candidate_signs(dev)
    d2s = torch.clamp(d2, min=1e-12)
    zeros, ones = torch.zeros(4, device=dev), torch.ones(4, device=dev)

    def candidates(sin_t, cos_t, flip, t_x, t_z, d):
        cos_t = cos_t.expand(4)
        Rp = torch.stack([
            torch.stack([cos_t, zeros, -flip * sin_t], -1),
            torch.stack([zeros, flip * ones, zeros], -1),
            torch.stack([sin_t, zeros, flip * cos_t], -1)], dim=-2)
        tp = torch.stack([t_x, zeros, t_z], -1)
        np_ = torch.stack([x1 * e1, zeros, x3 * e3], -1)
        return Rp, tp, np_, d.expand(4)

    # d' > 0, then d' < 0.
    pos = candidates((d1 - d3) * x1 * x3 * e1 * e3 / d2s,
                     (d1 * x3 * x3 + d3 * x1 * x1) / d2s, 1.0,
                     (d1 - d3) * x1 * e1, (d1 - d3) * -x3 * e3, s * d2)
    neg = candidates((d1 + d3) * x1 * x3 * e1 * e3 / d2s,
                     (d3 * x1 * x1 - d1 * x3 * x3) / d2s, -1.0,
                     (d1 + d3) * x1 * e1, (d1 + d3) * x3 * e3, -s * d2)
    Rp, tp, np_all, dd = (torch.cat([a, b]) for a, b in zip(pos, neg))

    R = s * (U @ Rp @ V.T)
    t = tp @ U.T
    n = np_all @ V.T
    return R, t, n, dd, ok


def choose_best_decomposition(H: Tensor, R: Tensor, t: Tensor, n: Tensor,
                              d: Tensor, m: Matches, inlier: Tensor,
                              max_pixel_error: float = 5.0) -> Tensor:
    """Two-round visibility scoring and the Sampson tiebreak
    (ChooseBestDecomposition). Returns the chosen candidate's index."""
    up = _unproj(m.first)                               # (N, 3)
    inl = inlier.to(torch.float32)

    # Round 1: the homography's third row over d positive.
    third = up @ H[2]                                   # (N,)
    vis1 = third[None, :] / d[:, None]                  # (8, N)
    score1 = -torch.sum((vis1 > 0).to(torch.float32) * inl[None], dim=-1)
    rank1 = torch.sort(score1, stable=True).indices
    in_top4 = torch.zeros(8, dtype=torch.bool, device=H.device)
    in_top4[rank1[:4]] = True

    # Round 2: point-plane visibility n.x / d > 0 among the best 4.
    vis2 = (n @ up.T) / d[:, None]
    score2 = -torch.sum((vis2 > 0).to(torch.float32) * inl[None], dim=-1)
    score2 = torch.where(in_top4, score2, 1.0)
    rank2 = torch.sort(score2, stable=True).indices
    top2 = rank2[:2]                                    # i0, i1

    # Ambiguity ratio of the two best counts (both negative).
    s01 = score2[top2]
    ratio = s01[1] / torch.clamp(s01[0], max=-1e-9)

    # Sampson error sums of the two finalists.
    x1 = _unproj(m.first)
    x2 = _unproj(m.second)
    E = se3lib.hat(t[top2]) @ R[top2]                   # (2, 3, 3)
    Ex1 = x1 @ E.transpose(-1, -2)                      # (2, N, 3)
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    val = num / torch.clamp(den, min=1e-12)
    cap = 4.0 * max_pixel_error * max_pixel_error
    samp = torch.sum(torch.where(m.valid, torch.clamp(val, max=cap), 0.0),
                     dim=-1)
    pick_second = (ratio >= 0.9) & (samp[1] < samp[0])
    return torch.where(pick_second, top2[1], top2[0])


def compute(m: Matches, u: Tensor, max_pixel_error: float = 5.0,
            refine_iters: int = 5) -> HomographyResult:
    """The whole pipeline (HomographyInit::Compute): MLESAC over the
    (trials, N) uniforms ``u``, inliers under ``max_pixel_error`` px,
    ``refine_iters`` refinements, decomposition and choice. Float32
    products throughout (TF32 must stay off)."""
    H = mlesac_homography(m, u, max_pixel_error)
    err_sq = _pixel_errors(H, m)
    inlier = m.valid & (err_sq < max_pixel_error * max_pixel_error)
    for _ in range(refine_iters):
        H = refine_homography(H, m, inlier)
    R, t, n, d, ok = decompose_homography(H)
    idx = choose_best_decomposition(H, R, t, n, d, m, inlier,
                                    max_pixel_error).reshape(1)
    n_inl = torch.sum(inlier.to(torch.int32))
    return HomographyResult(
        se3_second_from_first=SE3(R[idx][0], t[idx][0]), H=H,
        n_inliers=n_inl, success=ok & (n_inl >= 4))
