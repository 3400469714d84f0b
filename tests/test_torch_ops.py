"""Ops of the tracking slice: the PyTorch port against the JAX package on
the same seeded numpy inputs.

The JAX references run under ``jax.jit`` (one compile per test is far
cheaper than eager dispatch), except where bit-identity with the eager
reference is the point.

Tolerances and why:
- integer-domain image ops (pyramid, atlas, corner mask, level tables)
  are bit-identical: the port sums the pyramid taps in the JAX order;
- Lie-group, camera and solver math: 1e-6 absolute on unit-scale values,
  or 1e-5 relative: float32 trig and small sums rounding differently;
- SBI images: 1e-4 on values up to ~100 (the blur's sums in another
  order); the ESM rotation to 1e-5 and its score to 1e-4 relative;
- templates: 1e-3 on values up to 255: the port reads the 4 bilinear taps
  directly, the JAX package sums a one-hot matmul;
- ZMSSD scores: 4.0 absolute. Each score is a difference of terms up to
  64 * 255^2 ~ 4e6, where one float32 ulp is 0.5, and the integral-image
  sums run in another order. Best candidates and found flags identical;
  subpixel positions 1e-4 px;
- triangulation: 1e-3 in position at depth ~1.5: the JAX package's
  float32 eigh of AᵀA carries ~2e-4 of noise at the keyframe path's
  baseline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import FrontendConfig
from ptam_cg_tpu.ops import fast as fastops
from ptam_cg_tpu.ops import image as imops
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.ops import patch as patchops
from ptam_cg_tpu.ops import sbi as sbiops
from ptam_cg_tpu.utils import geometry, mest, se3
from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.models import keyframe as tkeyframe
from ptam_cg_tpu_torch.ops import fast as tfast
from ptam_cg_tpu_torch.ops import image as timops
from ptam_cg_tpu_torch.ops import levels as tlevelops
from ptam_cg_tpu_torch.ops import patch as tpatchops
from ptam_cg_tpu_torch.ops import sbi as tsbiops
from ptam_cg_tpu_torch.utils import geometry as tgeometry
from ptam_cg_tpu_torch.utils import mest as tmest
from ptam_cg_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


def rng(seed):
    return np.random.default_rng(seed)


def T(a):
    return fj.tensor(a, "cpu")


def close(got, ref, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **kw)


@pytest.fixture(scope="module")
def texture():
    return tsynth.make_texture(rng(11), device="cpu").numpy()


# ---------------------------------------------------------------- se3


def _twists(seed):
    xi = rng(seed).normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-4                       # Taylor branch
    axis = xi[8:16, 3:] / np.linalg.norm(xi[8:16, 3:], axis=-1, keepdims=True)
    xi[8:16, 3:] = axis * (np.pi - 5e-4)     # near-pi branch of so3_log
    return xi


def test_se3_matches_jax():
    xi = _twists(0)
    pts = rng(1).normal(0, 1, (64, 3)).astype(np.float32)

    def ref(xi, pts):
        a, b = se3.se3_exp(xi), se3.se3_exp(xi[::-1])
        return (se3.hat(xi[:, 3:]), se3.so3_exp(xi[:, 3:]), a,
                se3.so3_log(a.R), se3.se3_log(a), se3.mul(a, b), se3.inv(a),
                se3.apply(a, pts), se3.motion_jacobian(pts))

    hat, so3, aj, so3log, se3log, abj, invj, appj, mj = jax.jit(ref)(
        jnp.asarray(xi), jnp.asarray(pts))
    close(tse3.hat(T(xi[:, 3:])), hat, atol=0)
    close(tse3.so3_exp(T(xi[:, 3:])), so3, atol=1e-6)
    a = tse3.se3_exp(T(xi))
    close(a.R, aj.R, atol=1e-6)
    close(a.t, aj.t, atol=1e-6)
    close(tse3.so3_log(a.R), so3log, atol=2e-5)
    close(tse3.se3_log(a), se3log, atol=2e-5)
    ab = tse3.mul(a, tse3.se3_exp(T(xi[::-1].copy())))
    close(ab.R, abj.R, atol=1e-6)
    close(ab.t, abj.t, atol=1e-6)
    close(tse3.inv(a).t, invj.t, atol=1e-6)
    close(tse3.apply(a, T(pts)), appj, atol=1e-5)
    close(tse3.motion_jacobian(T(pts)), mj, atol=0)


# ---------------------------------------------------------------- mest


@pytest.mark.parametrize("n", [300, 1152])
def test_mest_matches_jax(n):
    r = rng(n)
    err_sq = r.exponential(2.0, n).astype(np.float32)
    mask = r.uniform(size=n) < 0.8
    names = ("tukey", "huber", "cauchy", "lsq")
    kinds = [mest.estimator_id(name) for name in names]
    assert [tmest.estimator_id(name) for name in names] == kinds

    def ref(e, m):
        sig = [mest.find_sigma_squared(e, m, k, approx=a)
               for k in kinds for a in (False, True)]
        return (mest.masked_median(e, m), mest.masked_median_approx(e, m),
                sig, [mest.weight(e, s, k) for s, k in
                      zip(sig, [k for k in kinds for _ in (0, 1)])])

    med, med_approx, sig_ref, w_ref = jax.jit(ref)(jnp.asarray(err_sq),
                                                   jnp.asarray(mask))
    close(tmest.masked_median(T(err_sq), T(mask)), med, atol=0)
    close(tmest.masked_median_approx(T(err_sq), T(mask)), med_approx, atol=0)
    i = 0
    for kind in kinds:
        for approx in (False, True):
            s = tmest.find_sigma_squared(T(err_sq), T(mask), kind,
                                         approx=approx)
            close(s, sig_ref[i], rtol=1e-5)
            close(tmest.weight(T(err_sq), s, kind), w_ref[i], rtol=1e-5,
                  atol=1e-6)
            i += 1


@pytest.mark.parametrize("n", [3, 4, 6])
def test_spd_solve_matches_jax(n):
    r = rng(n)
    a = r.normal(size=(5, n, n)).astype(np.float32)
    A = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = r.normal(size=(5, n)).astype(np.float32)
    close(tgeometry.spd_solve(T(A), T(b)),
          geometry.spd_solve(jnp.asarray(A), jnp.asarray(b)), rtol=1e-5,
          atol=1e-6)


def test_sym4_eigh_solves_degenerate_matrices():
    """The Jacobi eigen-solve behind ``triangulate`` on random symmetric
    4x4 matrices and on rank-deficient ones (a zero column, two equal
    rows: the no-baseline DLT): eigenvalues within 1e-6 of the largest,
    and V^T M V diagonal to the same level."""
    A = rng(12).normal(size=(500, 4, 4)).astype(np.float32)
    A[:20, :, 3] = 0.0
    A[20:40, 2] = A[20:40, 0]
    M = np.einsum("nmi,nmj->nij", A, A)
    vals, V = tgeometry.sym_eigh(T(M))
    ref = np.linalg.eigvalsh(M.astype(np.float64))
    scale = np.abs(ref).max(-1, keepdims=True)
    assert np.abs(np.sort(vals.numpy(), -1) - ref).max() <= 1e-6 * scale.max()
    D = (V.transpose(-1, -2) @ T(M) @ V).numpy()
    off = np.abs(D - D * np.eye(4)).max((-1, -2))
    assert (off <= 1e-6 * scale[:, 0]).all()
    np.testing.assert_allclose(
        (V.transpose(-1, -2) @ V).numpy(), np.broadcast_to(np.eye(4), M.shape),
        atol=1e-6)


def test_triangulate_matches_jax():
    """Seeded points 1.2-1.8 deep seen from two views 0.1 apart, the
    baseline of the keyframe path. Against a float64 solve of the same
    system the JAX package's float32 eigh of AᵀA errs by up to ~2e-4 in
    position and the port's float32 Jacobi solve by ~3e-5, so the bars
    are 1e-3 against JAX and 1e-4 against float64. Rays to a point at
    infinity take the |w| clamp and stay finite."""
    r = rng(9)
    N = 256
    pts = np.stack([r.uniform(-0.6, 0.6, N), r.uniform(-0.5, 0.5, N),
                    r.uniform(1.2, 1.8, N)], -1)
    pts[-4:] = pts[-4:] * 1e9                     # at infinity
    xi = jnp.array([0.1, 0.01, 0.003, 0.01, -0.05, 0.005], jnp.float32)
    a_from_b = jax.jit(se3.se3_exp)(xi)
    R = np.asarray(a_from_b.R, np.float64)
    t = np.asarray(a_from_b.t, np.float64)
    pa = pts @ R.T + t
    v2a = (pa[:, :2] / pa[:, 2:]).astype(np.float32)
    v2b = (pts[:, :2] / pts[:, 2:]).astype(np.float32)
    got = tgeometry.triangulate(
        fj.se3_from_numpy(fj.as_numpy_tree(a_from_b), "cpu"), T(v2a),
        T(v2b)).numpy()
    ref = jax.jit(geometry.triangulate)(a_from_b, jnp.asarray(v2a),
                                        jnp.asarray(v2b))
    assert np.isfinite(got).all()
    close(T(got[:-4]), np.asarray(ref)[:-4], atol=1e-3)
    # The float64 DLT solve of the same float32 system.
    PD = np.concatenate([R, t[:, None]], 1)
    A = np.zeros((N, 4, 4))
    A[:, 0, 0] = A[:, 1, 1] = -1.0
    A[:, 0, 2], A[:, 1, 2] = v2b[:, 0], v2b[:, 1]
    A[:, 2] = v2a[:, :1] * PD[2] - PD[0]
    A[:, 3] = v2a[:, 1:] * PD[2] - PD[1]
    v4 = np.linalg.eigh(np.einsum("nmi,nmj->nij", A, A))[1][..., 0]
    close(T(got[:-4]), (v4[:, :3] / v4[:, 3:])[:-4], atol=1e-4)


# ---------------------------------------------------------------- camera


@pytest.mark.parametrize("params,size", [
    (REF_PARAMS, (640, 480)), (REF_PARAMS, (40, 30)),
    ((0.9, 1.2, 0.5, 0.5, 0.0), (320, 240))])
def test_atan_matches_jax(params, size):
    xy = rng(2).uniform(-0.9, 0.9, (200, 2)).astype(np.float32)
    xy[:5] *= 1e-3                           # small-radius branches
    pix = rng(3).uniform(0, size[0], (200, 2)).astype(np.float32)

    def ref(p, xy, pix):
        cam = atan.make_camera(p, size)
        return (cam, atan.project(xy, cam), atan.unproject(pix, cam),
                atan.project_derivs(xy, cam), atan.project_valid(xy * 3, cam))

    cam, proj, unproj, derivs, valid = jax.jit(ref)(
        jnp.asarray(params, jnp.float32), jnp.asarray(xy), jnp.asarray(pix))
    tcam = tatan.make_camera(params, size, "cpu")
    ref = fj.as_numpy_tree(cam)
    for f in ("focal", "center", "inv_focal", "w", "two_tan", "winv",
              "one_over_2tan", "distortion_enabled", "largest_radius",
              "max_r", "one_pixel_dist"):
        close(getattr(tcam, f), ref[f], rtol=1e-6, err_msg=f)
    close(tatan.project(T(xy), tcam), proj, rtol=1e-5, atol=1e-3)
    close(tatan.unproject(T(pix), tcam), unproj, rtol=1e-5, atol=1e-6)
    close(tatan.project_derivs(T(xy), tcam), derivs, rtol=1e-5, atol=1e-3)
    close(tatan.project_valid(T(xy * 3), tcam), valid, atol=0)


# ---------------------------------------------------------------- levels


def test_levels_match_jax():
    p = rng(4).uniform(0, 300, (50, 2)).astype(np.float32)
    lev = rng(5).integers(0, 4, 50).astype(np.int32)
    H, W = 240, 320
    for fn, tfn in ((levelops.level_zero_pos, tlevelops.level_zero_pos),
                    (levelops.level_n_pos, tlevelops.level_n_pos)):
        close(tfn(T(p), T(lev).long()), fn(jnp.asarray(p), jnp.asarray(lev)),
              atol=0)
    close(tlevelops.atlas_pos(T(p), T(lev).long(), H, W),
          levelops.atlas_pos(jnp.asarray(p), jnp.asarray(lev), H, W), atol=0)
    for got, ref in zip(tlevelops.level_bounds(T(lev).long(), H, W),
                        levelops.level_bounds(jnp.asarray(lev), H, W)):
        close(got, ref, atol=0)
    close(tlevelops.level_scale(T(lev).long()),
          levelops.level_scale(jnp.asarray(lev)), atol=0)


def test_pyramid_atlas_and_corner_mask_bit_identical(texture):
    """A non-integer image, so the order of the 2x2 sums matters; against
    the eager reference (under jit XLA regroups the level-2/3 sums)."""
    im = texture[:120, :160] + rng(6).uniform(0, 1, (120, 160)).astype(
        np.float32)
    pyr_ref = imops.build_pyramid(jnp.asarray(im), 4)
    pyr, atlas, cmask, scores, counts = tkeyframe.make_frame_lite(T(im))
    for got, ref in zip(pyr, pyr_ref):
        close(got, ref, atol=0, rtol=0)
    close(atlas, levelops.pack_atlas(pyr_ref), atol=0, rtol=0)
    # FAST is min/max only, so its jitted reference is exact too.
    fast_ref = jax.jit(lambda *p: [
        fastops.fast_score_map(lev, float(t))
        for lev, t in zip(p, FrontendConfig().fast_thresholds)])(*pyr_ref)
    close(cmask, levelops.pack_atlas(tuple(
        m.astype(jnp.float32) for m, _ in fast_ref)) > 0.5, atol=0)
    close(counts, [int(m.sum()) for m, _ in fast_ref], atol=0)
    for got, (_, ref) in zip(scores, fast_ref):
        close(got, ref, atol=0, rtol=0)


# ---------------------------------------------------------------- SBI


def test_sbi_matches_jax(texture):
    lev3 = texture[100:160, 200:280].copy()
    moved = texture[101:161, 198:278].copy()

    def ref(lev3, moved, params):
        target = sbiops.make_sbi(lev3, 0.75)
        moving = sbiops.make_sbi(moved, 0.75)
        return (target, sbiops.make_sbi(lev3, 2.5), moving,
                sbiops.calc_sbi_rotation(moving, target, params, (30, 40), 10))

    target, blurred, moving, (rot_ref, score_ref) = jax.jit(ref)(
        jnp.asarray(lev3), jnp.asarray(moved),
        jnp.asarray(REF_PARAMS, jnp.float32))
    for blur, s_ref in ((0.75, target), (2.5, blurred)):
        s = tsbiops.make_sbi(T(lev3), blur)
        close(s.template, s_ref.template, atol=1e-4)
        close(s.jac, s_ref.jac, atol=1e-4)
    rot, score = tsbiops.calc_sbi_rotation(
        fj.sbi_from_numpy(fj.as_numpy_tree(moving), "cpu"),
        fj.sbi_from_numpy(fj.as_numpy_tree(target), "cpu"),
        torch.tensor(REF_PARAMS), (30, 40), 10)
    assert np.abs(np.asarray(rot_ref.R) - np.eye(3)).max() > 1e-3
    close(rot.R, rot_ref.R, atol=1e-5)
    close(score, score_ref, rtol=1e-4)


# ---------------------------------------------------------------- patch


def test_search_level_and_warp_matches_jax():
    r = rng(7)
    N = 256
    p_cam = np.concatenate([r.uniform(-0.5, 0.5, (N, 2)),
                            r.uniform(0.5, 3.0, (N, 1))], -1).astype(np.float32)
    R = tse3.so3_exp(T(r.normal(0, 0.2, 3).astype(np.float32))).numpy()
    right = r.normal(0, 2e-3, (N, 3)).astype(np.float32)
    down = r.normal(0, 2e-3, (N, 3)).astype(np.float32)
    cd = tatan.project_derivs(T(p_cam[:, :2] / p_cam[:, 2:]),
                              tatan.make_camera(REF_PARAMS, (640, 480), "cpu"))
    cd = cd.numpy()
    w = tpatchops.search_level_and_warp(T(p_cam), T(R), T(right), T(down),
                                        T(cd))
    w_ref = jax.jit(patchops.search_level_and_warp)(
        jnp.asarray(p_cam), jnp.asarray(R), jnp.asarray(right),
        jnp.asarray(down), jnp.asarray(cd))
    close(w.warp_inv, w_ref.warp_inv, rtol=1e-5, atol=1e-6)
    close(w.level, w_ref.level, atol=0)
    close(w.good, w_ref.good, atol=0)
    assert len(set(w.level.tolist())) > 1 and w.good.any()


def test_make_warped_templates_matches_jax(texture):
    r = rng(8)
    N = 200
    atlases = np.stack([texture[:180, :160], texture[200:380, 100:260]])
    kf = r.integers(0, 2, N).astype(np.int32)
    center = r.uniform(4, 156, (N, 2)).astype(np.float32)
    center[:, 1] = r.uniform(4, 116, N)
    scale = r.uniform(0.6, 1.6, (N, 1, 1))
    scale[:20] = 3.5          # samples leave the 28-px window: in_win gate
    m2 = (scale * np.eye(2) + r.normal(0, 0.15, (N, 2, 2))).astype(
        np.float32)
    bounds = np.tile(np.array([[0.0, 0.0, 160.0, 120.0]], np.float32), (N, 1))
    tm, good = tpatchops.make_warped_templates(T(atlases), T(kf), T(center),
                                               T(m2), T(bounds))
    tm_ref, good_ref = jax.jit(patchops.make_warped_templates)(
        jnp.asarray(atlases), jnp.asarray(kf), jnp.asarray(center),
        jnp.asarray(m2), jnp.asarray(bounds))
    close(good, good_ref, atol=0)
    assert 0 < int(good.sum()) < N
    close(tm, tm_ref, atol=1e-3)


def _search_inputs(texture, r_win, seed):
    """A 120x160 level with its FAST mask, templates cut at known integer
    positions plus a sub-pixel shift, and predictions 0-3 px off."""
    r = rng(seed)
    im = texture[40:160, 60:220].copy()
    mask, _ = tfast.fast_score_map_plain(T(im), 10.0)
    N = 96
    true = np.stack([r.integers(20, 140, N), r.integers(20, 100, N)],
                    -1).astype(np.float32)
    shift = r.uniform(-0.4, 0.4, (N, 2)).astype(np.float32)
    ys, xs = np.mgrid[0:8, 0:8]
    tm = np.empty((N, 8, 8), np.float32)
    for n in range(N):   # bilinear cut at true + shift (patch centre 4,4)
        x = true[n, 0] + shift[n, 0] + xs - 4
        y = true[n, 1] + shift[n, 1] + ys - 4
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        fx, fy = x - x0, y - y0
        tm[n] = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx
                 * (1 - fy) + im[y0 + 1, x0] * (1 - fx) * fy
                 + im[y0 + 1, x0 + 1] * fx * fy)
    centers = true + r.uniform(-3, 3, (N, 2)).astype(np.float32)
    radius = np.full(N, 5.0, np.float32)
    # No candidate in range: every score is masked, and both frameworks'
    # argmin must return the first index.
    radius[-8:] = 0.0
    centers[-8:] += 0.5
    bounds = np.tile(np.array([[0.0, 0.0, 160.0, 120.0]], np.float32), (N, 1))
    return im, mask.numpy(), tm, centers, radius, bounds


@pytest.mark.parametrize("r_win", [11, 16])
def test_ssd_search_and_subpix_match_jax(texture, r_win):
    im, mask, tm, centers, radius, bounds = _search_inputs(texture, r_win,
                                                           r_win)
    res, win, origin = tpatchops.ssd_search(
        T(im), T(mask), T(tm), T(centers), T(radius), T(bounds),
        r_win=r_win, max_ssd=32000.0)

    def ref(im, mask, tm, centers, radius, bounds):
        res, win, origin = patchops.ssd_search(
            im, mask, tm, centers, radius, bounds, r_win=r_win,
            max_ssd=32000.0, return_windows=True)
        return res, win, origin, patchops.subpix_refine(
            im, tm, res.pos, bounds, max_its=8, windows=win,
            win_origin=origin)

    res_ref, win_ref, origin_ref, sp_ref = jax.jit(ref)(
        jnp.asarray(im), jnp.asarray(mask), jnp.asarray(tm),
        jnp.asarray(centers), jnp.asarray(radius), jnp.asarray(bounds))
    close(win, win_ref, atol=0)
    close(origin, origin_ref, atol=0)
    close(res.found, res_ref.found, atol=0)
    close(res.pos, res_ref.pos, atol=0)
    close(res.ssd, res_ref.ssd, rtol=0, atol=4.0)
    assert int(res.found.sum()) > 20

    sp = tpatchops.subpix_refine(T(im), T(tm), res.pos, T(bounds), max_its=8,
                                 windows=win, win_origin=origin)
    close(sp.converged, sp_ref.converged, atol=0)
    close(sp.pos, sp_ref.pos, atol=1e-4)
    assert int(sp.converged.sum()) > 20


def test_subpix_refine_atlas_path_matches_jax(texture):
    """Without windows, ``subpix_refine`` gathers a 15x15 window (K2)
    around each rounded start, as epipolar growth calls it; starts at
    integer positions up to 1 px off the truth, and two near the edges
    where the window is clamped."""
    im, _, tm, _, _, bounds = _search_inputs(texture, 11, 21)
    r = rng(22)
    N = tm.shape[0]
    true = np.stack([r.integers(20, 140, N), r.integers(20, 100, N)], -1)
    shift = r.uniform(-0.4, 0.4, (N, 2)).astype(np.float32)
    ys, xs = np.mgrid[0:8, 0:8]
    for n in range(N):
        x = true[n, 0] + shift[n, 0] + xs - 4
        y = true[n, 1] + shift[n, 1] + ys - 4
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        fx, fy = x - x0, y - y0
        tm[n] = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx
                 * (1 - fy) + im[y0 + 1, x0] * (1 - fx) * fy
                 + im[y0 + 1, x0 + 1] * fx * fy)
    pos0 = (true + r.integers(-1, 2, (N, 2))).astype(np.float32)
    pos0[:2] = [[2.0, 3.0], [158.0, 118.0]]
    sp = tpatchops.subpix_refine(T(im), T(tm), T(pos0), T(bounds), max_its=10)
    sp_ref = jax.jit(lambda *a: patchops.subpix_refine(*a, max_its=10))(
        jnp.asarray(im), jnp.asarray(tm), jnp.asarray(pos0),
        jnp.asarray(bounds))
    close(sp.converged, sp_ref.converged, atol=0)
    close(sp.pos, sp_ref.pos, atol=1e-4)
    assert int(sp.converged.sum()) > N // 2
    assert not bool(sp.converged[:2].any())
