"""Keyframe integration and the bundle-adjustment path of the mapping
side: the PyTorch port against the JAX package.

Keyframe integration:

A JAX scene built as ``bench_mapping.build_scene`` builds it (320x240, a
512-point map with 4 keyframe slots, frame 0 as keyframe 0 with a root
measurement of every point), but with at most ``PER_LEVEL`` Shi-Tomasi
candidates a level, so the map has room to grow. It goes through
``ptam_cg_tpu_torch.io.from_jax``; both packages then integrate frame 2
(a baseline of 0.08 to keyframe 0) as a keyframe with the same full
build and the same tracker-style measurements (reprojections of a seeded
60% of the points). The JAX
program runs jitted under ``jax.default_matmul_precision("float32")``, as
``MapMaker`` runs it. Bars:

- the same re-found set and the same new points per level (matched by
  candidate position). A difference is allowed only where the port's
  diagnostics trace it to float noise (``utils/parity.py``); each is
  listed in the failure message, and there may be at most 1% of them;
- new point positions within 1e-3 (scene depth 1.5), and every
  measurement position within 1e-3 level-0 px: the ZMSSD cross term, the
  subpixel solve and the triangulation's eigen-solve round differently.
  The JAX package's float32 eigh of AᵀA is the largest term: against a
  float64 solve of the same system it errs by up to 2e-4 at this
  baseline, and by up to 1e-3 at half of it (frame 1), which is why
  frame 2 is used. (The port's Jacobi solve errs ~7x less.)

Bundle adjustment (the tests after ``test_candidate_map_scene_is_consistent``):
maps built with numpy, the same in both packages. Extraction, selection,
local-BA masks, write-back and GC are held equal exactly; ``MapMaker``'s
global and local BA (deterministic mode, ``synth.ba_map``'s geometry at
10 keyframes and 256 points) give the same point-valid set, measurement,
retry and never-retry masks and converged flags, poses within 1e-4 and
points within 1e-3 (the ``compute`` bars of tests/test_torch_bundle.py).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import MapMakerConfig
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import keyframe, map_state, mapmaker
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.models import bundle as tbundle
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
from ptam_cg_tpu_torch.utils import parity

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
P, K = 512, 4
PER_LEVEL = 96
WIGGLE, THIN = 0.1, 10.0
POS_TOL = 1e-3

CMP_FIELDS = ("point_valid", "point_src_level", "point_center", "point_pos",
              "meas_valid", "meas_pos", "meas_source")


def _jax_map(seq, ff0, max_kfs=K):
    """bench_mapping.build_scene's map, at most PER_LEVEL candidates a
    level."""
    cam, pose0 = seq.cam, seq.pose(0)
    T_wc = se3lib.inv(pose0)
    m = map_state.empty_map(SIZE, max_points=P, max_kfs=max_kfs)
    m = map_state.insert_keyframe(m, 0, ff0, pose0, 1.5, 0.1)
    cand_xy, cand_valid = np.asarray(ff0.cand_xy), np.asarray(ff0.cand_valid)
    pts, centers, lvls = [], [], []
    for lev in range(4):
        for (x, y) in cand_xy[lev][cand_valid[lev]][:PER_LEVEL]:
            p0 = (np.array([x, y], np.float64) + 0.5) * (1 << lev) - 0.5
            z1 = np.asarray(atan.unproject(jnp.asarray(p0, jnp.float32), cam))
            ray = np.asarray(T_wc.R) @ np.array([z1[0], z1[1], 1.0])
            origin = np.asarray(T_wc.t)
            s = -origin[2] / ray[2]
            if s > 0:
                pts.append(origin + s * ray)
                centers.append([x, y])
                lvls.append(lev)
    n = len(pts)
    pos = np.zeros((P, 3), np.float32)
    pos[:n] = np.stack(pts)
    ctr = np.zeros((P, 2), np.float32)
    ctr[:n] = np.stack(centers)
    lv = np.zeros(P, np.int32)
    lv[:n] = np.array(lvls)
    c_nc, r_nc, d_nc, nrm = map_state.make_point_rays(
        jnp.asarray(ctr), jnp.asarray(lv), pose0, cam, SIZE)
    m = m._replace(
        point_pos=jnp.asarray(pos), point_valid=jnp.asarray(np.arange(P) < n),
        point_src_level=jnp.asarray(lv), point_center=jnp.asarray(ctr),
        point_center_nc=c_nc, point_right_nc=r_nc, point_down_nc=d_nc,
        point_normal_nc=nrm, good=jnp.asarray(True))
    m = map_state.refresh_pixel_vectors(m)
    lvl0 = (ctr + 0.5) * (1 << lv)[:, None].astype(np.float32) - 0.5
    return map_state.set_measurements(
        m, 0, jnp.arange(P), jnp.asarray(lvl0), jnp.asarray(lv),
        jnp.ones(P, bool), jnp.full(P, map_state.SRC_ROOT, jnp.int32),
        m.point_valid)


@pytest.fixture(scope="module")
def scene():
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=4,
                                  seed=7, height=1.5, radius=0.2, sweep=0.6)
    build_full = jax.jit(lambda x: keyframe.build_frame(
        x, candidate_min_score=50.0))
    m = _jax_map(seq, build_full(seq.frame(0)))
    ff2, pose2 = build_full(seq.frame(2)), seq.pose(2)
    p_cam = m.point_pos @ pose2.R.T + pose2.t
    pix = atan.project(p_cam[:, :2] / p_cam[:, 2:3], seq.cam)
    pick = np.random.default_rng(0).uniform(size=P) < 0.6
    meas = dict(point=jnp.arange(P), pos=pix, level=m.point_src_level,
                subpix=m.point_valid,
                valid=m.point_valid & (p_cam[:, 2] > 0.1) & pick)
    return dict(seq=seq, m=m, ff2=ff2, pose2=pose2, meas=meas)


def _jax_integrate(scene):
    cam = scene["seq"].cam

    def run(m_, f_, pose, mpt, mpos, mlvl, msub, mval, npm):
        with jax.default_matmul_precision("float32"):
            return mapmaker.integrate_keyframe_program(
                m_, f_, pose, mpt, mpos, mlvl, msub, mval, jnp.float32(1.5),
                jnp.float32(0.1), npm, cam, SIZE, WIGGLE, THIN)

    mt = scene["meas"]
    return jax.jit(run)(scene["m"], scene["ff2"], scene["pose2"], mt["point"],
                        mt["pos"], mt["level"], mt["subpix"], mt["valid"],
                        jnp.zeros(P, bool))


def _port_integrate(scene, diag):
    mt = {k: fj.tensor(v, "cpu") for k, v in scene["meas"].items()}
    return tmapmaker.integrate_keyframe_program(
        fj.map_state_from_numpy(fj.as_numpy_tree(scene["m"]), "cpu"),
        fj.frame_features_from_numpy(fj.as_numpy_tree(scene["ff2"]), "cpu"),
        fj.se3_from_numpy(fj.as_numpy_tree(scene["pose2"]), "cpu"),
        mt["point"],
        mt["pos"], mt["level"], mt["subpix"], mt["valid"], torch.tensor(1.5),
        torch.tensor(0.1), torch.zeros(P, dtype=torch.bool),
        fj.camera_from_numpy(fj.as_numpy_tree(scene["seq"].cam), "cpu"), SIZE,
        WIGGLE, THIN, diag=diag)


def test_integrate_keyframe_program_matches_jax(scene):
    jm, jmask, jslot_n = _jax_integrate(scene)
    diag = {}
    tm, tmask, tslot_n = _port_integrate(scene, diag)
    slot = int(jslot_n[0])
    assert slot == int(tslot_n[0]) == 1
    ref = fj.as_numpy_tree(jm)
    diffs, counts = parity.integration_differences(
        {f: ref[f] for f in CMP_FIELDS},
        {f: getattr(tm, f) for f in CMP_FIELDS},
        np.asarray(scene["m"].point_valid), slot, diag, THIN, POS_TOL)
    n_added = sum(counts["added"].values())
    assert counts["refound"] > 20 and n_added > 20, counts
    assert all(d["reason"] for d in diffs), diffs
    assert len(diffs) <= 0.01 * (counts["refound"] + n_added), diffs
    # The inserted keyframe, bit for bit.
    for f in ("kf_R", "kf_t", "kf_valid", "kf_atlas", "kf_corner_mask",
              "kf_max_xy", "kf_max_valid", "kf_cand_xy", "kf_cand_score",
              "kf_cand_valid", "kf_sbi", "kf_sbi_jac", "kf_depth_mean",
              "kf_depth_sigma"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), ref[f],
                                      err_msg=f)
    if not diffs:
        assert int(tslot_n[1]) == int(jslot_n[1]) == n_added
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        for f in ("point_valid", "point_src_kf", "point_src_level",
                  "point_center", "point_source", "meas_valid",
                  "meas_level", "meas_subpix", "meas_source", "never_retry"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), ref[f],
                                          err_msg=f)
        for f in ("point_center_nc", "point_right_nc", "point_down_nc",
                  "point_normal_nc"):
            np.testing.assert_allclose(getattr(tm, f).numpy(), ref[f],
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        # One-pixel world vectors (~4e-3) scale with the point's depth,
        # which carries the triangulation's noise (~2e-4 of 1.5).
        for f in ("point_right_w", "point_down_w"):
            np.testing.assert_allclose(getattr(tm, f).numpy(), ref[f],
                                       atol=1e-5, err_msg=f)


def test_keyframe_helpers_match_jax(scene):
    """closest_kf, need_new_kf, scene_depth_for_kf and kf_linear_dist on
    the scene's map with frame 2 inserted as keyframe 1; insert_keyframe
    and set_measurements bit for bit."""
    m, ff2, pose2 = scene["m"], scene["ff2"], scene["pose2"]
    mt = scene["meas"]
    jm = map_state.insert_keyframe(m, 1, ff2, pose2, 1.4, 0.2)
    jm = map_state.set_measurements(
        jm, 1, mt["point"], mt["pos"], mt["level"], mt["subpix"],
        jnp.full(P, map_state.SRC_TRACKER, jnp.int32), mt["valid"])
    tm = fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu")
    tpose = fj.se3_from_numpy(fj.as_numpy_tree(pose2), "cpu")
    tm = tms.insert_keyframe(
        tm, 1, fj.frame_features_from_numpy(fj.as_numpy_tree(ff2), "cpu"),
        tpose,
        1.4, 0.2)
    tmt = {k: fj.tensor(v, "cpu") for k, v in mt.items()}
    tm = tms.set_measurements(
        tm, 1, tmt["point"], tmt["pos"], tmt["level"], tmt["subpix"],
        torch.full((P,), tms.SRC_TRACKER, dtype=torch.int32), tmt["valid"])
    ref = fj.as_numpy_tree(jm)
    for f in ref:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), ref[f],
                                      err_msg=f)

    assert int(tmapmaker.closest_kf(tm, 1)) == int(mapmaker.closest_kf(jm, 1))
    assert int(tmapmaker.closest_kf(tm, 0)) == 1
    for k in (0, 1):
        (mean, sigma) = tms.scene_depth_for_kf(tm, k)
        (mean_ref, sigma_ref) = map_state.scene_depth_for_kf(jm, k)
        np.testing.assert_allclose(float(mean), float(mean_ref), rtol=1e-5)
        # sigma = sqrt(E[z^2] - mean^2): the difference of two ~2.25 sums
        # keeps ~1e-6 of the variance, 3e-5 of a sigma of ~0.02.
        np.testing.assert_allclose(float(sigma), float(sigma_ref), atol=5e-5)
    pose = se3lib.mul(se3lib.se3_exp(jnp.array([0.03, 0, 0, 0, 0.01, 0])),
                      pose2)
    tpose = fj.se3_from_numpy(fj.as_numpy_tree(pose), "cpu")
    np.testing.assert_allclose(
        float(tms.kf_linear_dist(tm, tpose, 1.5, 0)),
        float(map_state.kf_linear_dist(jm, pose, 1.5, 0)), rtol=1e-5)
    for mult in (0.01, 0.05, 1.0):
        assert bool(tmapmaker.need_new_kf(tm, tpose, 1.5, 1.0, mult)) == bool(
            mapmaker.need_new_kf(jm, pose, 1.5, 1.0, mult)), mult


def test_candidate_map_scene_is_consistent():
    """The port's own scene (``chip_smoke.py`` phase 6) at 320x240
    with room for every candidate: all of frame 0's candidates, level by
    level, every point on the z=0 plane, and a root measurement in
    keyframe 0 that the point reprojects onto (a float32 round trip
    through the ATAN camera, 0.05 px: 0.015 at the image corners)."""
    seq = tsynth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=2,
                                   seed=7, height=1.5, radius=0.2, sweep=0.6,
                                   device="cpu")
    m, ff0 = tsynth.candidate_map_scene(seq, max_points=2048, max_kfs=K)
    ok = m.point_valid
    per_level = torch.bincount(m.point_src_level[ok].long(), minlength=4)
    assert torch.equal(per_level, ff0.cand_valid.sum(-1)), per_level
    assert bool(ok[:int(ok.sum())].all()) and int(ok.sum()) < 2048
    assert float(m.point_pos[ok, 2].abs().max()) < 1e-4
    p_cam = m.point_pos @ m.kf_R[0].T + m.kf_t[0]
    pix = tatan.project(p_cam[:, :2] / p_cam[:, 2:3], seq.cam)
    assert torch.equal(m.meas_valid[0], ok)
    assert bool((m.meas_source[0][ok] == tms.SRC_ROOT).all())
    assert float((m.meas_pos[0][ok] - pix[ok]).abs().max()) < 0.05
    for f in ("cand_xy", "cand_valid", "max_xy", "max_valid"):
        assert torch.equal(getattr(m, "kf_" + f)[0], getattr(ff0, f)), f


# ---------------------------------------------------------------------------
# Bundle adjustment: extraction, write-back, GC and the MapMaker
# ---------------------------------------------------------------------------

BA_SIZE = (64, 64)


def _ba_maps(P=128, K=4, **fields):
    """(JAX map, port map): an empty map with ``fields`` (numpy) set."""
    tm = tms.empty_map(BA_SIZE, max_points=P, max_kfs=K, device="cpu")
    for name, value in fields.items():
        setattr(tm, name, torch.from_numpy(np.asarray(value)).to(
            getattr(tm, name).dtype))
    return _to_jax(tm), tm


def _to_jax(tm):
    return map_state.MapState(**{f.name: jnp.asarray(getattr(tm, f.name))
                                 for f in dataclasses.fields(tm)})


def _assert_maps_equal(jm, tm, fields=None):
    ref = fj.as_numpy_tree(jm)
    for f in fields or ref:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), ref[f],
                                      err_msg=f)


def _assert_problems_equal(jprob, tprob):
    ref = fj.as_numpy_tree(jprob)
    for f in ref:
        np.testing.assert_array_equal(getattr(tprob, f).numpy(), ref[f],
                                      err_msg=f)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _two_kf_map(P=128, n=50):
    rng = np.random.default_rng(3)
    kf_valid = np.zeros(4, bool)
    kf_valid[:2] = True
    meas = np.zeros((4, P), bool)
    meas[:2, :n] = True
    return _ba_maps(P, point_pos=rng.normal(size=(P, 3)).astype(np.float32),
                    point_valid=np.arange(P) < n, kf_valid=kf_valid,
                    meas_valid=meas,
                    meas_pos=rng.uniform(0, 64, (4, P, 2)).astype(np.float32),
                    meas_level=rng.integers(0, 4, (4, P)).astype(np.int32))


def test_extract_apply_bundle_roundtrip_matches_jax():
    """extract_bundle -> apply_bundle with no change is a no-op; the
    extracted problem is JAX's, entry for entry."""
    jm, tm = _two_kf_map()
    adjust, fixed = np.array([False, True, False, False]), np.array(
        [True, False, False, False])
    jprob, jk, jp, jn = mapmaker.extract_bundle(
        jm, jnp.asarray(adjust), jnp.asarray(fixed), jm.point_valid, 256)
    ta, tf = _t(adjust, fixed)
    tprob, tk, tp, tn = tmapmaker.extract_bundle(tm, ta, tf, tm.point_valid,
                                                 256)
    assert int(tn) == int(jn) == 100 and int(tprob.meas_valid.sum()) == 100
    _assert_problems_equal(jprob, tprob)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    out, retry = tmapmaker.apply_bundle(tm, tprob, tk, tp, ta, tm.point_valid)
    assert torch.equal(out.point_pos, tm.point_pos)
    assert torch.equal(out.kf_t, tm.kf_t)
    assert not bool(retry.any())


def test_apply_bundle_outlier_provenance_matches_jax():
    """A tracker outlier is retried; a re-find outlier is never retried; a
    ROOT outlier, or an outlier of a point with at most 2 measurements,
    trashes the point."""
    P = 128
    meas = np.zeros((4, P), bool)
    meas[:3, :3] = True
    meas[:2, 3] = True                       # point 3: 2 measurements
    src = np.full((4, P), tms.SRC_REFIND, np.int32)
    src[1, 0] = tms.SRC_TRACKER
    src[0, 2] = tms.SRC_ROOT
    jm, tm = _ba_maps(P, point_valid=np.arange(P) < 4,
                      kf_valid=np.arange(4) < 3, meas_valid=meas,
                      meas_source=src)
    adjust = np.array([True, True, True, False])
    jprob, jk, jp, _ = mapmaker.extract_bundle(
        jm, jnp.asarray(adjust), jnp.zeros(4, bool), jm.point_valid, 64)
    bad = np.zeros(64, bool)
    for i, (k, p) in enumerate(zip(np.asarray(jk), np.asarray(jp))):
        bad[i] = i < 11 and (k, p) in [(1, 0), (2, 1), (0, 2), (1, 3)]
    assert bad.sum() == 4
    jprob = jprob._replace(meas_bad=jnp.asarray(bad))
    jout, jretry = mapmaker.apply_bundle(jm, jprob, jk, jp,
                                         jnp.asarray(adjust), jm.point_valid)
    ta, = _t(adjust)
    tprob, tk, tp, _ = tmapmaker.extract_bundle(
        tm, ta, torch.zeros(4, dtype=torch.bool), tm.point_valid, 64)
    tprob.meas_bad = torch.from_numpy(bad)
    tout, tretry = tmapmaker.apply_bundle(tm, tprob, tk, tp, ta,
                                          tm.point_valid)
    np.testing.assert_array_equal(tretry.numpy(), np.asarray(jretry))
    _assert_maps_equal(jout, tout, ("meas_valid", "point_valid",
                                    "never_retry"))
    assert bool(tretry[1, 0]) and not bool(tout.meas_valid[1, 0])
    assert bool(tout.never_retry[2, 1]) and not bool(tretry[2, 1])
    assert tout.point_valid[:4].tolist() == [True, True, False, False]


def test_extract_compact_matches_dense_and_jax():
    P = 128
    rng = np.random.default_rng(3)
    meas = np.zeros((4, P), bool)
    meas[[1, 3], ::3] = True
    jm, tm = _ba_maps(P, point_pos=rng.normal(size=(P, 3)).astype(np.float32),
                      point_valid=(np.arange(P) % 3) == 0,
                      kf_valid=np.array([False, True, False, True]),
                      meas_valid=meas,
                      meas_pos=rng.uniform(0, 64, (4, P, 2)).astype(
                          np.float32))
    adjust, fixed = np.array([False, True, False, True]), np.zeros(4, bool)
    ta, tf = _t(adjust, fixed)
    want = mapmaker.extract_bundle_compact(jm, jnp.asarray(adjust),
                                           jnp.asarray(fixed),
                                           jm.point_valid, 2, 64, 256)
    got = tmapmaker.extract_bundle_compact(tm, ta, tf, tm.point_valid, 2,
                                           64, 256)
    _assert_problems_equal(want[0], got[0])
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cprob, mk, mp, cam_idx, pt_idx, counts = got
    n_c, n_p, n_sel = counts.tolist()
    dprob, dk, dp, n_dense = tmapmaker.extract_bundle(tm, ta, tf,
                                                      tm.point_valid, 256)
    assert n_c == 2 and n_sel == int(n_dense) and cam_idx.tolist() == [1, 3]
    assert torch.equal(mk[:n_sel], dk[:n_sel])
    assert torch.equal(mp[:n_sel], dp[:n_sel])
    assert torch.equal(cprob.meas_pos, dprob.meas_pos)
    live = pt_idx[pt_idx < P].long()
    assert len(live) == n_p
    # Moved compact results land in their global slots only.
    moved = dataclasses.replace(cprob, cam_t=cprob.cam_t + 1.0,
                                pt_pos=cprob.pt_pos + torch.tensor(
                                    [0.0, 0.0, 5.0]))
    out, retry = tmapmaker.apply_bundle(tm, moved, mk, mp, ta,
                                        tm.point_valid, cam_idx, pt_idx)
    assert torch.equal(out.kf_t[[1, 3]], tm.kf_t[[1, 3]] + 1.0)
    assert torch.equal(out.kf_t[[0, 2]], tm.kf_t[[0, 2]])
    want_pts = tm.point_pos.clone()
    want_pts[live, 2] += 5.0
    assert torch.equal(out.point_pos, want_pts)
    assert not bool(retry.any())


def test_extract_overflow_prioritizes_as_jax():
    """Past the cap: every ROOT measurement, both measurements of scarcely
    measured points, then the newest keyframe; the same 128 in the same
    order as JAX's ``top_k`` (ties to the lower flat index)."""
    K, P = 4, 64
    meas = np.zeros((K, P), bool)
    meas[:, :60] = True
    meas[2:, 60:64] = True
    src = np.full((K, P), tms.SRC_TRACKER, np.int32)
    src[0, :60] = tms.SRC_ROOT
    src[2, 60:64] = tms.SRC_ROOT
    jm, tm = _ba_maps(P, K, kf_valid=np.ones(K, bool),
                      point_valid=np.ones(P, bool), meas_valid=meas,
                      meas_source=src)
    jprob, jk, jp, jn = mapmaker.extract_bundle(
        jm, jnp.ones(K, bool), jnp.zeros(K, bool), jm.point_valid, 128)
    tprob, tk, tp, tn = tmapmaker.extract_bundle(
        tm, torch.ones(K, dtype=torch.bool), torch.zeros(K, dtype=torch.bool),
        tm.point_valid, 128)
    assert int(tn) == int(jn) == 248
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_problems_equal(jprob, tprob)
    sel = set(zip(tk.tolist(), tp.tolist()))
    assert len(sel) == 128
    assert all((0, p) in sel for p in range(60))
    assert all((k, p) in sel for k in (2, 3) for p in range(60, 64))


def test_local_ba_masks_match_jax():
    """Newest keyframe 5 and its 4 nearest non-fixed neighbours, with
    distance ties (taken by lower index) and a fixed keyframe among the
    nearest."""
    K, P = 8, 64
    t = np.zeros((K, 3), np.float32)
    t[:, 0] = [0.0, 1.0, 2.0, 1.0, 3.0, 2.0, 3.0, 4.0]
    meas = np.zeros((K, P), bool)
    for k in range(K):
        meas[k, k * 6:k * 6 + 12] = True
    jm, tm = _ba_maps(P, K, kf_t=t, kf_valid=np.arange(K) < 7,
                      kf_fixed=np.arange(K) == 3,
                      point_valid=np.arange(P) < 50, meas_valid=meas)
    for newest in (5, 0):
        want = mapmaker.local_ba_masks(jm, newest)
        got = tmapmaker.local_ba_masks(tm, torch.tensor(newest))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[0].any() and got[1].any()


def test_handle_bad_points_thresholds_match_jax():
    P = 128
    outl, inl = np.zeros(P, np.int32), np.zeros(P, np.int32)
    outl[:3], inl[:3] = [25, 25, 10], [30, 5, 1]
    meas = np.zeros((4, P), bool)
    meas[0, :3] = True
    jm, tm = _ba_maps(P, point_valid=np.arange(P) < 3, point_outlier=outl,
                      point_inlier=inl, meas_valid=meas)
    tout = tmapmaker.handle_bad_points(tm)
    _assert_maps_equal(mapmaker.handle_bad_points(jm), tout,
                       ("point_valid", "meas_valid"))
    assert tout.point_valid[:3].tolist() == [True, False, True]
    assert tout.meas_valid[0, :3].tolist() == [True, False, True]
    # The MapMaker runs it only after the map changed.
    maker = tmapmaker.MapMaker(tm, _ba_cam(), BA_SIZE)
    maker.handle_bad_points()
    assert maker.map is tm
    maker.mark_dirty()
    maker.handle_bad_points()
    assert torch.equal(maker.map.point_valid, tout.point_valid)


def _ba_cam():
    return tatan.make_camera((1.0, 1.0, 0.5, 0.5, 0.1), BA_SIZE, "cpu")


def _line_map(K, P=64):
    pos = np.zeros((P, 3), np.float32)
    pos[:, 2] = 2.0
    pos[:, 0] = np.linspace(-0.5, 0.5, P)
    meas = np.zeros((K, P), bool)
    meas[:2] = True
    _, tm = _ba_maps(P, K, kf_valid=np.arange(K) < 2,
                     point_valid=np.ones(P, bool), meas_valid=meas,
                     meas_pos=np.full((K, P, 2), 32.0, np.float32),
                     point_pos=pos, good=np.array(True))
    return tm


def test_mapmaker_tier_escalation():
    """An undersized tier ratchets its floor from the counts read, without
    a warning (which is for the largest tier only)."""
    maker = tmapmaker.MapMaker(_line_map(4), _ba_cam(), BA_SIZE)
    assert maker.max_ba_meas == 4 * 64
    maker._ba_caps = lambda: (4, 64, 32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        maker.bundle_adjust_all()
    assert not any("capacity exceeded" in str(x.message) for x in w)
    assert maker._tier_m_floor >= 128 and maker._last_n_sel == 128
    del maker._ba_caps
    assert maker._ba_caps()[2] >= 128


def test_ba_capacity_overflow_warns():
    maker = tmapmaker.MapMaker(_line_map(2), _ba_cam(), BA_SIZE,
                               max_ba_meas=32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        maker.bundle_adjust_all()
    assert any("capacity exceeded" in str(x.message) for x in w)


def test_bundle_adjust_failure_requests_reset(monkeypatch):
    """A failed LM run sets reset_requested and leaves the map untouched."""
    tm = _line_map(4)
    maker = tmapmaker.MapMaker(tm, _ba_cam(), BA_SIZE)

    def failing_chunk(state, cam, cfg, kind, limit, f):
        return dataclasses.replace(state, failed=torch.tensor(True)), (
            0, 1, 1, 0)

    monkeypatch.setattr(tbundle, "lm_chunk", failing_chunk)
    maker.bundle_adjust_all()
    assert maker.reset_requested and maker.map is tm
    # A MapMaker that asked for a reset refuses further work.
    assert maker.step(None) is None


def test_queued_keyframe_aborts_ba():
    """A keyframe queued after the extract aborts BA before LM starts; one
    queued during LM stops it after the chunk, and the chunk's result is
    applied."""
    tm = _line_map(4)
    maker = tmapmaker.MapMaker(tm, _ba_cam(), BA_SIZE)
    maker.bundle_adjust_all(start_only=True)
    maker.kf_queue.append("keyframe")
    assert maker._ba_poll() is False and maker._ba_job is None
    assert maker.map is tm
    maker.kf_queue.clear()
    maker.bundle_adjust_all(start_only=True)
    assert maker._ba_poll() is True             # LM started: one chunk
    maker.kf_queue.append("keyframe")
    assert maker._ba_poll() is False and maker._ba_job is None
    assert maker.map is not tm and maker._map_dirty


def test_ba_chunk_sizing():
    """Latency mode fits the measured per-step time into the budget
    (capped, never zero, a 1-step probe first); deterministic mode uses
    ba_steps_per_pass. Both reach the same map."""
    cfg = MapMakerConfig(ba_latency_budget_ms=15.0, ba_steps_per_pass=5)
    tm = _line_map(4)
    maker = tmapmaker.MapMaker(tm, _ba_cam(), BA_SIZE, cfg,
                               deterministic=False)
    assert maker._chunk_steps() == 1
    for step_ms, n in ((5.0, 3), (1.0, 5), (100.0, 1)):
        maker._ba_step_ms = step_ms
        assert maker._chunk_steps() == n
    det = tmapmaker.MapMaker(tm, _ba_cam(), BA_SIZE, cfg)
    assert det.deterministic          # a map on the CPU
    det._ba_step_ms = 100.0
    assert det._chunk_steps() == 5
    maker.bundle_adjust_all()         # latency mode runs and times a chunk
    assert maker._ba_step_ms is not None
    det.bundle_adjust_all()
    for f in ("kf_R", "kf_t", "point_pos", "point_valid", "meas_valid",
              "never_retry"):
        assert torch.equal(getattr(maker.map, f), getattr(det.map, f)), f
    assert torch.equal(maker.failure_mask, det.failure_mask)


@pytest.fixture(scope="module")
def ba_scene():
    tm, tcam = tsynth.ba_map(n_kfs=10, max_kfs=16, n_pts=256, seed=3,
                             image_size=BA_SIZE, device="cpu")
    return tm, tcam, atan.make_camera(*tsynth.BA_CAMERA)


def test_ba_map_is_consistent(ba_scene):
    tm, cam, _ = ba_scene
    ok = tm.point_valid
    n_meas = tm.meas_valid.sum(0)
    assert bool((n_meas[ok] >= 2).all()) and not bool(tm.meas_valid[:, ~ok]
                                                      .any())
    assert tm.kf_valid.sum() == 10
    assert tm.kf_fixed.nonzero()[:, 0].tolist() == [0, 5]
    root = tm.meas_valid & (tm.meas_source == tms.SRC_ROOT)
    assert torch.equal(root.sum(0), ok.to(torch.int64))
    assert torch.equal(root.to(torch.int64).argmax(0)[ok],
                       tm.point_src_kf[ok].long())
    src = set(tm.meas_source[tm.meas_valid].tolist())
    assert src == {tms.SRC_ROOT, tms.SRC_TRACKER, tms.SRC_REFIND,
                   tms.SRC_TRAIL, tms.SRC_EPIPOLAR}
    assert set(tm.meas_level[tm.meas_valid].tolist()) == {0, 1, 2, 3}
    prob, *_ = tmapmaker.extract_bundle(tm, tm.kf_valid & ~tm.kf_fixed,
                                        tm.kf_fixed, ok, 1024)
    rms = float(tbundle.residual_rms(prob, cam))
    assert 0.3 < rms < 20.0, rms     # perturbed, not garbage


@pytest.mark.parametrize("kind", ["all", "recent"])
def test_bundle_adjust_matches_jax(ba_scene, kind):
    """Global and local BA through both MapMakers (deterministic mode) on
    the same 10-keyframe map."""
    tm, tcam, jcam = ba_scene
    jmaker = mapmaker.MapMaker(_to_jax(tm), jcam, BA_SIZE)
    tmaker = tmapmaker.MapMaker(tms.copy_map(tm), tcam, BA_SIZE,
                                deterministic=True)
    assert jmaker.deterministic and tmaker.deterministic
    jmaker._n_points_hint = tmaker._n_points_hint = int(tm.point_valid.sum())
    for maker in (jmaker, tmaker):
        if kind == "all":
            maker.bundle_adjust_all()
        else:
            maker.bundle_adjust_recent(9)
    assert not tmaker.reset_requested and not jmaker.reset_requested
    assert tmaker._last_n_sel == jmaker._last_n_sel > 500
    assert (tmaker.converged_full, tmaker.converged_recent) == (
        jmaker.converged_full, jmaker.converged_recent)
    np.testing.assert_array_equal(tmaker.failure_mask.numpy(),
                                  np.asarray(jmaker.failure_mask))
    _assert_maps_equal(jmaker.map, tmaker.map,
                       ("point_valid", "meas_valid", "never_retry"))
    ref = fj.as_numpy_tree(jmaker.map)
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("point_pos", 1e-3)):
        np.testing.assert_allclose(getattr(tmaker.map, f).numpy(), ref[f],
                                   rtol=0, atol=tol, err_msg=f)
    assert not torch.equal(tmaker.map.point_pos, tm.point_pos)
    assert int((tmaker.failure_mask | tmaker.map.never_retry).sum()) > 0


def test_applied_ba_queues_failures_as_jax(ba_scene):
    """An applied BA run sets ``_failures_pending`` and fills the failure
    mask as JAX's does; the failure queue's re-find then clears both and
    marks the same measurements never-retry."""
    tm, tcam, jcam = ba_scene
    jmaker = mapmaker.MapMaker(_to_jax(tm), jcam, BA_SIZE)
    tmaker = tmapmaker.MapMaker(tms.copy_map(tm), tcam, BA_SIZE)
    jmaker._n_points_hint = tmaker._n_points_hint = int(tm.point_valid.sum())
    assert not jmaker._failures_pending and not tmaker._failures_pending
    for maker in (jmaker, tmaker):
        maker.bundle_adjust_all()
    assert jmaker._failures_pending and tmaker._failures_pending
    np.testing.assert_array_equal(tmaker.failure_mask.numpy(),
                                  np.asarray(jmaker.failure_mask))
    assert int(tmaker.failure_mask.sum()) > 0
    for maker in (jmaker, tmaker):
        maker.refind_from_failure_queue()
    assert not jmaker._failures_pending and not tmaker._failures_pending
    assert not bool(tmaker.failure_mask.any())
    _assert_maps_equal(jmaker.map, tmaker.map,
                       ("point_valid", "meas_valid", "never_retry"))


def test_refind_all_kfs_spans_match_jax(monkeypatch):
    """The scheduler's two spans over 20 keyframe slots, [0, 16) and the
    tail [4, 20), which scans slots 4..15 again: the port calls
    ``refind_in_kf`` only for keyframes with work, the JAX scan's
    ``lax.cond`` runs the same ones, and a slot scanned again has none
    left. (The atlases are empty, so every search fails and the result is
    the never-retry marks: exact.)"""
    tm, tcam = tsynth.ba_map(n_kfs=20, max_kfs=20, n_pts=96, seed=1,
                             image_size=BA_SIZE, device="cpu")
    jcam = atan.make_camera(*tsynth.BA_CAMERA)
    valid = np.zeros(20, bool)
    valid[[0, 2, 3, 5, 7, 9, 12, 14, 17, 19]] = True
    tm.kf_valid = torch.from_numpy(valid)
    mask2d = np.random.default_rng(2).uniform(size=(20, 96)) < 0.3
    mask2d[[2, 12]] = False
    jm = _to_jax(tm)
    calls = []
    refind = tmapmaker.refind_in_kf

    def counted(m, k, *a, **kw):
        calls.append(int(k))
        return refind(m, k, *a, **kw)

    monkeypatch.setattr(tmapmaker, "refind_in_kf", counted)
    maker = tmapmaker.MapMaker(tm, tcam, BA_SIZE)
    assert maker._span_ks == [range(0, 16), range(4, 20)]
    for span in maker._span_ks:
        ref = fj.as_numpy_tree(jm)
        work = ref["kf_valid"] & np.any(
            mask2d & ref["point_valid"] & ~ref["meas_valid"]
            & ~ref["never_retry"], axis=-1)
        want = [k for k in span if work[k]]
        calls.clear()
        jm, jn = mapmaker.refind_all_kfs(
            jm, jnp.asarray(mask2d), jcam, BA_SIZE,
            jnp.arange(span.start, span.stop))
        tm, tn = tmapmaker.refind_all_kfs(tm, torch.from_numpy(mask2d), tcam,
                                          BA_SIZE, span)
        assert calls == want
        assert int(tn) == int(jn)
        _assert_maps_equal(jm, tm, ("meas_valid", "never_retry"))
    assert calls == [17, 19]        # the tail re-scans 4..15 for nothing
    assert int(tm.never_retry.sum()) > 0


def test_phased_integration_matches_fused(scene):
    """tests/test_mapmaker_units.py's check: the scheduler's five phases
    (insert + re-find, then one epipolar level a pass), landed by
    ``_drain_integrate``, give the fused program's map bit for bit."""
    mt = {k: fj.tensor(v, "cpu") for k, v in scene["meas"].items()}
    ff = fj.frame_features_from_numpy(fj.as_numpy_tree(scene["ff2"]), "cpu")
    pose = fj.se3_from_numpy(fj.as_numpy_tree(scene["pose2"]), "cpu")
    cam = fj.camera_from_numpy(fj.as_numpy_tree(scene["seq"].cam), "cpu")

    def fresh():
        return fj.map_state_from_numpy(fj.as_numpy_tree(scene["m"]), "cpu")

    out_m, new_mask, slot_n = tmapmaker.integrate_keyframe_program(
        fresh(), ff, pose, mt["point"], mt["pos"], mt["level"], mt["subpix"],
        mt["valid"], torch.tensor(1.5), torch.tensor(0.1),
        torch.zeros(P, dtype=torch.bool), cam, SIZE, WIGGLE, THIN)
    maker = tmapmaker.MapMaker(fresh(), cam, SIZE)
    maker.add_keyframe(ff, pose, mt, torch.tensor(1.5), torch.tensor(0.1))
    maker._integrate_start()
    n_phases = 1
    while maker._integrate_job is not None:
        maker._integrate_advance()
        n_phases += 1
    assert n_phases == 1 + len(tmapmaker.EPI_LEVEL_ORDER)
    assert maker.n_kfs() == 2 and maker.queue_size() == 0
    assert maker._drain_integrate(block=True) == int(slot_n[0])
    assert maker._new_points_pending == (int(slot_n[1]) > 0)
    assert torch.equal(maker.new_point_mask, new_mask)
    for f in dataclasses.fields(out_m):
        assert torch.equal(getattr(maker.map, f.name),
                           getattr(out_m, f.name)), f.name


# ---------------------------------------------------------------------------
# The scheduler: the same add_keyframe + step() sequence in both packages
# ---------------------------------------------------------------------------

SCHED_KFS = 20          # keyframe slots: spans [0, 16) and [4, 20)
SCHED_FRAMES = 8        # keyframes added through the queue
SCHED_STEPS = 10        # step() passes after each add_keyframe
SCHED_IDLE = 40         # passes after the last
GC_POINTS = 5           # points given outlier counts GC must act on


@pytest.fixture(scope="module")
def sched_scene():
    """An orbit wide enough that every new keyframe sees its nearest at a
    baseline of ~0.1 (radius 0.6, sweep 1.6 over 10 frames): the JAX
    package's float32 triangulation of the new points then errs by ~1e-4,
    inside the BA bars (at 0.03 it errs by up to 3e-2, and the runs part).
    The map: frame 0's candidates on the plane, keyframe 0 (fixed) with
    their root measurements, and frame 9 as keyframe 1, fixed, measuring
    every point (two fixed keyframes pin the scale). Keyframes 2..9 are
    frames 1..8 at their true poses, with tracker measurements of a
    seeded half of the points, 5% of them moved 6 px (outliers for BA's
    failure queue); the first ``GC_POINTS`` points carry outlier counts
    past ``bad_point_outlier_min``."""
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                  n_frames=SCHED_FRAMES + 2, seed=7,
                                  height=1.5, radius=0.6, sweep=1.6)
    build = jax.jit(lambda x: keyframe.build_frame(
        x, candidate_min_score=50.0))
    m = _jax_map(seq, build(seq.frame(0)), SCHED_KFS)
    far = SCHED_FRAMES + 1
    pose_far = seq.pose(far)
    m = map_state.insert_keyframe(m, 1, build(seq.frame(far)), pose_far, 1.5,
                                  0.1, fixed=True)
    p_cam = m.point_pos @ pose_far.R.T + pose_far.t
    pix = atan.project(p_cam[:, :2] / p_cam[:, 2:3], seq.cam)
    m = map_state.set_measurements(
        m, 1, jnp.arange(P), pix, jnp.zeros(P, jnp.int32),
        jnp.zeros(P, bool), jnp.full(P, map_state.SRC_REFIND, jnp.int32),
        m.point_valid & (p_cam[:, 2] > 0.1))
    m = m._replace(kf_fixed=m.kf_fixed.at[0].set(True),
                   point_outlier=m.point_outlier.at[:GC_POINTS].set(30))
    rng = np.random.default_rng(1)
    kfs = []
    for f in range(1, SCHED_FRAMES + 1):
        pose = seq.pose(f)
        p_cam = m.point_pos @ pose.R.T + pose.t
        pix = np.array(atan.project(p_cam[:, :2] / p_cam[:, 2:3], seq.cam))
        pick = rng.uniform(size=P) < 0.5
        pix[rng.uniform(size=P) < 0.05] += 6.0
        meas = dict(point=jnp.arange(P), pos=jnp.asarray(pix),
                    level=m.point_src_level, subpix=m.point_valid,
                    valid=m.point_valid & (p_cam[:, 2] > 0.1) & pick)
        kfs.append((build(seq.frame(f)), pose, meas))
    return seq, m, kfs


def _run_scheduler(maker, kfs, to_port):
    """add_keyframe, then ``SCHED_STEPS`` passes, for each keyframe, then
    ``SCHED_IDLE`` passes; the step returns and the scheduler's state
    after every pass, and the jobs started."""
    jobs = {"local BA": 0, "global BA": 0, "span": 0, "failure queue": 0,
            "GC": 0}
    for name, job in (("_ba_start", None), ("_refind_advance", "span"),
                      ("handle_bad_points", "GC")):
        def wrapped(*a, _f=getattr(maker, name), _job=job, **kw):
            if _job is None:
                recent = kw["recent"] if "recent" in kw else a[3]
                jobs["local BA" if recent else "global BA"] += 1
            elif _job != "GC" or maker._map_dirty:
                jobs[_job] += 1
            return _f(*a, **kw)
        setattr(maker, name, wrapped)
    queue = maker.refind_from_failure_queue

    def failure_queue(*a, **kw):
        jobs["failure queue"] += int(maker.failure_mask.sum())
        return queue(*a, **kw)

    maker.refind_from_failure_queue = failure_queue
    log, newest = [], 0

    def step():
        nonlocal newest
        ret = maker.step(newest)
        newest = newest if ret is None else ret
        log.append((ret, maker.n_kfs(), maker.converged_recent,
                    maker.converged_full, maker._failures_pending,
                    maker._new_points_pending))

    for ff, pose, meas in kfs:
        if to_port:
            maker.add_keyframe(
                fj.frame_features_from_numpy(fj.as_numpy_tree(ff), "cpu"),
                fj.se3_from_numpy(fj.as_numpy_tree(pose), "cpu"),
                {k: fj.tensor(v, "cpu") for k, v in meas.items()},
                torch.tensor(1.5), torch.tensor(0.1))
        else:
            maker.add_keyframe(ff, pose, meas, jnp.float32(1.5),
                               jnp.float32(0.1))
        for _ in range(SCHED_STEPS):
            step()
    for _ in range(SCHED_IDLE):
        step()
    return log, jobs


def test_scheduler_matches_jax(sched_scene):
    """Eight keyframes through ``add_keyframe`` and ``step()`` in both
    MapMakers (deterministic mode, seed 0): the same step returns,
    keyframe counts, convergence and pending flags after every pass, the
    same jobs (local and global BA, span re-finds, the failure queue on
    the same numpy draw, GC), the same point-valid, measurement and
    never-retry masks, poses within 1e-4 and points within 1e-3 (the BA
    bars of tests/test_torch_bundle.py)."""
    seq, m, kfs = sched_scene
    jmaker = mapmaker.MapMaker(m, seq.cam, SIZE, seed=0)
    tmaker = tmapmaker.MapMaker(
        fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"),
        fj.camera_from_numpy(fj.as_numpy_tree(seq.cam), "cpu"), SIZE, seed=0)
    assert jmaker.deterministic and tmaker.deterministic
    jmaker._n_points_hint = tmaker._n_points_hint = int(m.point_valid.sum())
    jlog, jjobs = _run_scheduler(jmaker, kfs, False)
    tlog, tjobs = _run_scheduler(tmaker, kfs, True)
    assert tlog == jlog
    assert tjobs == jjobs
    assert tmaker.n_kfs() == SCHED_FRAMES + 2
    assert all(n > 0 for n in tjobs.values()), tjobs
    print(f"\nscheduler jobs: {tjobs}")
    ref = fj.as_numpy_tree(jmaker.map)
    _assert_maps_equal(jmaker.map, tmaker.map,
                       ("point_valid", "meas_valid", "never_retry",
                        "kf_valid"))
    assert not ref["point_valid"][:GC_POINTS].any()      # GC trashed them
    assert int(tmaker.map.point_valid.sum()) > int(m.point_valid.sum())
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("point_pos", 1e-3)):
        np.testing.assert_allclose(getattr(tmaker.map, f).numpy(), ref[f],
                                   rtol=0, atol=tol, err_msg=f)
