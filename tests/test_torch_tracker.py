"""The tracking slice: the PyTorch port against the JAX package.

A JAX-built 320x240 scene (as in tests/test_tracker.py) goes through
``ptam_cg_tpu_torch.io.from_jax``; both packages then track the same frame
with the same uniforms (rebuilt here from the JAX key, as the JAX step
derives them). Bars:

- the same found set. A point may differ only if the port's diagnostics
  trace it to float noise (ZMSSD near-tie, ZMSSD at the acceptance limit,
  subpixel step at its convergence limit); each such point is listed in
  the failure message, and there may be at most 1% of them;
- found positions within 1e-3 level-0 px: the subpixel solve sums in
  another order, and its noise is ~1e-4 px;
- pose within 1e-5 (rotation entries and translation): the Gauss-Newton
  sums over ~1000 residuals run in another order, and the JAX loop's
  early exit is matched only to float noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import keyframe, map_state, tracker
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.models import tracker as ttracker
from ptam_cg_tpu_torch.utils import parity
from ptam_cg_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
POSE_TOL = 1e-5
POS_TOL = 1e-3


class _Sequence:
    """tests/test_tracker.py's sequence, textured with the port's numpy
    texture (jax.random draws have no torch counterpart) and rendered by
    the JAX package."""

    def __init__(self):
        self.cam = jax.jit(lambda p: atan.make_camera(p, SIZE))(
            jnp.asarray(REF_PARAMS, jnp.float32))
        self.poses = jax.jit(synth.orbit_trajectory, static_argnums=0)(
            8, 1.5, 0.12, 0.6)
        tex = jnp.asarray(tsynth.make_texture(np.random.default_rng(3),
                                              device="cpu").numpy())
        self._render = jax.jit(lambda R, t: synth.render_plane(
            self.cam, se3lib.SE3(R, t), tex, SIZE))

    def pose(self, i):
        return se3lib.SE3(self.poses.R[i], self.poses.t[i])

    def frame(self, i):
        return self._render(self.poses.R[i], self.poses.t[i])


def _jax_map(cam, pose0, tf0, ctr, lv):
    """Points at level coords ``ctr`` / levels ``lv`` of frame 0,
    back-projected onto the z=0 plane, in a 4-keyframe JAX map holding
    frame 0 as keyframe 0 (its keyframe-only lists stay empty)."""
    P, K = 512, 4
    n = ctr.shape[0]
    z1 = atan.unproject(levelops.level_zero_pos(ctr, lv), cam)
    T_wc = se3lib.inv(pose0)
    dir_w = jnp.concatenate([z1, jnp.ones_like(z1[:, :1])], -1) @ T_wc.R.T
    pts = T_wc.t + (-T_wc.t[2] / dir_w[:, 2])[:, None] * dir_w
    NC, CC = keyframe.NONMAX_CAP, keyframe.CAND_CAP
    ff0 = keyframe.FrameFeatures(
        atlas=tf0.atlas, corner_mask=tf0.corner_mask,
        corner_count=jnp.zeros(4, jnp.int32),
        max_xy=jnp.zeros((4, NC, 2), jnp.int32), max_score=jnp.zeros((4, NC)),
        max_valid=jnp.zeros((4, NC), bool),
        cand_xy=jnp.zeros((4, CC, 2), jnp.int32), cand_score=jnp.zeros((4, CC)),
        cand_valid=jnp.zeros((4, CC), bool),
        sbi=tf0.sbi, sbi_track=tf0.sbi_track)
    m = map_state.empty_map(SIZE, max_points=P, max_kfs=K)
    m = map_state.insert_keyframe(m, 0, ff0, pose0, 1.5, 0.1)
    cpad = jnp.zeros((P, 2)).at[:n].set(ctr)
    lpad = jnp.zeros(P, jnp.int32).at[:n].set(lv)
    c_nc, r_nc, d_nc, nrm = map_state.make_point_rays(cpad, lpad, pose0, cam,
                                                      SIZE)
    m = m._replace(
        point_pos=jnp.zeros((P, 3)).at[:n].set(pts),
        point_valid=jnp.arange(P) < n, point_src_level=lpad,
        point_center=cpad, point_center_nc=c_nc, point_right_nc=r_nc,
        point_down_nc=d_nc, point_normal_nc=nrm, good=jnp.asarray(True))
    return map_state.refresh_pixel_vectors(m)


@pytest.fixture(scope="module")
def scene():
    """JAX map of frame 0, built as tests/test_tracker.py builds it but
    from the FAST corners ``planar_map_scene`` uses in place of the
    Shi-Tomasi candidates: up to 100 corners per level, at least 10 px
    inside the level."""
    seq = _Sequence()
    cam = seq.cam
    tf0 = jax.jit(keyframe.build_frame_tracking)(seq.frame(0))
    r = np.random.default_rng(0)
    ctr, lv = [], []
    for lev in range(4):
        mask = np.asarray(levelops.unpack_level(tf0.corner_mask, lev,
                                                SIZE[1], SIZE[0]))
        ys, xs = np.nonzero(mask[10:-10, 10:-10])
        pick = np.sort(r.choice(len(xs), min(100, len(xs)), replace=False))
        ctr.append(np.stack([xs[pick], ys[pick]], -1) + 10)
        lv.append(np.full(len(pick), lev))
    m = jax.jit(_jax_map)(cam, seq.pose(0), tf0,
                          jnp.asarray(np.concatenate(ctr), jnp.float32),
                          jnp.asarray(np.concatenate(lv), jnp.int32))
    return dict(seq=seq, cam=cam, m=m, ff0=tf0,
                tm=fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"),
                tcam=fj.camera_from_numpy(fj.as_numpy_tree(cam), "cpu"))


def _uniforms(key, P):
    k_coarse, k_fine = jax.random.split(key)
    return (fj.tensor(jax.random.uniform(k_coarse, (P,)), "cpu"),
            fj.tensor(jax.random.uniform(k_fine, (P,)), "cpu"))


def _assert_same_tracking(jres, tres):
    diffs = parity.found_set_differences(
        np.asarray(jres.meas_point), np.asarray(jres.meas_valid),
        np.asarray(jres.meas_pos), tres, pos_tol=POS_TOL)
    n_found = int(np.asarray(jres.meas_valid).sum())
    assert all(d["reason"] for d in diffs), diffs
    assert len(diffs) <= 0.01 * n_found, diffs
    np.testing.assert_allclose(tres.pose.R.numpy(), np.asarray(jres.pose.R),
                               atol=POSE_TOL)
    np.testing.assert_allclose(tres.pose.t.numpy(), np.asarray(jres.pose.t),
                               atol=POSE_TOL)
    if not diffs:
        np.testing.assert_array_equal(tres.found.numpy(),
                                      np.asarray(jres.found))
        np.testing.assert_array_equal(tres.attempted.numpy(),
                                      np.asarray(jres.attempted))


def test_track_map_matches_jax(scene):
    """Perturbed pose, coarse stage on (msd_vel above its gate)."""
    seq, cam, m = scene["seq"], scene["cam"], scene["m"]
    P = m.point_pos.shape[0]
    frame = jax.jit(keyframe.build_frame_tracking)(seq.frame(2))
    pose = jax.jit(lambda p: se3lib.mul(se3lib.se3_exp(
        jnp.array([0.01, -0.008, 0.005, 0.004, -0.003, 0.002])), p))(
        seq.pose(2))
    key = jax.random.PRNGKey(0)
    jres = jax.jit(lambda m_, f_, p_, k_: tracker.track_map(
        m_, f_, p_, cam, SIZE, k_, jnp.float32(1.0), jnp.asarray(False)))(
        m, frame, pose, key)
    rc, rf = _uniforms(key, P)
    tres = ttracker.track_map(
        scene["tm"],
        fj.track_features_from_numpy(fj.as_numpy_tree(frame), "cpu"),
        fj.se3_from_numpy(fj.as_numpy_tree(pose), "cpu"), scene["tcam"], SIZE,
        torch.tensor(1.0), torch.tensor(False), rand_coarse=rc, rand_fine=rf)
    assert bool(jres.did_coarse) and bool(tres.did_coarse)
    assert int(np.asarray(jres.meas_valid).sum()) > 100
    _assert_same_tracking(jres, tres)


def test_track_frame_from_image_matches_jax(scene):
    """The whole per-frame step from the image, frame 1 after frame 0."""
    seq, cam, m, ff0 = scene["seq"], scene["cam"], scene["m"], scene["ff0"]
    P = m.point_pos.shape[0]
    im = seq.frame(1)
    cam_params = jnp.asarray(REF_PARAMS, jnp.float32)
    state = tracker.init_tracker_state(seq.pose(0), seed=5)
    jout = jax.jit(lambda s, m_, im_, ps: tracker.track_frame_from_image(
        s, m_, im_, ps, cam, SIZE, cam_params))(state, m, im, ff0.sbi_track)
    _, k_frame = jax.random.split(state.key)
    rc, rf = _uniforms(k_frame, P)
    tout = ttracker.track_frame_from_image(
        fj.tracker_state_from_numpy(fj.as_numpy_tree(state), "cpu"),
        scene["tm"],
        fj.tensor(im, "cpu"),
        fj.sbi_from_numpy(fj.as_numpy_tree(ff0.sbi_track), "cpu"),
        scene["tcam"],
        SIZE, torch.tensor(REF_PARAMS), rand_coarse=rc, rand_fine=rf)
    _assert_same_tracking(jout.result, tout.result)
    assert int(tout.state.quality) == int(jout.state.quality)
    np.testing.assert_allclose(tout.state.velocity.numpy(),
                               np.asarray(jout.state.velocity), atol=POSE_TOL)
    # SBIs of the new frame: f32 blur sums in another order.
    np.testing.assert_allclose(tout.sbi_track.template.numpy(),
                               np.asarray(jout.sbi_track.template), atol=1e-3)
    np.testing.assert_allclose(tout.sbi.jac.numpy(),
                               np.asarray(jout.sbi.jac), atol=1e-3)


def test_five_frame_run_stays_good(scene):
    """Frames 1..5 through the port alone: GOOD, and within the bars of
    tests/test_tracker.py (0.02 camera centre, 0.01 rad)."""
    seq = scene["seq"]
    state = fj.tracker_state_from_numpy(
        fj.as_numpy_tree(tracker.init_tracker_state(seq.pose(0))), seed=1,
        device="cpu")
    prev = fj.sbi_from_numpy(fj.as_numpy_tree(scene["ff0"].sbi_track), "cpu")
    cam_params = torch.tensor(REF_PARAMS)
    for i in range(1, 6):
        out = ttracker.track_frame_from_image(
            state, scene["tm"], fj.tensor(seq.frame(i), "cpu"),
            prev, scene["tcam"], SIZE, cam_params)
        state, prev = out.state, out.sbi_track
        gt = fj.se3_from_numpy(fj.as_numpy_tree(seq.pose(i)), "cpu")
        rel = tse3.mul(state.pose, tse3.inv(gt))
        rot_err = float(torch.linalg.vector_norm(tse3.so3_log(rel.R)))
        c_est = -state.pose.R.T @ state.pose.t
        c_gt = -gt.R.T @ gt.t
        assert int(state.quality) == ttracker.QUALITY_GOOD, i
        assert rot_err < 0.01, (i, rot_err)
        assert float(torch.linalg.vector_norm(c_est - c_gt)) < 0.02, i


def test_init_tracker_state_defaults_to_the_identity():
    """Without a pose, the state sits at the identity on the device asked
    for (the engine's start and reset); a given pose is kept as it is."""
    t = ttracker.init_tracker_state(device="cpu", seed=3)
    j = tracker.init_tracker_state()
    for f in ("velocity", "msd_vel", "lost_frames", "quality",
              "just_recovered", "depth_mean", "depth_sigma"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t.pose.R.numpy(), np.asarray(j.pose.R))
    np.testing.assert_array_equal(t.pose.t.numpy(), np.asarray(j.pose.t))
    pose = tse3.se3_exp(torch.tensor([0.1, 0.0, 0.2, 0.01, 0.0, 0.0]))
    assert ttracker.init_tracker_state(pose).pose is pose
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ttracker.init_tracker_state()


def test_track_local_matches_jax(scene):
    """TrackMapLocal: the map gets three more keyframes (frames 3, 5 and
    7's poses) and a seeded measurement table; with ``track_local`` and
    the 2 keyframes nearest the predicted pose, both packages restrict the
    PVS to the same points (``local_point_mask``, exact) and track frame
    2 alike (the bars of ``test_track_map_matches_jax``)."""
    from ptam_cg_tpu.config import TrackerConfig
    from ptam_cg_tpu_torch import config as tconfig
    seq, cam, m, ff0 = scene["seq"], scene["cam"], scene["m"], scene["ff0"]
    P, K = m.meas_valid.shape[1], m.meas_valid.shape[0]
    frames = (0, 3, 5, 7)
    meas = np.random.default_rng(4).uniform(size=(K, P)) < 0.4
    m = m._replace(
        kf_valid=jnp.ones(K, bool),
        kf_R=jnp.stack([seq.pose(f).R for f in frames]),
        kf_t=jnp.stack([seq.pose(f).t for f in frames]),
        meas_valid=jnp.asarray(meas) & m.point_valid[None])
    tm = fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu")
    pose2 = fj.se3_from_numpy(fj.as_numpy_tree(seq.pose(2)), "cpu")
    local = ttracker.local_point_mask(tm, pose2, 2)
    np.testing.assert_array_equal(
        local.numpy(), np.asarray(tracker.local_point_mask(m, seq.pose(2),
                                                           2)))
    assert 0 < int(local.sum()) < int(tm.point_valid.sum())

    im = seq.frame(2)
    cam_params = jnp.asarray(REF_PARAMS, jnp.float32)
    state = tracker.init_tracker_state(seq.pose(1), seed=5)
    jcfg = TrackerConfig(track_local=True, track_local_kfs=2)
    jout = jax.jit(lambda s, m_, im_, ps: tracker.track_frame_from_image(
        s, m_, im_, ps, cam, SIZE, cam_params, jcfg))(state, m, im,
                                                      ff0.sbi_track)
    _, k_frame = jax.random.split(state.key)
    rc, rf = _uniforms(k_frame, P)
    tout = ttracker.track_frame_from_image(
        fj.tracker_state_from_numpy(fj.as_numpy_tree(state), "cpu"), tm,
        fj.tensor(im, "cpu"),
        fj.sbi_from_numpy(fj.as_numpy_tree(ff0.sbi_track), "cpu"),
        scene["tcam"], SIZE, torch.tensor(REF_PARAMS),
        tconfig.TrackerConfig(track_local=True, track_local_kfs=2),
        rand_coarse=rc, rand_fine=rf)
    _assert_same_tracking(jout.result, tout.result)
    res = tout.result
    found = res.meas_point[res.meas_valid]
    assert len(found) > 30 and bool(local[found].all())
    assert int(tout.state.quality) == int(jout.state.quality)
