"""The port's map viewer and AR compositor against the JAX package's on
the same seeded inputs (tests/test_viz.py's cases, mirrored).

Bars: the map render and the overlay equal pixel for pixel; the AR
composites (a cube, EyeGame's eyeballs) differ by more than 1e-3 on
under 1% of the pixels. The undistort / redistort resamples: the
coordinates where the two packages sample agree within 2 float32 ulps
of a coordinate in [256, 512) px, 1.2e-4 px (XLA's atan/tan and torch's
round apart; measured: at most 1 such ulp, on 0.09% of them), bilinear
sampling at the same coordinates agrees within 1e-3 of pixel value everywhere,
and the whole resample agrees within 1e-3 on at least 99.9% of the
pixels (an ulp of a coordinate near 300 px, 3e-5 px, times an image
gradient of ~100 a px moves a value by ~3e-3; measured: 34 of 307,200
pixels over 1e-3 undistorting, at most 3.7e-3, 1 redistorting).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.camera import atan as jatan
from ptam_cg_tpu.io import synth as jsynth
from ptam_cg_tpu.models import map_state as jmap_state
from ptam_cg_tpu.ops import image as jimage
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu.viz import ar as jar
from ptam_cg_tpu.viz import mapviewer as jmapviewer
from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.io.from_jax import as_numpy_tree, map_state_from_numpy
from ptam_cg_tpu_torch.ops import image
from ptam_cg_tpu_torch.utils.se3 import SE3
from ptam_cg_tpu_torch.viz import ar, mapviewer

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)


@pytest.fixture(scope="module")
def cams():
    return (atan.make_camera(REF_PARAMS, SIZE, "cpu"),
            jatan.make_camera(REF_PARAMS, SIZE))


@pytest.fixture(scope="module")
def scene():
    seq = jsynth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=1,
                                   seed=0)
    pose = seq.pose(0)
    tpose = SE3(torch.from_numpy(np.array(pose.R)),
                torch.from_numpy(np.array(pose.t)))
    return np.array(seq.frame(0)), pose, tpose


def small_map():
    """tests/test_viz.py's map: 32 points near the z=0 plane, one
    keyframe; as (JAX MapState, port MapState)."""
    m = jmap_state.empty_map(SIZE, max_points=64, max_kfs=4)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.5, -0.5, 0], [0.5, 0.5, 0.02],
                      (32, 3)).astype(np.float32)
    P = m.point_pos.shape[0]
    pos = np.zeros((P, 3), np.float32)
    pos[:32] = pts
    m = m._replace(
        point_pos=jnp.asarray(pos),
        point_valid=jnp.asarray(np.arange(P) < 32),
        point_src_level=jnp.asarray(rng.integers(0, 4, P).astype(np.int32)),
        kf_valid=m.kf_valid.at[0].set(True),
        kf_t=m.kf_t.at[0].set(jnp.array([0.0, 0.0, 1.5])))
    return m, map_state_from_numpy(as_numpy_tree(m), "cpu")


def test_camera_ufb_fields_match_jax(cams):
    cam, jcam = cams
    for f in ("implane_tl", "implane_br", "ufb_linear_focal",
              "ufb_linear_center"):
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)), rtol=2e-7,
                                   atol=0, err_msg=f)
    xy = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.6, 0.6, (500, 2)).astype(np.float32))
    for name in ("ufb_project", "ufb_unproject", "ufb_linear_project",
                 "ufb_linear_unproject"):
        got = getattr(atan, name)(xy, cam).numpy()
        want = np.asarray(getattr(jatan, name)(jnp.asarray(xy.numpy()),
                                               jcam))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(2)
    im = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    xy = rng.uniform(-2, 42, (1000, 2)).astype(np.float32)
    got, ok = image.bilinear_sample(torch.from_numpy(im),
                                    torch.from_numpy(xy), pad_value=-1.0)
    want, jok = jimage.bilinear_sample(jnp.asarray(im), jnp.asarray(xy),
                                       pad_value=-1.0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < ok.sum() < len(xy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_undistort_redistort_match_jax(cams, scene):
    cam, jcam = cams
    frame = scene[0]
    # The coordinates undistort_frame samples the frame at.
    Wo, Ho = 640, 480
    ys, xs = np.mgrid[0:Ho, 0:Wo].astype(np.float32)
    ufb = np.stack([(xs + 0.5) / Wo, (ys + 0.5) / Ho], -1).reshape(-1, 2)
    pix = atan.project(atan.ufb_linear_unproject(torch.from_numpy(ufb), cam),
                       cam).numpy()
    jpix = np.array(jatan.project(jatan.ufb_linear_unproject(
        jnp.asarray(ufb), jcam), jcam))
    assert np.abs(pix - jpix).max() <= 2 * np.spacing(np.float32(256))
    vals, _ = image.bilinear_sample(torch.from_numpy(frame),
                                    torch.from_numpy(jpix))
    jvals, _ = jimage.bilinear_sample(jnp.asarray(frame), jnp.asarray(jpix))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0,
                               atol=1e-3)
    # The whole resamples, there and back (2x the frame, as the
    # reference's 1200x900 frame buffer for 640x480, ARDriver.cc:25-30).
    linear = ar.undistort_frame(frame, cam, (Wo, Ho))
    jlinear = np.asarray(jar.undistort_frame(jnp.asarray(frame), jcam,
                                             (Wo, Ho)))
    d = np.abs(linear.numpy() - jlinear)
    assert (d <= 1e-3).mean() >= 0.999 and d.max() < 1e-2, (
        (d > 1e-3).sum(), d.max())
    back = ar.redistort_frame(torch.from_numpy(jlinear.copy()), cam, SIZE)
    jback = np.asarray(jar.redistort_frame(jnp.asarray(jlinear), jcam, SIZE))
    d = np.abs(back.numpy() - jback)
    assert (d <= 1e-3).mean() >= 0.999 and d.max() < 1e-2, (
        (d > 1e-3).sum(), d.max())
    # tests/test_viz.py's round trip: the centre comes back.
    err = np.abs(frame[60:180, 80:240]
                 - ar.redistort_frame(linear, cam, SIZE).numpy()
                 [60:180, 80:240]).mean()
    assert err < 6.0, err


def test_topdown_render_matches_jax(tmp_path):
    jm, m = small_map()
    traj = np.random.default_rng(3).uniform(-0.4, 0.4, (20, 3))
    img = mapviewer.render_topdown(m, size=(400, 400), trajectory=traj)
    np.testing.assert_array_equal(
        img, jmapviewer.render_topdown(jm, size=(400, 400), trajectory=traj))
    assert (img != 25).any(axis=-1).sum() > 100
    mapviewer.save_ppm(str(tmp_path / "map.ppm"), img)
    raw = (tmp_path / "map.ppm").read_bytes()
    assert raw.startswith(b"P6 400 400 255")
    empty = dataclasses.replace(m, point_valid=torch.zeros_like(
        m.point_valid), kf_valid=torch.zeros_like(m.kf_valid))
    assert (mapviewer.render_topdown(empty, size=(40, 30)) == 25).all()


def test_overlay_tracked_points_matches_jax(cams):
    cam, jcam = cams
    jm, m = small_map()
    jpose = jse3.SE3(jnp.eye(3), jnp.array([0.0, 0.0, 1.5]))
    pose = SE3(torch.eye(3), torch.tensor([0.0, 0.0, 1.5]))
    pix, levels, mask = mapviewer.project_points_into_frame(m, pose, cam,
                                                            SIZE)
    jpix, jlevels, jmask = jmapviewer.project_points_into_frame(
        jm, jpose, jcam, SIZE)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(levels, jlevels)
    np.testing.assert_allclose(pix[mask], jpix[mask], rtol=0, atol=1e-3)
    assert mask.sum() > 10
    frame = np.full((240, 320), 100.0, np.float32)
    img = mapviewer.overlay_tracked_points(frame, pix, levels, mask)
    np.testing.assert_array_equal(
        img, jmapviewer.overlay_tracked_points(frame, jpix, jlevels, jmask))
    assert (img != 100).any()


def _differing(a, b):
    return float((np.abs(a - b) > 1e-3).mean())


def test_ar_cube_matches_jax(cams, scene):
    cam, jcam = cams
    frame, jpose, pose = scene
    verts, tris, shades = ar.make_cube(0.3, device="cpu")
    jverts, jtris, jshades = jar.make_cube(0.3)
    np.testing.assert_array_equal(verts.numpy(), np.asarray(jverts))
    np.testing.assert_array_equal(tris, np.asarray(jtris))
    np.testing.assert_array_equal(shades, np.asarray(jshades))
    out = ar.render_ar_frame(frame, pose, cam, SIZE, verts, tris, shades,
                             ufb_size=SIZE).numpy()
    want = np.asarray(jar.render_ar_frame(jnp.asarray(frame), jpose, jcam,
                                          SIZE, jverts, jtris, jshades,
                                          ufb_size=SIZE))
    assert out.shape == (240, 320)
    assert _differing(out, want) < 0.01
    changed = (np.abs(out - frame) > 20).sum()
    assert 50 < changed < 240 * 320 * 0.5, changed


def test_eye_game_matches_jax(cams, scene):
    """EyeGame (src/EyeGame.cc:15-241): pupils turn with the camera while
    the eyeballs stay; the composite draws sclera and pupils."""
    cam, jcam = cams
    frame, jpose, pose = scene
    c1 = np.array([0.0, 0.0, 1.0], np.float32)
    c2 = np.array([0.5, 0.3, 1.0], np.float32)
    v1, t1, s1 = ar.make_eye_game(torch.from_numpy(c1))
    v2, t2, _ = ar.make_eye_game(torch.from_numpy(c2))
    jv1, jt1, js1 = jar.make_eye_game(jnp.asarray(c1))
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(t1, jt1)
    np.testing.assert_array_equal(s1, js1)
    np.testing.assert_array_equal(t1, t2)
    assert v1.shape == (4 * 13, 3)
    for e in range(4):
        o = e * 13
        np.testing.assert_allclose(v1[o:o + 6], v2[o:o + 6], atol=1e-6)
        assert (v1[o + 6:o + 13] - v2[o + 6:o + 13]).abs().max() > 1e-3
    c = (-pose.R.T @ pose.t)
    verts, tris, shades = ar.make_eye_game(c)
    jverts, jtris, jshades = jar.make_eye_game(jnp.asarray(c.numpy()))
    out = ar.render_ar_frame(frame, pose, cam, SIZE, verts, tris, shades,
                             ufb_size=SIZE).numpy()
    want = np.asarray(jar.render_ar_frame(jnp.asarray(frame), jpose, jcam,
                                          SIZE, jverts, jtris, jshades,
                                          ufb_size=SIZE))
    assert _differing(out, want) < 0.01
    small = (64, 48)
    scam = atan.make_camera(REF_PARAMS, small, "cpu")
    R, t = torch.eye(3), torch.tensor([0.0, 0.0, 0.6])
    verts, tris, shades = ar.make_eye_game(-R.T @ t, spacing=0.08,
                                           radius=0.05)
    out = ar.render_ar_frame(torch.full((48, 64), 100.0), SE3(R, t), scam,
                             small, verts, tris, shades,
                             ufb_size=small).numpy()
    assert (out > 200).sum() > 50 and (out < 50).sum() > 50
