"""The camera calibrator (``camera/calibrator.py``), ``atan.param_derivs``
and ``synth.render_checkerboard``: the PyTorch port against the JAX
package, on tests/test_calibrator.py's views (320x240, rendered at twice
the size by the JAX synth, half-sampled and blurred) handed to both as
numpy.

Bars: the checkerboard render equal in all but a few edge pixels (the
two packages' unprojections differ by float32 rounding, which moves a
pixel whose ray lands within that of a square's edge); the corner
candidates equal; the corner fit within 1e-3 px in position, 1e-4 rad in
angle and 1e-2 in mean and gain (f32 tolerance: JAX differentiates the
residuals by ``jacfwd``, the port by their written-out derivatives); the
grid grown from a view equal in grid positions and within 1e-3 px;
``param_derivs`` within 0.1 px a unit parameter (forward differences of
1e-3 over float32 projections of a few hundred pixels: an ulp of the
projection is ~3e-2 there). The full calibration meets
test_calibrator.py's bars (RMS < 0.3 px, fx..cy within 2%, |w| within
0.01), and after its first ``JAX_STEPS`` steps its RMS and fx..cy are
within 1e-4 of the JAX calibrator's from the same grids, |w| within 1e-3
(measured 1.8e-5 and 2.5e-4: w's column, the least conditioned, carries
``param_derivs``' float32 noise; after 100 steps the two runs end 5e-6
apart in every parameter; |w| only: the model is even in w).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_calibrator import GT_PARAMS, SIZE, VIEWS, checkerboard_view
from ptam_cg_tpu.camera import atan as jatan
from ptam_cg_tpu.camera import calibrator as jcal
from ptam_cg_tpu.io import synth as jsynth
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.camera import calibrator as tcal
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

#: Steps of the joint optimization compared between the packages (JAX's
#: runs eagerly, ~0.7 s a step here).
JAX_STEPS = 20


@pytest.fixture(scope="module")
def views():
    return [checkerboard_view(xi) for xi in VIEWS]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_render_checkerboard_matches_jax():
    big = (SIZE[0] * 2, SIZE[1] * 2)
    for xi in VIEWS[:2]:
        pose = jse3.se3_exp(jnp.asarray(xi, jnp.float32))
        want = np.asarray(jsynth.render_checkerboard(
            jatan.make_camera(GT_PARAMS, big), pose, big))
        got = tsynth.render_checkerboard(
            tatan.make_camera(GT_PARAMS, big, "cpu"),
            tse3.se3_exp(_t(xi)), big).numpy()
        assert (got != want).mean() < 1e-3, (got != want).mean()
        blurred = tsynth.render_checkerboard(
            tatan.make_camera(GT_PARAMS, big, "cpu"),
            tse3.se3_exp(_t(xi)), big, blur=0.8).numpy()
        want_b = np.asarray(jsynth.render_checkerboard(
            jatan.make_camera(GT_PARAMS, big), pose, big, blur=0.8))
        assert np.median(np.abs(blurred - want_b)) < 1e-3


def test_find_calib_corners_matches_jax(views):
    for im, _ in views[:2]:
        want = jcal.find_calib_corners(im)
        got = tcal.find_calib_corners(torch.from_numpy(np.array(im)))
        assert int(got.count) == int(want.count) > 20
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))


def test_corner_refiner_matches_jax(views):
    im, pose = views[0]
    cam = jatan.make_camera(GT_PARAMS, SIZE)
    starts = []
    for X in ([1.0, 1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
              [2.0, 1.0, 0.0]):
        p = jse3.apply(pose, jnp.array(X))
        starts.append(np.asarray(jatan.project(p[:2] / p[2], cam)) + 1.5)
    starts = np.stack(starts).astype(np.float32)
    ang = np.stack([np.asarray(jcal.guess_initial_angles(im, s))
                    for s in starts])
    tim = torch.from_numpy(np.array(im))
    tang = torch.stack([tcal.guess_initial_angles(tim, _t(s))
                        for s in starts])
    np.testing.assert_allclose(tang.numpy(), ang, atol=1e-6)
    mean, gain = np.full(4, 120.0, np.float32), np.full(4, 80.0, np.float32)
    want = jcal.make_corner_refiner(im.shape)(
        im, jnp.asarray(starts), jnp.asarray(ang), jnp.asarray(mean),
        jnp.asarray(gain))
    got = tcal.make_corner_refiner(tuple(im.shape), device="cpu")(
        tim, _t(starts), _t(ang), _t(mean), _t(gain))
    for g, w, tol in zip(got, want, (1e-3, 1e-4, 1e-2, 1e-2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].all()


def test_grid_growth_matches_jax(views):
    im, _ = views[0]
    want = jcal.CalibImage(im)
    assert want.make_grid()
    got = tcal.CalibImage(np.asarray(im), device="cpu")
    assert got.make_grid()
    assert len(got.grid) == len(want.grid) >= 9
    for g, w in zip(got.grid, want.grid):
        assert tuple(g.grid_pos) == tuple(w.grid_pos)
        assert g.neighbors == w.neighbors
        np.testing.assert_allclose(g.params.pos, w.params.pos, atol=1e-3)


def test_param_derivs_matches_jax():
    rng = np.random.default_rng(0)
    z1 = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    for params in (GT_PARAMS, (0.62, 0.82, 0.5, 0.5, 0.0)):
        want = np.asarray(jatan.param_derivs(
            jnp.asarray(z1), jatan.make_camera(params, SIZE)))
        got = tatan.param_derivs(torch.from_numpy(z1),
                                 tatan.make_camera(params, SIZE, "cpu"))
        assert got.shape == (64, 2, 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.1)
        if params[4] == 0.0:
            assert (got[..., 4] == 0).all()


def test_full_calibration_recovers_params_as_jax(views):
    calib = tcal.CameraCalibrator(SIZE, device="cpu")
    added = sum(calib.add_image(np.asarray(im)) for im, _ in views)
    assert added >= 2, added
    # The JAX calibrator from the port's grids, JAX_STEPS steps.
    jc = jcal.CameraCalibrator(SIZE)
    cam0 = jatan.make_camera(tuple(jc.params), SIZE)
    for v in calib.views:
        jv = object.__new__(jcal.CalibImage)
        jv.grid = [jcal.GridCorner(
            jcal.CornerParams(g.params.pos, g.params.angles, g.params.mean,
                              g.params.gain), tuple(g.grid_pos),
            list(g.neighbors)) for g in v.grid]
        jv.guess_initial_pose(cam0)
        jc.views.append(jv)
    jrms = jc.optimize(JAX_STEPS)
    rms = calib.optimize(JAX_STEPS)
    print(f"\ncalibration after {JAX_STEPS} steps: port RMS {rms:.5f} px, "
          f"JAX {jrms:.5f} px; params {np.round(calib.params, 6)} / "
          f"{np.round(jc.params, 6)}")
    np.testing.assert_allclose(calib.params[:4], jc.params[:4], rtol=0,
                               atol=1e-4)
    assert abs(abs(calib.params[4]) - abs(jc.params[4])) < 1e-3
    assert abs(rms - jrms) < 1e-4
    # test_calibrator.py's run: 100 steps in all.
    rms = calib.optimize(100 - JAX_STEPS)
    assert rms < 0.3, rms
    got = calib.params
    np.testing.assert_allclose(got[:4], GT_PARAMS[:4], rtol=0.02)
    assert abs(abs(got[4]) - GT_PARAMS[4]) < 0.01, got
