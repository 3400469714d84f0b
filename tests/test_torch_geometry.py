"""The rest of the geometry, the image ops and the synthetic scenes: the
PyTorch port against the JAX package on the same seeded numpy inputs.

- ``utils/geometry.py``: ``triangulate_new`` and ``triangulate_depths``
  (points within a relative 1e-4: JAX's ``eigh`` and the port's Jacobi
  null vectors of the same float32 systems), ``umeyama_icp`` and
  ``horn_icp`` (R and t within 1e-5, with and without a mask; the port's
  SVD and eigen-solves are ``svd3`` and ``sym_eigh``), ``sampson_error``
  (within 1e-4 of the largest: the epipolar residual cancels in float32).
- ``ops/image.py``: ``patch_offsets`` and ``extract_patch`` exactly
  (inside, at and past the border), ``affine_warp_sample`` within 1e-4.
- ``io/synth.py``: ``default_blocks`` exactly (the same numpy draws);
  ``loop_trajectory`` and ``interp_pose`` within 1e-5; ``render_scene``,
  ``render_motion`` (blur, rolling shutter, both) and the
  ``SyntheticSequence`` options on JAX's texture: the median pixel within
  1e-3 and 99% within 1 grey level (rays are unprojected in float32 by
  each package, which moves the few pixels on a block's edge);
  ``hostile_transform`` fed JAX's normal draws within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.camera import atan as jatan
from ptam_cg_tpu.io import synth as jsynth
from ptam_cg_tpu.ops import image as jimage
from ptam_cg_tpu.utils import geometry as jgeo
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu.utils.se3 import SE3 as JSE3
from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.ops import image as timage
from ptam_cg_tpu_torch.utils import geometry as tgeo
from ptam_cg_tpu_torch.utils import se3 as tse3
from ptam_cg_tpu_torch.utils.se3 import SE3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (160, 120)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pose(rng, n=None, rot=0.2, trans=0.5):
    shape = (6,) if n is None else (n, 6)
    xi = np.concatenate([rng.uniform(-trans, trans, shape[:-1] + (3,)),
                         rng.uniform(-rot, rot, shape[:-1] + (3,))], -1)
    xi = xi.astype(np.float32)
    return (jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(_t(xi)))


def _two_views(rng, n=200):
    """Points in front of two cameras a baseline apart: (T_a_from_b as
    both packages', v2a, v2b) with the observations as float32 numpy."""
    pts_b = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)).astype(np.float32)
    jT, tT = _pose(rng, rot=0.1, trans=0.4)
    pts_a = np.asarray(jse3.apply(jT, jnp.asarray(pts_b)))
    v2a = (pts_a[:, :2] / pts_a[:, 2:]).astype(np.float32)
    v2b = (pts_b[:, :2] / pts_b[:, 2:]).astype(np.float32)
    return jT, tT, v2a, v2b, pts_b


def test_triangulate_new_and_depths_match_jax():
    jT, tT, v2a, v2b, pts_b = _two_views(np.random.default_rng(0))
    want = np.asarray(jgeo.triangulate_new(jT, jnp.asarray(v2a),
                                           jnp.asarray(v2b)))
    got = tgeo.triangulate_new(tT, _t(v2a), _t(v2b)).numpy()
    rel = np.abs(got - want).max(-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() < 1e-4, rel.max()
    assert np.abs(got - pts_b).max() < 1e-2
    jw = jgeo.triangulate_depths(jT, jnp.asarray(v2a), jnp.asarray(v2b))
    tw = tgeo.triangulate_depths(tT, _t(v2a), _t(v2b))
    for g, w in zip(tw, jw):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < 1e-4


@pytest.mark.parametrize("fn", ["umeyama_icp", "horn_icp"])
@pytest.mark.parametrize("masked", [False, True])
def test_icp_matches_jax(fn, masked):
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    jT, tT = _pose(rng, rot=0.6, trans=1.0)
    dst = np.asarray(jse3.apply(jT, jnp.asarray(src)))
    dst = (dst + rng.normal(0, 1e-3, dst.shape)).astype(np.float32)
    mask = rng.uniform(size=64) > 0.3
    if masked:
        dst[~mask] += 5.0      # outliers the mask removes
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = getattr(jgeo, fn)(jnp.asarray(src), jnp.asarray(dst), jm)
    got = getattr(tgeo, fn)(_t(src), _t(dst), tm)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-5)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(jT.R), atol=5e-3)


def test_batched_icp_matches_jax_per_item():
    """The port batches (the JAX functions' centring broadcasts only
    unbatched points, so JAX solves each item alone here)."""
    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (4, 32, 3)).astype(np.float32)
    jT, tT = _pose(rng, 4, rot=0.5)
    dst = np.asarray(jnp.einsum("bij,bnj->bni", jT.R, jnp.asarray(src))
                     + jT.t[:, None])
    for fn in ("umeyama_icp", "horn_icp"):
        got = getattr(tgeo, fn)(_t(src), _t(dst))
        for b in range(4):
            want = getattr(jgeo, fn)(jnp.asarray(src[b]), jnp.asarray(dst[b]))
            np.testing.assert_allclose(got.R[b].numpy(), np.asarray(want.R),
                                       atol=1e-5)
            np.testing.assert_allclose(got.t[b].numpy(), np.asarray(want.t),
                                       atol=1e-5)


def test_sampson_error_matches_jax():
    jT, tT, v2a, v2b, _ = _two_views(np.random.default_rng(3))
    E = np.asarray(jse3.hat(jT.t) @ jT.R).astype(np.float32)
    noisy = v2a + np.random.default_rng(4).normal(0, 1e-3, v2a.shape).astype(
        np.float32)
    want = np.asarray(jgeo.sampson_error(jnp.asarray(E), jnp.asarray(noisy),
                                         jnp.asarray(v2b)))
    got = tgeo.sampson_error(_t(E), _t(noisy), _t(v2b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.max())
    assert want.max() > 1e-8


def test_image_ops_match_jax():
    rng = np.random.default_rng(5)
    im = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    for size in (8, 9):
        np.testing.assert_array_equal(timage.patch_offsets(size, "cpu"),
                                      np.asarray(jimage.patch_offsets(size)))
        for c in ([20.0, 15.0], [3.7, 4.2], [48.9, 30.0], [25.0, 39.5],
                  [-2.0, 5.0]):
            wp, wv = jimage.extract_patch(jnp.asarray(im), jnp.asarray(c),
                                          size, -1.0)
            gp, gv = timage.extract_patch(torch.from_numpy(im), _t(c), size,
                                          -1.0)
            assert bool(gv) == bool(wv)
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    offs = np.asarray(jimage.patch_offsets(8))
    A = np.array([[1.1, 0.2], [-0.15, 0.9]], np.float32)
    for c in ([20.3, 15.6], [2.5, 3.0]):
        wv, wm = jimage.affine_warp_sample(jnp.asarray(im), jnp.asarray(c),
                                           jnp.asarray(A), jnp.asarray(offs))
        gv, gm = timage.affine_warp_sample(torch.from_numpy(im), _t(c), _t(A),
                                           _t(offs))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4)


def test_blocks_trajectories_and_interpolation_match_jax():
    np.testing.assert_array_equal(
        tsynth.default_blocks(2, 4, device="cpu").numpy(),
        np.asarray(jsynth.default_blocks(2, 4)))
    jl = jsynth.loop_trajectory(30, 1.5, 0.8)
    tl = tsynth.loop_trajectory(30, 1.5, 0.8, device="cpu")
    np.testing.assert_allclose(tl.R.numpy(), np.asarray(jl.R), atol=1e-5)
    np.testing.assert_allclose(tl.t.numpy(), np.asarray(jl.t), atol=1e-5)
    np.testing.assert_allclose(tl.t[-1].numpy(), tl.t[0].numpy(), atol=1e-5)
    delta = np.array([0.02, -0.01, 0.03, 0.01, 0.02, -0.015], np.float32)
    T0 = JSE3(jl.R[3], jl.t[3])
    for alpha in (0.3, np.linspace(0, 1, 7, dtype=np.float32)):
        want = jsynth.interp_pose(T0, jnp.asarray(delta), jnp.asarray(alpha))
        got = tsynth.interp_pose(SE3(tl.R[3], tl.t[3]), _t(delta),
                                 _t(alpha))
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R),
                                   atol=1e-5)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   atol=1e-5)


def _close_images(got, want):
    d = np.abs(got.numpy() - np.asarray(want))
    assert np.median(d) < 1e-3, np.median(d)
    assert np.percentile(d, 99) < 1.0, np.percentile(d, 99)


@pytest.fixture(scope="module")
def scene():
    tex = jsynth.make_texture(jax.random.PRNGKey(3))
    jcam = jatan.make_camera(REF_PARAMS, SIZE)
    tcam = tatan.make_camera(REF_PARAMS, SIZE, "cpu")
    poses = jsynth.orbit_trajectory(10, 1.5, 0.35, 1.3)
    return tex, jcam, tcam, poses


def test_render_scene_and_motion_match_jax(scene):
    tex, jcam, tcam, poses = scene
    ttex = _t(tex)
    jboxes = jsynth.default_blocks(2, 4)
    tboxes = tsynth.default_blocks(2, 4, device="cpu")
    T0 = JSE3(poses.R[2], poses.t[2])
    tT0 = SE3(_t(poses.R[2]), _t(poses.t[2]))
    _close_images(tsynth.render_scene(tcam, tT0, ttex, SIZE, tboxes),
                  jsynth.render_scene(jcam, T0, tex, SIZE, jboxes))
    delta = jse3.se3_log(jse3.mul(JSE3(poses.R[3], poses.t[3]),
                                  jse3.inv(T0)))
    for boxes, n_blur, rs in ((None, 3, 0.0), (None, 0, 0.7),
                              ("boxes", 2, 0.5)):
        want = jsynth.render_motion(jcam, T0, delta, tex, SIZE,
                                    None if boxes is None else jboxes,
                                    256.0, n_blur, rs, 0.5)
        got = tsynth.render_motion(tcam, tT0, _t(delta), ttex, SIZE,
                                   None if boxes is None else tboxes,
                                   256.0, n_blur, rs, 0.5)
        _close_images(got, want)


def test_hostile_transform_matches_jax_on_its_draws():
    rng = np.random.default_rng(6)
    im = rng.uniform(0, 255, (SIZE[1], SIZE[0])).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jsynth.hostile_transform(jnp.asarray(im), 11, key)
    noise = np.asarray(jax.random.normal(key, im.shape))
    got = tsynth.hostile_transform(torch.from_numpy(im), 11, _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("opts", [
    dict(boxes=True), dict(trajectory="loop", radius=0.8),
    dict(motion_blur=2, rolling_shutter=0.5),
    dict(boxes=True, motion_blur=2)])
def test_synthetic_sequence_options_match_jax(opts, scene):
    """The port's sequence given JAX's texture renders JAX's frames (the
    last frame of a moving sequence has no motion in both)."""
    tex = scene[0]
    opts = dict(opts)
    jb = jsynth.default_blocks(2, 4) if opts.pop("boxes", False) else None
    kw = dict(image_size=SIZE, n_frames=6, seed=5, height=1.5, sweep=1.3)
    kw.setdefault("radius", 0.35)
    kw.update(opts)
    jseq = jsynth.SyntheticSequence(REF_PARAMS, boxes=jb, **kw)
    jseq.texture = tex      # the JAX renderer reads it at each call
    tseq = tsynth.SyntheticSequence(
        REF_PARAMS, boxes=None if jb is None else np.array(jb),
        device="cpu", **kw)
    tseq.texture = _t(tex)
    for i in (0, 5):
        _close_images(tseq.frame(i), jseq.frame(i))
        np.testing.assert_allclose(tseq.pose(i).t.numpy(),
                                   np.asarray(jseq.pose(i).t), atol=1e-5)


def test_hostile_sequence_is_deterministic_per_frame():
    kw = dict(image_size=SIZE, n_frames=4, seed=3, device="cpu")
    a = tsynth.SyntheticSequence(REF_PARAMS, hostile=True, **kw)
    b = tsynth.SyntheticSequence(REF_PARAMS, hostile=True, **kw)
    clean = tsynth.SyntheticSequence(REF_PARAMS, **kw)
    assert torch.equal(a.frame(2), b.frame(2))
    noise = np.random.default_rng(3 * 100003 + 2).standard_normal(
        (SIZE[1], SIZE[0])).astype(np.float32)
    want = tsynth.hostile_transform(clean.frame(2), 2, torch.from_numpy(noise))
    assert torch.equal(a.frame(2), want)
