"""Trail tracking, stereo init and the MapMaker parts init uses: the
PyTorch port against the JAX package.

The scene is tests/test_slam_e2e.py's (320x240, seed 5, height 1.5,
radius 0.35, sweep 1.3), rendered by the JAX synth; the same frames, as
numpy, go through both packages' ``build_frame`` (candidate threshold 70,
the e2e's), then ``trail_start`` (at most ``MAX_TRAILS`` trails) and six
frames of ``trail_advance``. ``init_from_stereo`` then runs in both
packages from JAX's trails on frames 0 and 6, with maps of 1024 point and
8 keyframe slots and MapMakers seeded 0; the port is fed JAX's draws:
the MLESAC uniforms ``jax.random.uniform(key, (300, 1024))`` and the plane
aligner's, ``jax.random.uniform(k, (100, 1024))`` with ``k`` the JAX
MapMaker's first ``_next_key()``.

Bars:

- patch cuts and trails: exact (the good set and every position; the
  plain SSD of the same windows is summed in the same order);
- init: both succeed; the same point-valid set and measurement mask, up
  to 1% (decided by float32 bundle adjustment; none differ here). Only
  keyframe 0 is fixed, so the map's scale is free and float32 BA runs
  that sum in another order drift along it (the test prints how far):
  so translations and points are compared after dividing by |t| of keyframe
  1: its rotation and translation within 1e-4, points within 5e-3 at the
  99th percentile (chip_smoke.py phase 8's bar); ``wiggle_depth_norm``,
  which scales as 1/scale, times |t| within a relative 1e-4;
- plane aligner and global transform (tests/test_mapmaker_units.py's
  cases): the same R, t within 1e-5 from the same uniforms; the map
  moved by it within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.config import InitConfig
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import initializer as jinit
from ptam_cg_tpu.models import keyframe as jkf
from ptam_cg_tpu.models import map_state as jms
from ptam_cg_tpu.models import mapmaker as jmapmaker
from ptam_cg_tpu.ops import patch as jpatch
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.models import initializer as tinit
from ptam_cg_tpu_torch.models import keyframe as tkf
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
from ptam_cg_tpu_torch.ops import patch as tpatch
from ptam_cg_tpu_torch.utils.se3 import SE3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
N_TRAIL_FRAMES = 6
MAX_TRAILS = 256
P, K = 1024, 8
CAND_MIN = 70.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=26,
                                  seed=5, height=1.5, radius=0.35, sweep=1.3)
    ims = [np.array(seq.frame(i)) for i in range(N_TRAIL_FRAMES + 1)]
    build = jax.jit(lambda x: jkf.build_frame(x,
                                              candidate_min_score=CAND_MIN))
    jff = [build(jnp.asarray(im)) for im in ims]
    # Both packages track trails on the same features (the port's own
    # build is held to JAX's in test_own_build_matches_jax).
    tff = [fj.frame_features_from_numpy(fj.as_numpy_tree(f), "cpu")
           for f in jff]
    advance = jax.jit(lambda tr, a, b: jinit.trail_advance(tr, a, b, SIZE))
    jtr = [jinit.trail_start(jff[0], SIZE, MAX_TRAILS)]
    ttr = [tinit.trail_start(tff[0], SIZE, MAX_TRAILS)]
    for i in range(1, N_TRAIL_FRAMES + 1):
        jtr.append(advance(jtr[-1], jff[i - 1], jff[i])[0])
        ttr.append(tinit.trail_advance(ttr[-1], tff[i - 1], tff[i], SIZE)[0])
    return dict(seq=seq, ims=ims, jff=jff, tff=tff, jtr=jtr, ttr=ttr,
                tcam=fj.camera_from_numpy(fj.as_numpy_tree(seq.cam), "cpu"))


@pytest.fixture(scope="module")
def inits(scene):
    """Both packages' stereo init from JAX's trails on frames 0 and 6."""
    jff, tff, trails = scene["jff"], scene["tff"], scene["jtr"][-1]
    key = jax.random.PRNGKey(0)
    jmk = jmapmaker.MapMaker(jms.empty_map(SIZE, max_points=P, max_kfs=K),
                             scene["seq"].cam, SIZE, seed=0)
    _, plane_key = jax.random.split(jax.random.PRNGKey(0))
    u_mlesac = np.array(jax.random.uniform(key, (300, P)))
    u_plane = np.array(jax.random.uniform(plane_key, (100, P)))
    jpose = jinit.init_from_stereo(jmk, jff[0], jff[-1], trails, key,
                                   InitConfig())
    tmk = tmapmaker.MapMaker(
        tms.empty_map(SIZE, max_points=P, max_kfs=K, device="cpu"),
        scene["tcam"], SIZE, seed=0)
    stats = {}
    tpose = tinit.init_from_stereo(
        tmk, tff[0], tff[-1], fj.trail_state_from_numpy(
            fj.as_numpy_tree(trails), "cpu"),
        torch.from_numpy(u_mlesac), torch.from_numpy(u_plane), stats=stats)
    return dict(jmk=jmk, jpose=jpose, tmk=tmk, tpose=tpose, stats=stats)


def test_own_build_matches_jax(scene):
    """The port's ``build_frame`` of the same image gives JAX's level 0
    and corner mask. The half-sampled levels of a rendered (non-integer)
    image round an ulp apart here and there, which moves a few Shi-Tomasi
    candidates of near-equal score: the level-0 candidate sets (where
    trails start) still agree to 1%."""
    for i in (0, N_TRAIL_FRAMES):
        jf = scene["jff"][i]
        tf = tkf.build_frame(torch.from_numpy(scene["ims"][i]),
                             candidate_min_score=CAND_MIN)
        np.testing.assert_array_equal(tf.corner_mask.numpy(),
                                      _np(jf.corner_mask))
        np.testing.assert_array_equal(tf.atlas[:SIZE[1]].numpy(),
                                      _np(jf.atlas)[:SIZE[1]])
        np.testing.assert_allclose(tf.atlas.numpy(), _np(jf.atlas), rtol=0,
                                   atol=1e-4)
        cands = [set(map(tuple, _np(f.cand_xy)[0][_np(f.cand_valid)[0]]))
                 for f in (tf, jf)]
        assert len(cands[0] ^ cands[1]) <= 0.01 * len(cands[1])


@pytest.mark.parametrize("size", [9, 8])
def test_extract_patches_matches_jax(scene, size):
    atlas = scene["jff"][0].atlas
    Ha, Wa = atlas.shape
    rng = np.random.default_rng(size)
    pos = np.concatenate([
        rng.uniform(0, [Wa, Ha], (200, 2)),
        [[0.5, 0.5], [3.9, 4.0], [4.0, 4.0], [Wa - 4.2, 10.0],
         [Wa - 5.0, Ha - 5.0], [Wa - 0.5, Ha - 0.5]]]).astype(np.float32)
    jp, jok = jinit._extract_patches(atlas, jnp.asarray(pos), size)
    tp, tok = tinit._extract_patches(scene["tff"][0].atlas,
                                     torch.from_numpy(pos), size)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < len(pos)


def test_trails_match_jax(scene):
    counts = []
    for i, (jt, tt) in enumerate(zip(scene["jtr"], scene["ttr"])):
        for f in ("valid", "cur_pos", "init_pos", "patch"):
            np.testing.assert_array_equal(_np(getattr(tt, f)),
                                          _np(getattr(jt, f)),
                                          err_msg=f"frame {i}: {f}")
        counts.append(int(tt.valid.sum()))
    # Trails survive and move: the scene moves ~3 px a frame at level 0.
    assert counts[-1] > 0.8 * counts[0] > 100, counts
    moved = scene["ttr"][-1].cur_pos - scene["ttr"][-1].init_pos
    assert float(moved.abs().max()) > 5.0


def test_trails_to_matches_match_jax(scene):
    jm = jinit.trails_to_matches(scene["jtr"][-1], scene["seq"].cam, 300)
    tm = tinit.trails_to_matches(scene["ttr"][-1], scene["tcam"], 300)
    ref = fj.as_numpy_tree(jm)
    np.testing.assert_array_equal(tm.valid.numpy(), ref["valid"])
    for f in ("first", "second", "pixel_jac"):
        # ATAN's float32 rounding: the jacobian's entries are ~350.
        np.testing.assert_allclose(getattr(tm, f).numpy(), ref[f], rtol=1e-5,
                                   atol=1e-4, err_msg=f)


def test_init_from_stereo_matches_jax(inits):
    jmk, tmk = inits["jmk"], inits["tmk"]
    assert inits["jpose"] is not None and inits["tpose"] is not None
    assert inits["stats"]["n_ba"] >= 6
    ref = fj.as_numpy_tree(jmk.map)
    tm = tmk.map
    n_pts = int(ref["point_valid"].sum())
    for f in ("point_valid", "meas_valid"):
        n_diff = int(np.sum(tm.__dict__[f].numpy() != ref[f]))
        assert n_diff <= 0.01 * n_pts, (f, n_diff)
    assert n_pts > 0.8 * MAX_TRAILS
    np.testing.assert_array_equal(tm.kf_valid.numpy(), ref["kf_valid"])
    np.testing.assert_array_equal(tm.kf_fixed.numpy(), ref["kf_fixed"])
    assert tm.kf_valid[:2].all() and tmk.n_kfs() == 2 and tmk.good_host

    # The free scale: compare after dividing by |t| of keyframe 1.
    sj = np.linalg.norm(ref["kf_t"][1])
    st = float(torch.linalg.vector_norm(tm.kf_t[1]))
    print(f"init: scale (|t| of keyframe 1) port / JAX {st / sj:.6f}")
    assert abs(st / sj - 1.0) < 1e-2
    np.testing.assert_allclose(tm.kf_R[1].numpy(), ref["kf_R"][1], atol=1e-4)
    np.testing.assert_allclose(tm.kf_t[1].numpy() / st, ref["kf_t"][1] / sj,
                               atol=1e-4)
    both = ref["point_valid"] & tm.point_valid.numpy()
    d = np.abs(tm.point_pos.numpy()[both] / st
               - ref["point_pos"][both] / sj).max(axis=1)
    assert np.quantile(d, 0.99) <= 5e-3, np.quantile(d, 0.99)
    np.testing.assert_allclose(tmk.wiggle_depth_norm * st,
                               jmk.wiggle_depth_norm * sj, rtol=1e-4)
    # The returned pose is keyframe 1's.
    assert torch.equal(inits["tpose"].R, tm.kf_R[1])
    # The plane is z=0 after alignment.
    z = tm.point_pos[tm.point_valid, 2].abs() / st
    assert float(z.median()) < 0.02


def test_ssd_search_plain_ssd_matches_jax_exactly():
    """zero_mean=False on integer images: every sum is exact in float32,
    so the scores, positions and found flags equal JAX's."""
    rng = np.random.default_rng(4)
    atlas = rng.integers(0, 256, (96, 128)).astype(np.float32)
    mask = rng.uniform(size=atlas.shape) < 0.3
    N = 64
    centers = rng.uniform(12, [116, 84], (N, 2)).astype(np.float32)
    tmpl = rng.integers(0, 256, (N, 9, 9)).astype(np.float32)
    c = np.round(centers).astype(int)
    tmpl[:32] = np.stack([atlas[y - 4 + 2: y + 5 + 2, x - 4 - 1: x + 5 - 1]
                          for x, y in c[:32]])
    mask[c[:32, 1] + 2, c[:32, 0] - 1] = True
    radius = np.full(N, 10.0, np.float32)
    bounds = np.tile(np.array([0, 0, 128, 96], np.float32), (N, 1))
    args = (atlas, mask, tmpl, centers, radius, bounds)
    kw = dict(r_win=10, max_ssd=1e5, zero_mean=False, patch_size=9)
    j = jpatch.ssd_search(*map(jnp.asarray, args), **kw)
    t, _, _ = tpatch.ssd_search(*map(torch.from_numpy, args), **kw)
    np.testing.assert_array_equal(t.ssd.numpy(), np.asarray(j.ssd))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.found.numpy(), np.asarray(j.found))
    assert bool(t.found[:32].all()) and not bool(t.ssd[:32].any())


# ---------------------------------------------------------------------------
# Plane aligner and global transform (tests/test_mapmaker_units.py's cases)
# ---------------------------------------------------------------------------

UNIT_SIZE = (64, 64)


def _maps(Pn, **fields):
    tm = tms.empty_map(UNIT_SIZE, max_points=Pn, max_kfs=4, device="cpu")
    for name, value in fields.items():
        setattr(tm, name, torch.from_numpy(np.asarray(value)).to(
            getattr(tm, name).dtype))
    jm = jms.MapState(**{f.name: jnp.asarray(getattr(tm, f.name))
                         for f in dataclasses.fields(tm)})
    return jm, tm


def _tilted_plane(Pn=256, n=200):
    rng = np.random.default_rng(0)
    uv = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    normal = np.array([0.2, -0.1, 1.0])
    normal /= np.linalg.norm(normal)
    b1 = np.cross(normal, [1, 0, 0])
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(normal, b1)
    pts = (uv[:, :1] * b1 + uv[:, 1:] * b2
           + np.array([0.3, -0.2, 2.0])).astype(np.float32)
    pts[:20] += rng.uniform(0.5, 1.5, (20, 3)).astype(np.float32)
    pos = np.zeros((Pn, 3), np.float32)
    pos[:n] = pts
    return _maps(Pn, point_pos=pos, point_valid=np.arange(Pn) < n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_aligner_matches_jax(seed):
    jm, tm = _tilted_plane()
    key = jax.random.PRNGKey(seed)
    T = jmapmaker.plane_aligner(jm, key)
    u = np.array(jax.random.uniform(key, (100, 256)))
    tT = tmapmaker.plane_aligner(tm, torch.from_numpy(u))
    np.testing.assert_allclose(tT.R.numpy(), np.asarray(T.R), atol=1e-5)
    np.testing.assert_allclose(tT.t.numpy(), np.asarray(T.t), atol=1e-5)
    out = tmapmaker.apply_global_transform(tm, tT)
    z = out.point_pos[20:200, 2].numpy()
    assert np.median(np.abs(z)) < 0.03


def test_plane_aligner_too_few_points_identity():
    _, tm = _maps(128, point_valid=np.arange(128) < 5)
    T = tmapmaker.plane_aligner(tm, torch.rand(100, 128))
    assert torch.equal(T.R, torch.eye(3)) and not bool(T.t.any())


def test_apply_global_transform_matches_jax():
    """Poses compose with T^-1 while points move by T: the camera-frame
    coordinates of every point stay as they were."""
    rng = np.random.default_rng(2)
    Pn = 128
    pts = rng.normal(size=(Pn, 3)).astype(np.float32)
    pose = jse3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32)
                                    * 0.3))
    kf_R = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    kf_t = np.zeros((4, 3), np.float32)
    kf_R[0], kf_t[0] = np.asarray(pose.R), np.asarray(pose.t)
    jm, tm = _maps(Pn, point_pos=pts, point_valid=np.ones(Pn, bool),
                   kf_valid=np.arange(4) < 1, kf_R=kf_R, kf_t=kf_t)
    T = jse3.SE3(jse3.so3_exp(jnp.array([0.1, -0.2, 0.3])),
                 jnp.array([1.0, 2.0, -0.5]))
    jout = jmapmaker.apply_global_transform(jm, T)
    tout = tmapmaker.apply_global_transform(
        tm, SE3(torch.from_numpy(np.array(T.R)), torch.from_numpy(
            np.array(T.t))))
    ref = fj.as_numpy_tree(jout)
    for f in ("kf_R", "kf_t", "point_pos", "point_right_w", "point_down_w"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), ref[f],
                                   atol=1e-5, err_msg=f)
    before = pts @ kf_R[0].T + kf_t[0]
    after = tout.point_pos.numpy() @ tout.kf_R[0].numpy().T \
        + tout.kf_t[0].numpy()
    np.testing.assert_allclose(after, before, atol=2e-5)


def test_mapmaker_draws_from_its_seeded_generator():
    """Without uniforms, ``plane_align`` draws (plane_aligner_ransacs, P)
    from the MapMaker's generator, seeded by ``seed``."""
    _, tm = _tilted_plane()
    cam = fj.camera_from_numpy(fj.as_numpy_tree(
        synth.SyntheticSequence(REF_PARAMS, image_size=UNIT_SIZE,
                                n_frames=2).cam), "cpu")
    a = tmapmaker.MapMaker(tm, cam, UNIT_SIZE, seed=3)
    a.plane_align()
    u = torch.rand((100, 256), generator=torch.Generator().manual_seed(3))
    want = tmapmaker.apply_global_transform(
        tm, tmapmaker.plane_aligner(tm, u))
    assert torch.equal(a.map.point_pos, want.point_pos)
    assert a.wiggle_depth_norm == 1.0 and not a._new_points_pending
    assert not bool(a.new_point_mask.any())
