"""The bfloat16 frontend configuration (``FrontendConfig.atlas_bf16``,
``TrackerConfig.zmssd_bf16_cross``): the PyTorch port against the JAX
package on the same seeded inputs.

Bars:

- the frame builds' bfloat16 atlases equal JAX's bit for bit (the eager
  JAX build, whose float32 atlas equals the port's; the cast rounds both
  alike), and K2's plain version gives exact float32 windows of them;
- ``ssd_search(bf16_cross=True)`` on a bfloat16 atlas against JAX's
  compiled search (as its tracker runs it): the same best positions and
  found flags, ZMSSD within ``SSD_ATOL`` (both sum the exact float32
  products of the bfloat16-rounded templates and windows in one order;
  the integral sums of the other terms, up to 64 * 255^2 ~ 4.2e6, run in
  another order, an ulp there is 0.25-0.5). JAX's op-by-op search rounds
  each product to bfloat16 as well and parts from its compiled one by
  ~1.2e3; the test checks that it does;
- ``track_frame_from_image`` with both flags, on tests/test_torch_tracker.py's
  scene with a bfloat16 keyframe atlas: that file's bars (the same found
  set up to float-noise differences, at most 1%; pose within 1e-5);
- ``SLAMEngine.process_frame`` with both flags on tests/test_slam_e2e.py's
  orbit at its pace (0.05 rad a frame; tests/test_torch_engine.py's
  engine and draws) over 34 frames: stereo init on frame 6, tracking, a
  keyframe on frame 27 whose integration adds points: the same stage,
  quality, ``added_kf``, keyframe and point counts on every frame, and
  found counts within ``FOUND_RTOL`` of JAX's (the tracker's 1% bar
  above; measured: equal on 32 of 34 frames, one point apart on two. A
  bf16 atlas holds the values 128-255 as even integers only, so equal
  ZMSSD between two candidates is common there, and float noise in the
  integral sums picks between them); the keyframe atlases bit for bit;
- checkpoints: a JAX-written map with a bfloat16 atlas (``|V2`` elements
  in the npz) loads into the port bit for bit, and the port writes the
  same bytes under the same dtype; a map round-trips through the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.config import FrontendConfig, TrackerConfig
from ptam_cg_tpu.io import checkpoint as jcheckpoint
from ptam_cg_tpu.models import engine as jengine
from ptam_cg_tpu.models import keyframe, map_state, tracker
from ptam_cg_tpu.ops import patch as jpatch
from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import checkpoint as tcheckpoint
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.kernels import gather as tgather
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.models import keyframe as tkeyframe
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import tracker as ttracker
from ptam_cg_tpu_torch.ops import patch as tpatch

import test_torch_engine as te
import test_torch_tracker as tt
from test_torch_tracker import scene  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SSD_ATOL = 1.0
ENGINE_FRAMES = 34
ENGINE_SWEEP = 1.7      # 0.05 rad a frame, test_slam_e2e.py's pace
FOUND_RTOL = 0.01


def _bits(a) -> np.ndarray:
    """The raw 16 bits of a bfloat16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.fixture(scope="module")
def frame():
    seq = tsynth.SyntheticSequence(tt.REF_PARAMS, image_size=tt.SIZE,
                                   n_frames=3, seed=7, height=1.5,
                                   radius=0.2, sweep=0.6, device="cpu")
    return seq.frame(1).numpy()


def test_frame_builds_store_jax_bf16_atlases(frame):
    fcfg = FrontendConfig(atlas_bf16=True)
    tcfg = tconfig.FrontendConfig(atlas_bf16=True)
    im = torch.from_numpy(frame)
    for jbuild, tbuild in ((keyframe.build_frame, tkeyframe.build_frame),
                           (keyframe.build_frame_tracking,
                            tkeyframe.build_frame_tracking)):
        ref = jbuild(jnp.asarray(frame), fcfg)
        got = tbuild(im, tcfg)
        assert ref.atlas.dtype == jnp.bfloat16
        assert got.atlas.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got.atlas), _bits(ref.atlas))
        np.testing.assert_array_equal(got.corner_mask.numpy(),
                                      np.asarray(ref.corner_mask))
    # The f32 build's atlas rounds to the same bits; K2's plain version
    # reads it back as exact float32 windows.
    f32 = tkeyframe.build_frame_tracking(im)
    assert torch.equal(f32.atlas.to(torch.bfloat16), got.atlas)
    oy = torch.tensor([0, 17, 300, 359])
    ox = torch.tensor([5, 0, 100, 312])
    win = tgather.gather_windows(got.atlas, oy, ox, 8)
    assert win.dtype == torch.float32
    assert torch.equal(win.to(torch.bfloat16).to(torch.float32), win)
    assert torch.equal(win, tgather.gather_windows(
        got.atlas.to(torch.float32), oy, ox, 8))


def _search_inputs(seed, N=64, r_win=6):
    """An integer-valued 120x160 atlas with corners, templates of
    fractional values near the windows, and centres inside the image."""
    rng = np.random.default_rng(seed)
    H, W = 120, 160
    atlas = np.round(rng.uniform(0, 255, (H, W))).astype(np.float32)
    mask = rng.uniform(size=(H, W)) < 0.3
    cx = rng.uniform(20, W - 20, N).astype(np.float32)
    cy = rng.uniform(20, H - 20, N).astype(np.float32)
    ix, iy = np.round(cx).astype(int), np.round(cy).astype(int)
    tmpl = np.stack([atlas[y - 4:y + 4, x - 4:x + 4] for x, y in zip(ix, iy)])
    tmpl = (tmpl + rng.normal(0, 3.0, tmpl.shape)).astype(np.float32)
    centers = np.stack([cx + rng.uniform(-2, 2, N),
                        cy + rng.uniform(-2, 2, N)], -1).astype(np.float32)
    radius = np.full(N, float(r_win - 1), np.float32)
    bounds = np.tile(np.array([0, 0, W, H], np.float32), (N, 1))
    return atlas, mask, tmpl, centers, radius, bounds


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_search_bf16_cross_matches_jax(seed):
    atlas, mask, tmpl, centers, radius, bounds = _search_inputs(seed)
    kw = dict(r_win=6, max_ssd=8 * 8 * 500.0)
    args = (jnp.asarray(atlas, jnp.bfloat16), jnp.asarray(mask),
            jnp.asarray(tmpl), jnp.asarray(centers), jnp.asarray(radius),
            jnp.asarray(bounds))
    ref = jax.jit(lambda *a: jpatch.ssd_search(*a, bf16_cross=True, **kw))(
        *args)
    eager = jpatch.ssd_search(*args, bf16_cross=True, **kw)
    got, _, _ = tpatch.ssd_search(
        torch.from_numpy(atlas).to(torch.bfloat16), torch.from_numpy(mask),
        torch.from_numpy(tmpl), torch.from_numpy(centers),
        torch.from_numpy(radius), torch.from_numpy(bounds), bf16_cross=True,
        **kw)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    ok = np.asarray(ref.found)
    np.testing.assert_allclose(got.ssd.numpy()[ok], np.asarray(ref.ssd)[ok],
                               rtol=0, atol=SSD_ATOL)
    assert ok.sum() > 10
    assert np.abs(np.asarray(eager.ssd) - np.asarray(ref.ssd))[ok].max() > 100
    # The bf16 products move the scores off the float32 search's.
    plain, _, _ = tpatch.ssd_search(
        torch.from_numpy(atlas), torch.from_numpy(mask),
        torch.from_numpy(tmpl), torch.from_numpy(centers),
        torch.from_numpy(radius), torch.from_numpy(bounds), **kw)
    assert not torch.equal(plain.ssd, got.ssd)


@pytest.fixture(scope="module")
def bf16_scene(scene):  # noqa: F811
    """tests/test_torch_tracker.py's scene, with its keyframe atlas stored
    in bfloat16 as ``atlas_bf16`` stores it."""
    base = scene
    m = base["m"]._replace(kf_atlas=base["m"].kf_atlas.astype(jnp.bfloat16))
    return dict(base, m=m,
                tm=fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"))


def test_track_frame_from_image_with_both_flags_matches_jax(bf16_scene):
    scene = bf16_scene
    seq, cam, m, ff0 = scene["seq"], scene["cam"], scene["m"], scene["ff0"]
    assert scene["tm"].kf_atlas.dtype == torch.bfloat16
    P = m.point_pos.shape[0]
    im = seq.frame(1)
    cam_params = jnp.asarray(tt.REF_PARAMS, jnp.float32)
    state = tracker.init_tracker_state(seq.pose(0), seed=5)
    jcfg, jf = TrackerConfig(zmssd_bf16_cross=True), \
        FrontendConfig(atlas_bf16=True)
    jout = jax.jit(lambda s, m_, im_, ps: tracker.track_frame_from_image(
        s, m_, im_, ps, cam, tt.SIZE, cam_params, jcfg, jf))(
        state, m, im, ff0.sbi_track)
    _, k_frame = jax.random.split(state.key)
    rc, rf = tt._uniforms(k_frame, P)
    tout = ttracker.track_frame_from_image(
        fj.tracker_state_from_numpy(fj.as_numpy_tree(state), "cpu"),
        scene["tm"], fj.tensor(im, "cpu"),
        fj.sbi_from_numpy(fj.as_numpy_tree(ff0.sbi_track), "cpu"),
        scene["tcam"], tt.SIZE, torch.tensor(tt.REF_PARAMS),
        tconfig.TrackerConfig(zmssd_bf16_cross=True),
        tconfig.FrontendConfig(atlas_bf16=True), rand_coarse=rc,
        rand_fine=rf)
    assert int(np.asarray(jout.result.meas_valid).sum()) > 100
    tt._assert_same_tracking(jout.result, tout.result)
    assert int(tout.state.quality) == int(jout.state.quality)


def _bf16_cfgs():
    j, t = te._jcfg(), te._tcfg()
    return (dataclasses.replace(
        j, frontend=dataclasses.replace(j.frontend, atlas_bf16=True),
        tracker=dataclasses.replace(j.tracker, zmssd_bf16_cross=True)),
        dataclasses.replace(
        t, frontend=dataclasses.replace(t.frontend, atlas_bf16=True),
        tracker=dataclasses.replace(t.tracker, zmssd_bf16_cross=True)))


def _outcome(i):
    return (i.stage, int(i.quality), bool(i.added_kf), int(i.n_kfs),
            int(i.n_points))


def test_engine_with_both_flags_matches_jax():
    """Init on frame 6, then tracking and a keyframe integration."""
    seq = te.synth.SyntheticSequence(te.REF_PARAMS, image_size=te.SIZE,
                                     n_frames=ENGINE_FRAMES, seed=5,
                                     height=1.5, radius=0.35,
                                     sweep=ENGINE_SWEEP)
    frames = [np.clip(np.round(np.asarray(seq.frame(i))), 0, 255).astype(
        np.uint8) for i in range(ENGINE_FRAMES)]
    jcfg, tcfg = _bf16_cfgs()
    jeng = jengine.SLAMEngine(jcfg, image_size=te.SIZE, max_points=te.P,
                              max_kfs=te.K, auto_init_frames=6, seed=0,
                              deterministic=True)
    teng = tengine.SLAMEngine(tcfg, image_size=te.SIZE, max_points=te.P,
                              max_kfs=te.K, auto_init_frames=6, seed=0,
                              deterministic=True, device="cpu",
                              draws=te.JaxDraws())
    jinfo = [jeng.process_frame(im) for im in frames]
    tinfo = [teng.process_frame(im) for im in frames]
    want, got = [_outcome(i) for i in jinfo], [_outcome(i) for i in tinfo]
    assert got == want
    found = [(k, int(a.n_found), int(b.n_found))
             for k, (a, b) in enumerate(zip(jinfo, tinfo))
             if abs(int(a.n_found) - int(b.n_found))
             > FOUND_RTOL * int(a.n_found)]
    assert not found, found
    assert teng.map.kf_atlas.dtype == torch.bfloat16
    assert jeng.map.kf_atlas.dtype == jnp.bfloat16
    assert want[6][0] == "TRACKING" and want[-1][0] == "TRACKING"
    assert any(o[2] for o in want[7:]), "no keyframe after init"
    assert want[-1][4] > want[7][4], "no integration added a point"
    n = int(np.asarray(jeng.map.kf_valid).sum())
    np.testing.assert_array_equal(_bits(teng.map.kf_atlas[:n]),
                                  _bits(jeng.map.kf_atlas[:n]))


def test_bf16_checkpoints_both_ways(tmp_path, frame):
    jm = map_state.empty_map(tt.SIZE, max_points=64, max_kfs=2,
                             atlas_dtype=jnp.bfloat16)
    ff = keyframe.build_frame(jnp.asarray(frame),
                              FrontendConfig(atlas_bf16=True))
    jm = map_state.insert_keyframe(jm, 1, ff, tracker.init_tracker_state(
        ).pose)
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_map(jpath, jm)
    assert np.load(jpath)["map.kf_atlas"].dtype.str == "|V2"
    # JAX cannot read its own bf16-atlas checkpoint (ROADMAP §3).
    with pytest.raises(TypeError):
        jcheckpoint.load_map(jpath)
    tm, _ = tcheckpoint.load_map(jpath, device="cpu")
    assert tm.kf_atlas.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tm.kf_atlas), _bits(jm.kf_atlas))
    tpath = str(tmp_path / "port.npz")
    tcheckpoint.save_map(tpath, tm)
    a, b = np.load(tpath)["map.kf_atlas"], np.load(jpath)["map.kf_atlas"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back, _ = tcheckpoint.load_map(tpath, device="cpu")
    for f in dataclasses.fields(tms.MapState):
        assert torch.equal(getattr(back, f.name), getattr(tm, f.name)), f
    # from_jax takes the ml_dtypes array of a JAX bf16 tensor as it is.
    assert torch.equal(fj.tensor(np.asarray(jm.kf_atlas), "cpu"),
                       tm.kf_atlas)
    assert tms.empty_map(tt.SIZE, 64, 2, "cpu", torch.bfloat16
                         ).kf_atlas.dtype == torch.bfloat16
    assert tms.copy_map(tm).kf_atlas.dtype == torch.bfloat16
