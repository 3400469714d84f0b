"""The engine's programs (``ptam_cg_tpu_torch/models/programs.py``): the
tracking program, the keyframe build and the relocalizer, which the card
replays as CUDA graphs and the CPU runs eagerly through the same static
buffers (each call's outputs copied into the first call's, as a replay
overwrites them).

On tests/test_slam_e2e.py's scene (320x240, seed 5, radius 0.35, sweep
1.3; frames rounded to uint8, as the engine is fed), rendered by the
JAX package, with a 512-point map of frame 0's FAST corners on the z=0
plane and keyframes 0 and 6. Bars:

- the tracking program against the JAX engine's ``_step_track``
  (ptam_cg_tpu/models/engine.py:186) on three chained frames with JAX's
  own uniforms: the info vector, the found set and the new inlier and
  outlier counts equal, the pose within tracker parity's 1e-5;
- ``track_frame_from_image`` on a ``TrackView`` equals the same call on
  the MapState bit for bit;
- the relocalizer at tests/test_torch_reloc.py's bars and the keyframe
  build at tests/test_torch_keyframe.py's;
- the plumbing: an in-place keyframe, a new ``wiggle_depth_norm`` and a
  new config reach the program; what the engine keeps past the next call
  is a copy; no host read or host-to-device copy inside a program (a
  CUDA graph could not capture it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.config import CameraConfig, EngineConfig, MapMakerConfig
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import engine as jengine
from ptam_cg_tpu.models import keyframe, map_state, relocalizer, tracker
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.models import keyframe as tkeyframe
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import programs
from ptam_cg_tpu_torch.models import tracker as ttracker
from ptam_cg_tpu_torch.utils import tree

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
P, K = 512, 4
CAND_MIN = 70.0
WIGGLE = 0.05
POSE_TOL = 1e-5
ST_RTOL, ST_ATOL = 2e-4, 0.5     # tests/test_torch_keyframe.py's


def _u8(im):
    return np.clip(np.round(np.asarray(im)), 0, 255).astype(np.uint8)


def _jax_map(seq, ffs):
    """Frame 0's FAST corners (up to 100 a level, 10 px inside it) on the
    z=0 plane, in a 4-keyframe map holding frames 0 and 6."""
    cam, pose0 = seq.cam, seq.pose(0)
    r = np.random.default_rng(0)
    ctr, lv = [], []
    for lev in range(4):
        mask = np.asarray(levelops.unpack_level(ffs[0].corner_mask, lev,
                                                SIZE[1], SIZE[0]))
        ys, xs = np.nonzero(mask[10:-10, 10:-10])
        pick = np.sort(r.choice(len(xs), min(100, len(xs)), replace=False))
        ctr.append(np.stack([xs[pick], ys[pick]], -1) + 10)
        lv.append(np.full(len(pick), lev))
    ctr = jnp.asarray(np.concatenate(ctr), jnp.float32)
    lv = jnp.asarray(np.concatenate(lv), jnp.int32)
    n = ctr.shape[0]
    z1 = atan.unproject(levelops.level_zero_pos(ctr, lv), cam)
    T_wc = se3lib.inv(pose0)
    dir_w = jnp.concatenate([z1, jnp.ones_like(z1[:, :1])], -1) @ T_wc.R.T
    pts = T_wc.t + (-T_wc.t[2] / dir_w[:, 2])[:, None] * dir_w
    m = map_state.empty_map(SIZE, max_points=P, max_kfs=K)
    for slot, (i, ff) in enumerate(zip((0, 6), ffs)):
        m = map_state.insert_keyframe(m, slot, ff, seq.pose(i), 1.5, 0.1)
    cpad = jnp.zeros((P, 2)).at[:n].set(ctr)
    lpad = jnp.zeros(P, jnp.int32).at[:n].set(lv)
    c_nc, r_nc, d_nc, nrm = map_state.make_point_rays(cpad, lpad, pose0, cam,
                                                      SIZE)
    m = m._replace(
        point_pos=jnp.zeros((P, 3)).at[:n].set(pts),
        point_valid=jnp.arange(P) < n, point_src_level=lpad,
        point_center=cpad, point_center_nc=c_nc, point_right_nc=r_nc,
        point_down_nc=d_nc, point_normal_nc=nrm,
        meas_valid=jnp.zeros((K, P), bool).at[0].set(jnp.arange(P) < n),
        good=jnp.asarray(True))
    return map_state.refresh_pixel_vectors(m)


def _tcfg(**kw):
    return tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(
            candidate_min_shi_tomasi_score=CAND_MIN), **kw)


@pytest.fixture(scope="module")
def scene():
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=26,
                                  seed=5, height=1.5, radius=0.35, sweep=1.3)
    frames = [_u8(seq.frame(i)) for i in range(8)]
    build = jax.jit(lambda x: keyframe.build_frame(
        x.astype(jnp.float32), candidate_min_score=CAND_MIN))
    ffs = [build(jnp.asarray(frames[i])) for i in (0, 6)]
    m = _jax_map(seq, ffs)
    tree_np = fj.as_numpy_tree
    return dict(
        seq=seq, frames=frames, ffs=ffs, m=m, build=build,
        tm=fj.map_state_from_numpy(tree_np(m), "cpu"),
        tcam=fj.camera_from_numpy(tree_np(seq.cam), "cpu"),
        tsbi0=fj.sbi_from_numpy(tree_np(ffs[0].sbi_track), "cpu"),
        tpose=lambda i: fj.se3_from_numpy(tree_np(seq.pose(i)), "cpu"))


def _track_program(scene, cfg=None, dtype=torch.uint8):
    return programs.TrackProgram(cfg or _tcfg(), SIZE, scene["tcam"],
                                 torch.tensor(REF_PARAMS), (P, K), dtype,
                                 device="cpu")


def _uniforms(key):
    k_coarse, k_fine = jax.random.split(key)
    return (fj.tensor(jax.random.uniform(k_coarse, (P,)), "cpu"),
            fj.tensor(jax.random.uniform(k_fine, (P,)), "cpu"))


def _found(res):
    point, valid = res.meas_point.numpy(), res.meas_valid.numpy()
    return sorted(point[valid].tolist())


def test_track_view_has_the_jax_fields_in_order(scene):
    assert ttracker.TrackView._fields == tracker.TrackView._fields
    view = ttracker.make_track_view(scene["tm"])
    assert all(getattr(scene["tm"], f) is t
               for f, t in zip(view._fields, view))


def test_tracking_on_a_view_equals_tracking_on_the_map(scene):
    tm = scene["tm"]
    gen = torch.Generator().manual_seed(1)
    rc, rf = torch.rand(P, generator=gen), torch.rand(P, generator=gen)
    state = ttracker.init_tracker_state(scene["tpose"](0), device="cpu")
    outs = [ttracker.track_frame_from_image(
        state, m, torch.from_numpy(scene["frames"][1]).float(),
        scene["tsbi0"], scene["tcam"], SIZE, torch.tensor(REF_PARAMS),
        rand_coarse=rc, rand_fine=rf)
        for m in (tm, ttracker.make_track_view(tm))]
    a, b = (list(tree.tensors(o)) for o in outs)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(outs[0].result.meas_valid.sum()) > 100


def test_track_program_matches_the_jax_engines_step(scene):
    """Frames 1..3 chained from frame 0's pose and SBI, the JAX engine's
    jitted ``_step_track`` against ``TrackProgram`` fed JAX's uniforms."""
    seq, m = scene["seq"], scene["m"]
    jeng = jengine.SLAMEngine(
        EngineConfig(camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
                     mapmaker=MapMakerConfig(
                         candidate_min_shi_tomasi_score=CAND_MIN)),
        image_size=SIZE, max_points=P, max_kfs=K, seed=0)
    jst = tracker.init_tracker_state(seq.pose(0), seed=5)
    jprev = scene["ffs"][0].sbi_track
    prog = _track_program(scene)
    tst = fj.tracker_state_from_numpy(fj.as_numpy_tree(jst), "cpu")
    tprev = scene["tsbi0"]
    for i in (1, 2, 3):
        _, k_frame = jax.random.split(jst.key)
        rc, rf = _uniforms(k_frame)
        jfo, jinl, joutl, jinfo = jeng._step_track(
            jst, tracker.make_track_view(m), jnp.asarray(scene["frames"][i]),
            jprev, jnp.float32(WIGGLE))
        fo, inl, outl, info = prog(tst, scene["tm"], scene["frames"][i],
                                   tprev, rc, rf, WIGGLE)
        np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo),
                                      err_msg=f"frame {i}")
        assert _found(fo.result) == sorted(
            np.asarray(jfo.result.meas_point)[
                np.asarray(jfo.result.meas_valid)].tolist()), i
        np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
        np.testing.assert_array_equal(outl.numpy(), np.asarray(joutl))
        np.testing.assert_allclose(fo.state.pose.R.numpy(),
                                   np.asarray(jfo.state.pose.R),
                                   atol=POSE_TOL)
        np.testing.assert_allclose(fo.state.pose.t.numpy(),
                                   np.asarray(jfo.state.pose.t),
                                   atol=POSE_TOL)
        assert int(info[0]) == tracker.QUALITY_GOOD and int(info[2]) > 100
        jst, jprev = jfo.state, jfo.sbi_track
        tst, tprev = fo.state, fo.sbi_track
    # The state and the SBI the program returns are its own input
    # buffers: the next call copies neither.
    assert fo.state.pose.R is prog.state.pose.R
    assert fo.sbi_track is prog.prev_sbi


def test_track_program_sees_an_in_place_keyframe_and_a_new_wiggle(scene):
    """The view is copied in on every call: a keyframe written into the
    map in place (``insert_keyframe``) between two calls reaches the
    second, as does a new ``wiggle_depth_norm``."""
    tm = tms.copy_map(scene["tm"])
    prog = _track_program(scene)
    rc, rf = torch.rand(P), torch.rand(P)
    start = ttracker.init_tracker_state(scene["tpose"](2), device="cpu")

    def need_kf(wiggle):
        # A copy of the start state each call: the program writes the
        # new state into its own buffers.
        st = tree.map_tensors(start, torch.Tensor.clone)
        fo, _, _, info = prog(st, tm, scene["frames"][3], scene["tsbi0"],
                              rc, rf, wiggle)
        return int(info[3]), tree.map_tensors(fo.state.pose,
                                              torch.Tensor.clone)

    assert need_kf(1e4)[0] == 0
    needed, pose = need_kf(1e-4)
    assert needed == 1
    ff3 = tkeyframe.build_frame(torch.from_numpy(scene["frames"][3]).float(),
                                candidate_min_score=CAND_MIN)
    tms.insert_keyframe(tm, 2, ff3, pose)          # in place
    assert need_kf(1e-4)[0] == 0


def test_the_engine_rebuilds_a_program_only_when_it_must(scene):
    """A program is kept while what it bakes in is unchanged (the console
    replaces ``cfg`` for any tunable) and rebuilt when it changes."""
    eng = tengine.SLAMEngine(_tcfg(), image_size=SIZE, max_points=P,
                             max_kfs=K, device="cpu")
    track = eng._program("track", torch.uint8)
    build = eng._program("build", torch.uint8)
    reloc = eng._program("reloc")
    assert eng._program("track", torch.uint8) is track
    eng.cfg = eng.cfg.replace(mapmaker=dataclasses.replace(
        eng.cfg.mapmaker, max_queue_size=7))
    assert eng._program("track", torch.uint8) is track
    assert eng._program("build", torch.uint8) is build
    assert eng._program("reloc") is reloc
    assert eng._program("track", torch.float32) is not track
    eng.cfg = eng.cfg.replace(tracker=dataclasses.replace(
        eng.cfg.tracker, coarse_min=eng.cfg.tracker.coarse_min + 1))
    assert eng._program("track", torch.float32).key[0] == eng.cfg.tracker
    eng.cfg = eng.cfg.replace(mapmaker=dataclasses.replace(
        eng.cfg.mapmaker, candidate_min_shi_tomasi_score=CAND_MIN + 1))
    assert eng._program("build", torch.uint8) is not build
    eng.cfg = eng.cfg.replace(reloc=dataclasses.replace(
        eng.cfg.reloc, esm_iterations=3))
    assert eng._program("reloc") is not reloc


def test_what_escapes_a_call_survives_the_next(scene):
    """With the mapping worker: each keyframe the engine queues (features,
    pose, measurements, depths) and each pair of deltas it hands over
    stays as it was handed over while later frames run, though the
    program overwrites its outputs on every call."""
    cfg = _tcfg(tracker=tconfig.TrackerConfig(min_frames_between_kfs=0))
    cfg = cfg.replace(mapmaker=dataclasses.replace(        # a keyframe
        cfg.mapmaker, max_kf_dist_wiggle_mult=0.0))         # every frame
    eng = tengine.SLAMEngine(cfg, image_size=SIZE, max_points=P,
                             max_kfs=K, device="cpu", deterministic=True,
                             async_mapping=True)
    kept, hand_over = [], eng._hand_over

    def keeping(obj):
        if isinstance(obj, tuple) and len(obj) in (2, 5):   # deltas, kf
            kept.extend((t, t.clone()) for t in tree.tensors(obj))
        return hand_over(obj)
    eng._hand_over = keeping
    seq, outs, infos = scene["seq"], [], []
    try:
        for i in range(11):
            infos.append(eng.process_frame(_u8(seq.frame(i))))
            p = eng._pending
            if p is not None:
                outs.append(p["out"].result.inlier_delta)
            assert all(torch.equal(t, c) for t, c in kept), i
    finally:
        eng.close()
    assert infos[-1].stage == "TRACKING"
    assert sum(i.added_kf for i in infos) >= 2
    # The program's outputs are one set of tensors, overwritten each call.
    assert len(outs) > 2 and all(o is outs[0] for o in outs)


def test_reloc_program_matches_jax(scene):
    """Frame 5's SBI against keyframes 0 and 6 (tests/test_torch_reloc.py's
    bars: best keyframe and success equal, score within a relative 1e-5,
    pose within 1e-5)."""
    sbi = scene["build"](jnp.asarray(scene["frames"][5])).sbi
    j = jax.jit(relocalizer.attempt_recovery, static_argnums=3)(
        scene["m"], sbi, jnp.asarray(REF_PARAMS, jnp.float32), (15, 20))
    prog = programs.RelocProgram(_tcfg(), SIZE,
                                 cam_params=torch.tensor(REF_PARAMS),
                                 capacity=(P, K), device="cpu")
    t = prog(scene["tm"], fj.sbi_from_numpy(fj.as_numpy_tree(sbi), "cpu"))
    assert int(t.best_kf) == int(j.best_kf) == 1
    assert bool(t.success) == bool(j.success)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R),
                               atol=1e-5)
    np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t),
                               atol=1e-5)


def test_build_program_matches_jax(scene):
    """A uint8 frame cast in the program: the port's ``build_frame``
    exactly, and tests/test_torch_keyframe.py's bars against JAX (lists
    and corners exact, SBIs within 1e-3, candidate scores within the
    Shi-Tomasi bar and only near-threshold candidates apart)."""
    frame = scene["frames"][6]
    prog = programs.BuildProgram(_tcfg(), SIZE, frame_dtype=torch.uint8,
                                 device="cpu")
    got = prog(frame)
    again = prog(scene["frames"][5])
    want = tkeyframe.build_frame(torch.from_numpy(frame).float(),
                                 candidate_min_score=CAND_MIN)
    for a, b in zip(tree.tensors(got), tree.tensors(want)):
        assert torch.equal(a, b)
    assert not torch.equal(again.atlas, got.atlas)     # a copy each call
    ref = scene["ffs"][1]
    for f in ("atlas", "corner_mask", "corner_count", "max_xy", "max_score",
              "max_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for name in ("sbi", "sbi_track"):
        for f in ("template", "jac"):
            np.testing.assert_allclose(
                getattr(getattr(got, name), f).numpy(),
                np.asarray(getattr(getattr(ref, name), f)), atol=1e-3)
    for lev in range(4):
        mine, theirs = ({tuple(p): s for p, s, v in zip(
            np.asarray(ff.cand_xy[lev]), np.asarray(ff.cand_score[lev]),
            np.asarray(ff.cand_valid[lev])) if v} for ff in (got, ref))
        for p in set(mine) | set(theirs):
            s = mine.get(p, theirs.get(p))
            if p in mine and p in theirs:
                assert abs(mine[p] - theirs[p]) <= (
                    ST_ATOL + ST_RTOL * abs(theirs[p])), (lev, p)
            else:
                assert abs(s - CAND_MIN) <= ST_ATOL + ST_RTOL * CAND_MIN, \
                    (lev, p, s)


class _HostTraffic(torch.overrides.TorchFunctionMode):
    """Records the calls that read the device on the host or copy a host
    value to it, which a CUDA graph cannot capture."""

    NAMES = {"tensor", "item", "tolist", "__bool__", "__int__",
             "__float__", "__index__", "nonzero", "argwhere", "cpu",
             "numpy", "masked_select", "unique", "repeat_interleave"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        index = args[1] if name == "__getitem__" and len(args) > 1 else ()
        masked = any(isinstance(i, torch.Tensor)
                     and (i.dtype == torch.bool or i.ndim == 0)
                     for i in (index if isinstance(index, tuple)
                               else (index,)))
        if (name in self.NAMES or masked
                or (name == "as_tensor"
                    and not isinstance(args[0], torch.Tensor))
                or (name == "where" and len(args) == 1)):
            self.calls.append(name)
        return func(*args, **(kwargs or {}))


def test_programs_neither_read_nor_copy_from_the_host(scene):
    track, tm = _track_program(scene), scene["tm"]
    track(ttracker.init_tracker_state(scene["tpose"](0), device="cpu"), tm,
          scene["frames"][1], scene["tsbi0"], torch.rand(P), torch.rand(P),
          WIGGLE)
    build = programs.BuildProgram(_tcfg(), SIZE, frame_dtype=torch.uint8,
                                  device="cpu")
    build.frame.copy_(torch.from_numpy(scene["frames"][2]))
    reloc = programs.RelocProgram(_tcfg(), SIZE,
                                  cam_params=torch.tensor(REF_PARAMS),
                                  capacity=(P, K), device="cpu")
    reloc(tm, scene["tsbi0"])
    for prog in (track, build, reloc):
        with _HostTraffic() as seen:
            prog._fn(*prog._inputs())
        assert seen.calls == [], (type(prog).__name__, seen.calls)
    with _HostTraffic() as seen:                  # the probe itself
        x = torch.tensor([1.0, 0.0])
        x[x > 0]
        bool(x.sum())
    assert seen.calls == ["tensor", "__getitem__", "__bool__"]
