"""The engine (``SLAMEngine.process_frame``): the PyTorch port against the
JAX package, frame by frame.

The scene is tests/test_slam_e2e.py's (320x240, 26 frames, seed 5, height
1.5, radius 0.35, sweep 1.3; 1024 point and 8 keyframe slots, auto-init
after 6 frames, candidate threshold 70), rendered by the JAX synth and
rounded to uint8, which both engines take as they are and cast on their
device: integer frames make both packages' half-sampled pyramids exact,
so the builds agree (a float frame's pyramid rounds an ulp apart here and
there, ROADMAP §3). Both engines run in deterministic mode; the port gets
``JaxDraws``, which replays the JAX engine's key splits with
``jax.random``, so both consume the same numbers.

Bars, per frame: the same stage, quality, ``added_kf``, ``relocalized``,
keyframe count, found count and point count (measured: equal on every
frame). Poses: init's scale is free (one fixed keyframe, ROADMAP §3), so
translations are compared after dividing each run's by the |t| of its
pose on the init frame; rotations within ``ROT_TOL`` and scaled
translations within ``T_TOL`` (measured on this scene: at most 2.19e-6
and 2.85e-7; the bars are ~3x). The port's ATE after Sim(3) alignment
stays under the e2e's bar (5% of the trajectory's span), and a second
port run gives the same ``FrameInfo``s bit for bit.

The port-only tests at the end: relocalization after noise frames and the
poisoned-BA reset (tests/test_engine_reloc.py's scenarios) and a replay
under simulated host load (tests/test_determinism.py's), which the JAX
package marks slow; ``utils/evaluate.py`` against JAX's, and that a
``FrameInfo``'s pose is a copy.
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
from ptam_cg_tpu.utils import evaluate as jevaluate
from ptam_cg_tpu.utils.se3 import SE3 as JSE3
from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.utils import evaluate as tevaluate
from ptam_cg_tpu_torch.utils.se3 import SE3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
N_FRAMES = 26
P, K = 1024, 8
CAND_MIN = 70.0
ROT_TOL = 7e-6
T_TOL = 1e-6


class JaxDraws:
    """The JAX engine's draws, replayed for the port: the engine key
    (``PRNGKey(seed)``) splits for MLESAC and for each new tracker key,
    the tracker key (``PRNGKey(seed + 1)``) splits once a tracked frame
    into the next key and the frame's, which splits into the coarse and
    fine keys; the MapMaker's key (``PRNGKey(seed)``, again at reset)
    splits for the plane aligner."""

    def __init__(self, seed=0):
        self.seed = seed
        self._engine = jax.random.PRNGKey(seed)
        self._tracker = jax.random.PRNGKey(seed + 1)
        self._mapmaker = jax.random.PRNGKey(seed)

    def _next_engine(self):
        self._engine, sub = jax.random.split(self._engine)
        return sub

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    def rekey_tracker(self):
        self._tracker = self._next_engine()

    def reset_mapmaker(self):
        self._mapmaker = jax.random.PRNGKey(self.seed)

    def track(self, n):
        self._tracker, k_frame = jax.random.split(self._tracker)
        kc, kf = jax.random.split(k_frame)
        return (self._t(jax.random.uniform(kc, (n,))),
                self._t(jax.random.uniform(kf, (n,))))

    def mlesac(self, trials, n):
        return self._t(jax.random.uniform(self._next_engine(), (trials, n)))

    def plane(self, n_ransacs, n):
        self._mapmaker, sub = jax.random.split(self._mapmaker)
        return self._t(jax.random.uniform(sub, (n_ransacs, n)))


def _jcfg():
    return EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=CAND_MIN))


def _tcfg():
    return tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(
            candidate_min_shi_tomasi_score=CAND_MIN))


def _port_engine(draws=None):
    return tengine.SLAMEngine(_tcfg(), image_size=SIZE, max_points=P,
                              max_kfs=K, auto_init_frames=6, seed=0,
                              deterministic=True, device="cpu", draws=draws)


@pytest.fixture(scope="module")
def seq():
    return synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                   n_frames=N_FRAMES, seed=5, height=1.5,
                                   radius=0.35, sweep=1.3)


@pytest.fixture(scope="module")
def frames(seq):
    return [np.clip(np.round(np.asarray(seq.frame(i))), 0, 255).astype(
        np.uint8) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def jax_run(frames):
    eng = jengine.SLAMEngine(_jcfg(), image_size=SIZE, max_points=P,
                             max_kfs=K, auto_init_frames=6, seed=0,
                             deterministic=True)
    return [eng.process_frame(im) for im in frames]


@pytest.fixture(scope="module")
def port_run(frames):
    eng = _port_engine(JaxDraws(0))
    return [eng.process_frame(im) for im in frames]


def _outcome(info):
    return (info.stage, info.quality, info.added_kf, info.relocalized,
            info.n_kfs, info.n_found, info.n_points)


def _scaled_poses(infos):
    """(R, t / |t on the init frame|) of each frame, numpy."""
    R = [np.asarray(i.pose.R, np.float64) for i in infos]
    t = [np.asarray(i.pose.t, np.float64) for i in infos]
    first = next(k for k, i in enumerate(infos) if i.stage == "TRACKING")
    s = np.linalg.norm(t[first])
    return R, [x / s for x in t], first


def test_engine_matches_jax_frame_by_frame(jax_run, port_run):
    want = [_outcome(i) for i in jax_run]
    got = [_outcome(i) for i in port_run]
    assert got == want
    stages = [i.stage for i in port_run]
    assert "TRAIL_TRACKING" in stages and stages.index("TRACKING") <= 10
    jR, jt, first = _scaled_poses(jax_run)
    tR, tt, _ = _scaled_poses(port_run)
    d_R = max(np.abs(a - b).max() for a, b in zip(jR[first:], tR[first:]))
    d_t = max(np.abs(a - b).max() for a, b in zip(jt[first:], tt[first:]))
    print(f"\nengine vs JAX over frames {first}..{N_FRAMES - 1}: |dR| "
          f"{d_R:.2e}, |dt| / |t| {d_t:.2e}")
    assert d_R <= ROT_TOL and d_t <= T_TOL, (d_R, d_t)


def test_port_engine_tracks_within_the_e2e_bars(seq, port_run):
    """tests/test_slam_e2e.py's bars: GOOD on more than 80% of the
    tracked frames, more than 30 found after the first, the map grown,
    and ATE after Sim(3) alignment under 5% of the trajectory's span."""
    tracking = [(k, i) for k, i in enumerate(port_run)
                if i.stage == "TRACKING"]
    assert len(tracking) > 10
    assert sum(i.quality == 2 for _, i in tracking) > 0.8 * len(tracking)
    assert all(i.n_found > 30 for _, i in tracking[1:])
    assert port_run[-1].n_points > 100 and port_run[-1].n_kfs >= 2
    est = tevaluate.camera_centers(SE3(
        torch.stack([i.pose.R for _, i in tracking]),
        torch.stack([i.pose.t for _, i in tracking])))
    gt = np.stack([np.asarray(-seq.pose(k).R.T @ seq.pose(k).t)
                   for k, _ in tracking])
    ate = tevaluate.ate_rmse(est, gt)
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert ate < 0.05 * max(span, 0.1), (ate, span)


def test_port_engine_replays_bit_for_bit(frames, port_run):
    eng = _port_engine(JaxDraws(0))
    for k, (im, ref) in enumerate(zip(frames, port_run)):
        info = eng.process_frame(im)
        assert _outcome(info) == _outcome(ref), k
        assert torch.equal(info.pose.R, ref.pose.R), k
        assert torch.equal(info.pose.t, ref.pose.t), k


def test_frame_info_pose_is_a_copy(frames):
    """The map and the tracker state are written in place and replaced
    as frames go by; a FrameInfo's pose never changes after it is
    returned."""
    eng = _port_engine()
    infos, kept = [], []
    for im in frames[:12]:
        info = eng.process_frame(im)
        infos.append(info)
        kept.append((info.pose.R.clone(), info.pose.t.clone()))
    assert infos[6].stage == "TRACKING"
    # The pose of the init frame is keyframe 1's: move the map's.
    eng.map.kf_R[1] += 1.0
    eng.map.kf_t[1] += 1.0
    eng.tracker_state.pose.R[:] = 0.0
    for info, (R, t) in zip(infos, kept):
        assert torch.equal(info.pose.R, R) and torch.equal(info.pose.t, t)


def test_evaluate_matches_jax():
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(30, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    est = (0.37 * gt @ q.T + rng.normal(0, 0.01, (30, 3)) + [1, 2, 3])
    est32 = est.astype(np.float32)
    for a, b in zip(tevaluate.align_sim3(torch.from_numpy(est32), gt),
                    jevaluate.align_sim3(jnp.asarray(est32), gt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    assert tevaluate.ate_rmse(est32, gt) == pytest.approx(
        jevaluate.ate_rmse(jnp.asarray(est32), gt), rel=1e-12)
    R = rng.normal(size=(5, 3, 3)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tevaluate.camera_centers(SE3(torch.from_numpy(R),
                                     torch.from_numpy(t))).numpy(),
        np.asarray(jevaluate.camera_centers(JSE3(jnp.asarray(R),
                                                 jnp.asarray(t)))),
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def reloc_frames():
    """tests/test_engine_reloc.py's 16-frame sequence, as uint8."""
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=16,
                                  seed=5, height=1.5, radius=0.35, sweep=1.3)
    return [np.clip(np.round(np.asarray(seq.frame(i))), 0, 255).astype(
        np.uint8) for i in range(16)]


def test_lost_then_relocalize(reloc_frames):
    """Six noise frames lose tracking; the sequence again relocalizes
    and is GOOD within 8 frames."""
    eng = _port_engine()
    for im in reloc_frames[:12]:
        info = eng.process_frame(im)
    assert info.stage == "TRACKING" and info.quality == 2
    rng = np.random.default_rng(0)
    relocalized = False
    for _ in range(6):
        info = eng.process_frame(rng.uniform(0, 255, (SIZE[1], SIZE[0]))
                                 .astype(np.float32))
        relocalized |= info.relocalized
    assert info.quality != 2
    for i in (6, 7, 8, 6, 7, 8, 7, 7):
        info = eng.process_frame(reloc_frames[i])
        relocalized |= info.relocalized
        if info.quality == 2:
            break
    assert relocalized
    assert info.quality == 2 and info.n_found > 50, info


def test_poisoned_ba_ditches_map(reloc_frames):
    """A measurement table poisoned with 3e19 makes the next global BA
    fail numerically; the engine ditches the map (NOT_STARTED, 0 points,
    0 keyframes, a fresh MapMaker) and initializes again."""
    eng = _port_engine()
    for im in reloc_frames[:10]:
        info = eng.process_frame(im)
    assert info.stage == "TRACKING"
    m = eng.map
    poisoned = dataclasses.replace(m, meas_pos=torch.where(
        m.meas_valid[..., None], torch.tensor(3e19), m.meas_pos))
    eng.map = eng.mapmaker.map = poisoned
    eng.mapmaker.converged_recent = True
    eng.mapmaker.converged_full = False
    saw_reset = False
    for im in reloc_frames[10:]:
        info = eng.process_frame(im)
        if info.stage == "NOT_STARTED":
            saw_reset = True
            break
    assert saw_reset
    assert info.n_points == 0 and info.n_kfs == 0
    assert not eng.mapmaker.reset_requested
    for im in reloc_frames + reloc_frames:
        info = eng.process_frame(im)
        if info.stage == "TRACKING":
            break
    assert info.stage == "TRACKING"


def _replay(load, monkeypatch=None):
    """tests/test_determinism.py's run: 60 frames (seed 9, radius 0.6,
    sweep 1.4), keyframes allowed every 3 frames, then ``drain_all``.
    With ``load`` the MapMaker's clock jumps 0-80 ms a call and every
    third frame sleeps 10 ms. Returns (engine, keyframe counts)."""
    import time
    from ptam_cg_tpu_torch.io import synth as tsynth
    from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
    seq = tsynth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=60,
                                   seed=9, height=1.5, radius=0.6, sweep=1.4,
                                   device="cpu")
    cfg = tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        tracker=tconfig.TrackerConfig(min_frames_between_kfs=2),
        mapmaker=tconfig.MapMakerConfig(candidate_min_shi_tomasi_score=70.0,
                                        max_kf_dist_wiggle_mult=0.15))
    eng = tengine.SLAMEngine(cfg, image_size=SIZE, max_points=2048,
                             max_kfs=16, auto_init_frames=5, seed=0,
                             device="cpu")
    assert eng.mapmaker.deterministic       # a CPU map picks it
    if load:
        real, rng, skew = time.perf_counter, np.random.default_rng(123), [0.0]

        def jittery():
            skew[0] += float(rng.uniform(0.0, 0.08))
            return real() + skew[0]

        monkeypatch.setattr(tmapmaker.time, "perf_counter", jittery)
    kf_counts = []
    for i in range(60):
        if load and i % 3 == 0:
            time.sleep(0.01)
        kf_counts.append(eng.process_frame(
            seq.frame(i).round().clamp(0, 255).to(torch.uint8)).n_kfs)
    eng.mapmaker.map = eng.map
    eng.mapmaker.drain_all()
    assert eng.mapmaker.queue_size() == 0
    assert eng.mapmaker._integrate_job is None
    assert eng.mapmaker._pending_integrate is None
    return eng, kf_counts


def test_replay_identical_under_load(monkeypatch):
    """tests/test_determinism.py's check (slow there) on the port: the
    same frames under a jittering clock and uneven host stalls give the
    same keyframe count on every frame and, once ``drain_all`` has landed
    every job, the same map bit for bit."""
    eng_a, kfs_a = _replay(False)
    eng_b, kfs_b = _replay(True, monkeypatch)
    assert kfs_a == kfs_b
    assert kfs_a[-1] >= 4, kfs_a
    for f in ("point_valid", "point_pos", "kf_R", "kf_t", "meas_valid"):
        assert torch.equal(getattr(eng_a.mapmaker.map, f),
                           getattr(eng_b.mapmaker.map, f)), f


def test_async_mapping_is_refused():
    with pytest.raises(NotImplementedError):
        tengine.SLAMEngine(_tcfg(), image_size=SIZE, max_points=64,
                           max_kfs=2, device="cpu", async_mapping=True)
