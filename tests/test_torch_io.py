"""The port's dataset reader, settings parser and checkpoints against the
JAX package's, on the same files (tests/test_io.py's cases, mirrored).

Checkpoints must move between the packages both ways: a map (every field
filled with seeded random values of its dtype, so a swapped or dropped
key shows), the tracker state and a BA ``LMState`` are written by one
package and read by the other, and compared array for array, exactly.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.io import checkpoint as jcheckpoint
from ptam_cg_tpu.io import settings as jsettings
from ptam_cg_tpu.io import synth as jsynth
from ptam_cg_tpu.io import tum as jtum
from ptam_cg_tpu.models import bundle as jbundle
from ptam_cg_tpu.models import map_state as jmap_state
from ptam_cg_tpu.models import tracker as jtracker
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu_torch.io import checkpoint, settings, tum
from ptam_cg_tpu_torch.io.from_jax import as_numpy_tree, map_state_from_numpy
from ptam_cg_tpu_torch.models import bundle, tracker
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.utils import se3

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


def _frames(n, shape=(24, 32)):
    return [np.random.default_rng(i).uniform(0, 255, shape)
            .astype(np.float32) for i in range(n)]


def test_tum_dataset_matches_jax(tmp_path):
    frames = _frames(5)
    jtum.write_synthetic_dataset(str(tmp_path), frames)
    port, ref = tum.TumDataset(str(tmp_path)), jtum.TumDataset(str(tmp_path))
    assert len(port) == len(ref) == 5
    assert port.entries == ref.entries
    np.testing.assert_array_equal(port.timestamps(), ref.timestamps())
    for i in (0, 2, 7):                   # 7 wraps around to 2
        np.testing.assert_array_equal(port.frame(i), ref.frame(i))
    np.testing.assert_array_equal(port.frame(7), frames[2])
    for _ in range(6):                    # past the end: wraps
        (ts_p, f_p), (ts_r, f_r) = port.next_frame(), ref.next_frame()
        assert ts_p == ts_r
        np.testing.assert_array_equal(f_p, f_r)
    once = tum.TumDataset(str(tmp_path), loop=False)
    assert len([once.next_frame() for _ in range(5)]) == 5
    with pytest.raises(StopIteration):
        once.next_frame()


def test_tum_skips_comments(tmp_path):
    (tmp_path / "rgb").mkdir()
    np.save(tmp_path / "rgb" / "a.npy", np.zeros((4, 4), np.float32))
    (tmp_path / "rgb.txt").write_text(
        "# comment\n\n1.5 rgb/a.npy\n# another\n")
    ds = tum.TumDataset(str(tmp_path))
    assert ds.entries == jtum.TumDataset(str(tmp_path)).entries == [
        (1.5, "rgb/a.npy")]


def test_pgm_and_uint8_frames_read_as_jax_reads_them(tmp_path):
    """An 8-bit PGM (with a comment in its header) and a uint8 .npy read
    by numpy alone, equal to the JAX reader's values; a PNG goes through
    PIL in both."""
    (tmp_path / "rgb").mkdir()
    arr = (np.arange(35, dtype=np.uint8).reshape(5, 7) * 7)
    with open(tmp_path / "rgb" / "f.pgm", "wb") as f:
        f.write(b"P5\n# comment\n7 5\n255\n" + arr.tobytes())
    np.save(tmp_path / "rgb" / "u8.npy", arr)
    lines = "1.0 rgb/f.pgm\n2.0 rgb/u8.npy\n"
    pil = pytest.importorskip("PIL.Image")
    pil.fromarray(arr).save(tmp_path / "rgb" / "f.png")
    lines += "3.0 rgb/f.png\n"
    (tmp_path / "rgb.txt").write_text(lines)
    port, ref = tum.TumDataset(str(tmp_path)), jtum.TumDataset(str(tmp_path))
    for i in range(len(port)):
        got = port.frame(i)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr.astype(np.float32))
        np.testing.assert_array_equal(got, ref.frame(i))


def test_png_without_pil_raises(tmp_path, monkeypatch):
    """No frame is skipped: without PIL a PNG frame raises, naming the
    formats that need nothing."""
    import builtins
    (tmp_path / "rgb").mkdir()
    (tmp_path / "rgb" / "f.png").write_bytes(b"not read")
    (tmp_path / "rgb.txt").write_text("1.0 rgb/f.png\n")
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"\.npy or \.pgm"):
        tum.TumDataset(str(tmp_path)).frame(0)


def test_groundtruth_matches_jax(tmp_path):
    (tmp_path / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n"
        "1.0 0.1 0.2 0.3 0.0 0.0 0.0 1.0\n"
        "2.0 0.2 0.3 0.4 0.1 0.0 0.0 0.99\n"
        "3.0 0.1 0.2\n")
    got, want = (tum.load_groundtruth(str(tmp_path)),
                 jtum.load_groundtruth(str(tmp_path)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2][0], [1.0, 0, 0, 0])   # wxyz


def test_write_synthetic_dataset_matches_jax(tmp_path):
    """The same frames and poses (test_slam_e2e.py's orbit, 8 frames)
    written by both packages: the same rgb.txt, frames and, within 1e-6
    plus the 6-decimal rounding, the same groundtruth.txt."""
    seq = jsynth.SyntheticSequence(REF_PARAMS, image_size=(64, 48),
                                   n_frames=8, seed=5, height=1.5,
                                   radius=0.35, sweep=1.3)
    frames = [np.array(seq.frame(i)) for i in range(8)]
    jposes = [seq.pose(i) for i in range(8)]
    tposes = [se3.SE3(torch.from_numpy(np.array(p.R)),
                      torch.from_numpy(np.array(p.t))) for p in jposes]
    jtum.write_synthetic_dataset(str(tmp_path / "jax"), frames, poses=jposes)
    tum.write_synthetic_dataset(str(tmp_path / "port"),
                                [torch.from_numpy(f) for f in frames],
                                poses=tposes)
    read = lambda d, f: (tmp_path / d / f).read_text()   # noqa: E731
    assert read("port", "rgb.txt") == read("jax", "rgb.txt")
    for i in range(8):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "rgb" / f"{i:06d}.npy"), frames[i])

    def rows(d):
        return np.array([[float(x) for x in ln.split()]
                         for ln in read(d, "groundtruth.txt").splitlines()
                         if not ln.startswith("#")])
    np.testing.assert_allclose(rows("port"), rows("jax"), rtol=0,
                               atol=1e-6 + 1e-6)


def _settings_files(tmp_path):
    (tmp_path / "camera.cfg").write_text(
        "Camera.Parameters=[ 1.0803 1.43987 0.519983 0.548655 0.244943 ]\n")
    cfg_file = tmp_path / "settings.cfg"
    cfg_file.write_text(
        "// comment line\n"
        "exec camera.cfg\n"
        "exec missing.cfg\n"
        "VideoSource.Resolution = [ 640 480 ]\n"
        'VideoSource.DataSet = "../data/some_set"\n'
        "Tracker.CoarseMin = 25\n"
        "Tracker.MEstimator = \"Tukey\"\n"
        "Tracker.UseRotationEstimator = 0\n"
        "Tracker.TrackingQualityGood = 0.4\n"
        "MapMaker.CandidateMinShiTomasiScore = 400\n"
        "MapMaker.WiggleScale = 0.2 // trailing comment\n"
        "Bundle.MaxIterations = 12\n"
        "Reloc2.MaxScore = 9e6\n"
        "Unknown.Name = hello\n")
    return str(cfg_file)


def test_load_engine_config_matches_jax(tmp_path):
    path = _settings_files(tmp_path)
    cfg, gv = settings.load_engine_config(path)
    jcfg, jgv = jsettings.load_engine_config(path)
    assert gv == jgv
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.tracker.coarse_min == 25 and cfg.reloc.max_score == 9e6
    assert cfg.tracker.mestimator == "tukey"
    assert not cfg.tracker.use_rotation_estimator
    assert gv["VideoSource.DataSet"] == "../data/some_set"


def _random_map_numpy(seed=0):
    """A JAX empty map (64x48, 32 points, 3 keyframes) with every field
    filled with random values of its dtype, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in as_numpy_tree(jmap_state.empty_map(
            (64, 48), max_points=32, max_kfs=3)).items():
        if a.dtype == np.bool_:
            out[name] = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.integer):
            out[name] = rng.integers(-5, 100, a.shape).astype(a.dtype)
        else:
            out[name] = rng.normal(size=a.shape).astype(a.dtype)
    return out


def _jax_tracker_state():
    return jtracker.init_tracker_state(jse3.se3_exp(
        jnp.array([.1, .2, .3, .01, .02, .03], jnp.float32)))._replace(
            velocity=jnp.arange(6, dtype=jnp.float32) / 7,
            msd_vel=jnp.float32(0.25), lost_frames=jnp.int32(3),
            quality=jnp.int32(1), just_recovered=jnp.asarray(True),
            depth_mean=jnp.float32(1.5), depth_sigma=jnp.float32(0.5))


_TRK_FIELDS = ("velocity", "msd_vel", "lost_frames", "quality",
               "just_recovered", "depth_mean", "depth_sigma")


def _assert_tracker_equal(port, jax_st):
    np.testing.assert_array_equal(port.pose.R.numpy(),
                                  np.asarray(jax_st.pose.R))
    np.testing.assert_array_equal(port.pose.t.numpy(),
                                  np.asarray(jax_st.pose.t))
    for f in _TRK_FIELDS:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(jax_st, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_maps_equal(port: MapState, jax_map):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name).numpy(), np.asarray(
            getattr(jax_map, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_checkpoint_from_jax_to_port(tmp_path):
    d = _random_map_numpy()
    jm = jmap_state.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    jst = _jax_tracker_state()
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_map(path, jm, jst, meta={"frame": 42})
    m, st = checkpoint.load_map(path, device="cpu")
    _assert_maps_equal(m, jm)
    _assert_tracker_equal(st, jst)


def test_checkpoint_from_port_to_jax_and_back(tmp_path):
    m = map_state_from_numpy(_random_map_numpy(1), "cpu")
    jst = _jax_tracker_state()
    st = tracker.init_tracker_state(se3.SE3(
        torch.from_numpy(np.array(jst.pose.R)),
        torch.from_numpy(np.array(jst.pose.t))))
    st = dataclasses.replace(st, **{
        f: torch.from_numpy(np.array(getattr(jst, f))) for f in _TRK_FIELDS})
    path = str(tmp_path / "port.npz")
    checkpoint.save_map(path, m, st, meta={"frame": 7})
    assert os.path.exists(path + ".meta.json")
    assert "trk.key" not in np.load(path)
    jm, jst2 = jcheckpoint.load_map(path)
    _assert_maps_equal(m, jm)
    _assert_tracker_equal(st, jst2)
    m2, st2 = checkpoint.load_map(path, device="cpu")
    _assert_maps_equal(m2, jm)
    _assert_tracker_equal(st2, jst2)
    checkpoint.save_map(str(tmp_path / "bare.npz"), m2)
    m3, st3 = checkpoint.load_map(str(tmp_path / "bare.npz"), device="cpu")
    assert st3 is None
    _assert_maps_equal(m3, jm)


def _jax_lm_state():
    rng = np.random.default_rng(3)
    C, P, M = 3, 8, 16
    prob = jbundle.BundleProblem(
        cam_R=jnp.asarray(np.stack([np.eye(3)] * C), jnp.float32),
        cam_t=jnp.asarray(rng.normal(size=(C, 3)), jnp.float32),
        cam_fixed=jnp.asarray([True, False, False]),
        cam_valid=jnp.ones(C, bool),
        pt_pos=jnp.asarray(rng.normal(size=(P, 3)) + [0, 0, 3], jnp.float32),
        pt_valid=jnp.ones(P, bool),
        meas_cam=jnp.asarray(rng.integers(0, C, M), jnp.int32),
        meas_pt=jnp.asarray(rng.integers(0, P, M), jnp.int32),
        meas_pos=jnp.asarray(rng.normal(size=(M, 2)) * 100, jnp.float32),
        meas_sqrt_inv_noise=jnp.asarray(rng.random(M), jnp.float32),
        meas_valid=jnp.asarray(rng.random(M) < 0.8),
        meas_bad=jnp.asarray(rng.random(M) < 0.2))
    return jbundle.init_lm(prob)._replace(
        lam=jnp.float32(0.125), accepted=jnp.int32(4), iters=jnp.int32(6),
        last_error=jnp.float32(3.5), converged=jnp.asarray(True))


def _assert_lm_equal(port, jax_state):
    for f in dataclasses.fields(port.problem):
        a = getattr(port.problem, f.name).numpy()
        b = np.asarray(getattr(jax_state.problem, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for k in ("lam", "lam_factor", "converged", "accepted", "iters",
              "last_error", "failed"):
        a, b = getattr(port, k).numpy(), np.asarray(getattr(jax_state, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_ba_state_crosses_both_ways(tmp_path):
    js = _jax_lm_state()
    jpath, ppath = str(tmp_path / "jax_ba.npz"), str(tmp_path / "ba.npz")
    jcheckpoint.save_ba_state(jpath, js)
    port = checkpoint.load_ba_state(jpath, device="cpu")
    _assert_lm_equal(port, js)
    # The layout is the one init_lm builds from the problem.
    want = bundle.measurement_layout(port.problem)
    assert torch.equal(port.layout.pt_rank, want.pt_rank)
    checkpoint.save_ba_state(ppath, port)
    _assert_lm_equal(port, jcheckpoint.load_ba_state(ppath))
    _assert_lm_equal(checkpoint.load_ba_state(ppath, device="cpu"), js)


def test_export_map_text_matches_jax(tmp_path):
    d = _random_map_numpy(2)
    jm = jmap_state.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    jcheckpoint.export_map_text(str(tmp_path / "jax_"), jm)
    checkpoint.export_map_text(str(tmp_path / "port_"),
                               map_state_from_numpy(d, "cpu"))
    assert ((tmp_path / "port_map.dump").read_text()
            == (tmp_path / "jax_map.dump").read_text())
    names = sorted(os.listdir(tmp_path / "jax_keyframes"))
    assert names and sorted(os.listdir(tmp_path / "port_keyframes")) == names
    for n in names:
        assert ((tmp_path / "port_keyframes" / n).read_text()
                == (tmp_path / "jax_keyframes" / n).read_text())


def test_quaternions_match_jax():
    rng = np.random.default_rng(5)
    R = np.array(jse3.so3_exp(jnp.asarray(
        rng.normal(size=(64, 3)) * 1.5, jnp.float32)))
    R[:4] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)   # trace -1 cases
    R[4] = np.diag([-1.0, 1.0, -1.0])
    R[5] = np.diag([-1.0, -1.0, 1.0])
    q = se3.quat_from_rot(torch.from_numpy(R))
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.quat_from_rot(R)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.rot_from_quat(q).numpy(), R, atol=2e-6)
    np.testing.assert_allclose(
        se3.rot_from_quat(q * 3.0).numpy(),
        np.asarray(jse3.rot_from_quat(jnp.asarray(q.numpy() * 3.0))),
        rtol=0, atol=1e-6)
