"""The exploring flight: a route over new ground (``scene.Route``) and the
``explore`` mix that flies it, set-up over the route's opening and the
window timed whole (``cell.py``).

The route is checked at the size of the one flown on the card
(``CARD_ROUTE``: a 752x480 camera at 20 Hz, 0.41 m/s and 16 deg/s); the
rehearsal runs on the CPU, at 320x240, a slower route of 150 frames with a
16-keyframe pool (``SMALL_ROUTE``), from a checkout of its own whose
``BENCHMARK.json`` adds the cell: no cell of the benchmark flies a route
yet."""

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from bench_port import cell as celllib
from bench_port import control, reference, scene
from bench_port import spec as speclib
from bench_port.spec import Spec

#: The route flown on the card: a camera with EuRoC MAV cam0's intrinsics
#: (752x480 at 20 Hz, ATAN w 0.92) at 0.41 m/s and 16.0 deg/s, 1.6 m over
#: the ground, looking across its travel, pitched 80 degrees down and
#: panning about its own vertical axis with a 1 m wavelength.
CARD_ROUTE = {
    "camera": {"params": [0.60991, 0.9527, 0.48832, 0.51745, 0.92],
               "image_size": [752, 480], "fps": 20},
    "path": {"kind": "route", "linear_speed_m_s": 0.41,
             "angular_speed_deg_s": 16.0, "height": 1.6, "pitch_deg": 80.0,
             "look_deg": 90.0, "sway_about": "camera",
             "sway_wavelength_m": 1.0, "ramp_frames": 4},
    "scene": {"boxes": {"per_m2": 1.5, "half": [0.05, 0.15],
                        "height": [0.03, 0.13]}}}
CARD_FRAMES = 2200

#: The rehearsal's route: a camera of TUM fr1's field of view at 320x240,
#: slow enough for the few keyframes a CPU run's 150 frames make to keep
#: the map ahead of it. Its limits are the offline cell's doubled: the
#: CPU's frames resolve half the angle (a pixel is 3.9 mrad); they are the
#: rehearsal's, not a cell's.
SMALL_ROUTE = {
    "name": "route_small", "source": "a CPU rehearsal of the explore mix",
    "camera": {"params": [0.80828125, 1.07604167, 0.4978125, 0.531875,
                          0.244943], "image_size": [320, 240], "fps": 20},
    "path": {"kind": "route", "linear_speed_m_s": 0.1,
             "angular_speed_deg_s": 8.0, "height": 0.6, "pitch_deg": 70.0,
             "look_deg": 90.0, "sway_about": "camera",
             "sway_wavelength_m": 1.0, "ramp_frames": 4},
    "scene": {"boxes": {"per_m2": 2.0, "half": [0.05, 0.15],
                        "height": [0.03, 0.13]}},
    "engine": {"max_points": 4096, "max_kfs": 16, "auto_init_frames": 8},
    "limits": {"rel_rot_max": 0.0044, "rel_dir_max": 0.09,
               "kf_rel_rot_max": 0.0036, "kf_pyramid_max": 0.0},
    "reduced": []}
CELL = "route_small.explore"
MIX = {"loop": "closed", "explore": {"opening": 30, "frames": 120}}
SEED = 2_900_000_123


@pytest.mark.parametrize("look, about", [
    (90.0, "camera"), (0.0, "camera"), (90.0, "world"), (0.0, "world")])
def test_a_route_flies_at_the_configurations_speeds(look, about):
    cfg = celllib.merge(CARD_ROUTE, {"path": {"look_deg": look,
                                              "sway_about": about}})
    path = scene.make_path(cfg, CARD_FRAMES)
    p = cfg["path"]
    assert path.speed_m_s == pytest.approx(p["linear_speed_m_s"], rel=0.02)
    assert path.speed_deg_s == pytest.approx(p["angular_speed_deg_s"],
                                             rel=0.02)
    # Over the frames after the ramp, each step is the speed's.
    ramp = p["ramp_frames"]
    steps = np.linalg.norm(np.diff(path.centers[ramp:], axis=0), axis=-1)
    assert steps == pytest.approx(p["linear_speed_m_s"] / 20, rel=1e-9)
    # From rest: the first steps are shorter.
    assert np.linalg.norm(path.centers[1] - path.centers[0]) < steps[0] / 2


def test_no_route_frame_repeats_another():
    path = scene.make_path(CARD_ROUTE, CARD_FRAMES)
    assert path.n_unique == CARD_FRAMES
    assert [path.index(k) for k in range(CARD_FRAMES)] == list(
        range(CARD_FRAMES))
    with pytest.raises(IndexError):
        path.index(CARD_FRAMES)
    # Every frame a step further along the route.
    assert np.all(np.diff(path.centers[:, 0]) > 0)
    R_wc, c = reference.to_world(path.R, path.t)
    assert np.allclose(c, path.centers)
    assert np.allclose(np.einsum("nij,nkj->nik", path.R, path.R), np.eye(3))


def test_the_ground_of_a_route_does_not_repeat():
    """The texture covers all the ground the route's frames see with no
    texel sampled twice for two places: its extent holds every frame's
    view, so ``_tex_sample`` never wraps, and it is no tiling of the arc's
    512-texel square. Rendered frames all differ."""
    small = celllib.merge(CARD_ROUTE, {"camera": {"image_size": [94, 60]}})
    seq = scene.Sequence(small, SEED, "cpu", CARD_FRAMES)
    x0, y0, x1, y1 = seq.tex_extent
    Sv, Su = seq.tex_size
    assert (x1 - x0) * scene.TEX_SCALE == pytest.approx(Su)
    assert (y1 - y0) * scene.TEX_SCALE == pytest.approx(Sv)
    # The view of every frame, on the plane.
    b = scene.ground_bounds(scene.border_rays(seq.cam, seq.image_size),
                            seq.R, seq.t)
    assert b[:, 0].min() > x0 and b[:, 1].min() > y0
    assert b[:, 2].max() < x1 and b[:, 3].max() < y1
    assert x1 - x0 > seq.path.centers[-1, 0] - seq.path.centers[0, 0] > 20
    # No two texels 512 (the arc's period) or any 32-multiple apart agree
    # everywhere along the route.
    g = torch.Generator().manual_seed(SEED)
    tex = scene.make_texture(g, "cpu", seq.tex_size)
    row = tex[Sv // 2]
    for shift in range(32, Su // 2, 32):
        assert not torch.equal(row[:Su - shift], row[shift:])
    digests = {reference._digest(f) for f in seq.frames}
    assert len(digests) == CARD_FRAMES
    # Boxes are drawn over the route's ground at the configured density.
    area = (x1 - x0) * (y1 - y0)
    per_m2 = CARD_ROUTE["scene"]["boxes"]["per_m2"]
    assert len(seq.boxes) == round(per_m2 * area)
    assert seq.boxes[:, 0].min() >= x0 and seq.boxes[:, 0].max() <= x1


def test_a_route_whose_view_reaches_the_horizon_is_refused():
    flat = celllib.merge(CARD_ROUTE, {"path": {"pitch_deg": 30.0}})
    with pytest.raises(ValueError, match="horizon"):
        scene.Sequence(celllib.merge(flat, {"camera": {
            "image_size": [94, 60]}}), SEED, "cpu", 40)
    with pytest.raises(ValueError):
        scene.make_path(celllib.merge(CARD_ROUTE, {"path": {
            "kind": "spiral"}}), 40)
    with pytest.raises(ValueError):
        scene.make_path(CARD_ROUTE)
    with pytest.raises(ValueError, match="sway_about"):
        scene.make_path(celllib.merge(CARD_ROUTE, {"path": {
            "sway_about": "roll"}}), 40)


#: The parent's frames of the arc (``tum_fr1_desk`` at 160x120, all 81
#: rendered frames, on the CPU): sha1 of the stacked uint8 frames a seed.
ARC_DIGESTS = {3_600_000_001: "4fb7558b5817f82dd7115b5e5a05b60259331241",
               2_900_000_123: "2ea4764aacd4200700a044e2c10e59e15b36a6ee"}


@pytest.mark.parametrize("seed", sorted(ARC_DIGESTS))
def test_the_arcs_frames_are_as_they_were(seed):
    """The arc renders the frames it rendered before routes came: its
    512-texel square texture, its boxes, its poses, byte for byte."""
    cfg = celllib.merge(json.loads(
        (speclib.HERE / "configs" / "tum_fr1_desk.json").read_text()),
        {"camera": {"image_size": [160, 120]}})
    seq = scene.Sequence(cfg, seed, "cpu")
    assert seq.frames.shape == (81, 120, 160)
    assert hashlib.sha1(seq.frames.tobytes()).hexdigest() == \
        ARC_DIGESTS[seed]


def with_route_cell(root) -> Spec:
    """A checkout in ``root``: the benchmark with the rehearsal's route
    configuration, its explore mix and its cell added."""
    here = root / speclib.HERE.name
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(speclib.HERE / d, here / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "route_small.json").write_text(
        json.dumps(SMALL_ROUTE))
    (here / "traffic" / "explore_small.json").write_text(json.dumps(MIX))
    doc = json.loads((speclib.ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "route_small", "source": "a rehearsal",
                           "file": "bench_port/configs/route_small.json",
                           "reduced": [], "why": "a CPU rehearsal"})
    doc["workloads"].append({"name": CELL, "config": "route_small",
                             "traffic": "explore_small", "chips": 1,
                             "why": "a CPU rehearsal of the explore mix"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return Spec(root, here)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return with_route_cell(tmp_path_factory.mktemp("checkout"))


def run(spec, trace=False, tamper=None):
    out = celllib.run(spec, CELL, SEED, 1.0, trace, "cpu", 0.0,
                      tamper=tamper)
    limits = spec.limits(CELL)
    ok = {k: k in out.checks and out.checks[k] <= limits[k] for k in limits}
    failed = sum(i.stage != "TRACKING" or i.quality == 0 for i in out.infos)
    return out, ok, failed


@pytest.fixture(scope="module")
def sound(spec):
    return run(spec, trace=True)


def test_a_sound_exploring_run_is_correct_and_grows_the_map(sound):
    out, ok, failed = sound
    assert all(ok.values()) and failed == 0, (out.checks, out.notes)
    # The window is the route after the opening, whole, whatever the
    # seconds asked for.
    explore = MIX["explore"]
    assert out.frame_idx == list(range(explore["opening"], explore["opening"]
                                       + explore["frames"]))
    assert out.counted.all() and not out.lost.any()
    assert out.window_s > 1.0
    kfs = out.ctx["keyframes"]
    assert kfs and all(c is not None for _, c in kfs), out.notes
    assert out.checks["kfs_added"] == len(kfs)
    assert out.checks["kf_lag_frames_max"] == max(c - a for a, c in kfs)
    # An integration lands passes after its keyframe was queued.
    assert all(c > a for a, c in kfs)
    n_kfs = [i.n_kfs for i in out.infos]
    assert n_kfs[-1] > n_kfs[0] and n_kfs == sorted(n_kfs)


def test_set_up_flies_the_opening(sound):
    out, _, _ = sound
    setup = out.notes[0]
    assert setup.startswith("set-up: the route's opening, 30 of its 150 ")
    assert out.ctx["n_setup"] == 30


def test_the_explore_readers_read_a_traced_run(spec, sound):
    out, _, _ = sound
    ctx = out.ctx
    lag = spec.reader("kf_lag_ms.explore20")(ctx)
    t = ctx["returned"]
    assert lag == pytest.approx(1e3 * float(np.median(
        [t[c] - t[a] for a, c in ctx["keyframes"]])))
    assert 0.0 < spec.reader("mapping_pass_pct.explore20")(ctx) < 100.0
    # The CPU's trace holds no device activity: the device readers find
    # nothing to read, and say so.
    for name in ("map_device_ms_per_s.explore20",
                 "track_device_ms.explore20"):
        value = spec.reader(name)(ctx)
        assert value is None or value > 0
    assert ctx["trace_ns"] is not None
    w0, w1 = ctx["trace_ns"]
    returned = out.ctx["spans"].of("process_frame")[ctx["n_setup"]:]
    assert returned[-1][2] <= w1 and w0 > returned[0][1]


def test_keyframe_lags_follow_the_queue():
    lags = celllib.keyframe_lags
    F = type("F", (), {})

    def frames(added):
        out = []
        for a in added:
            f = F()
            f.added_kf = a
            out.append(f)
        return out
    # Two keyframes queued before the window land first; the window's
    # keyframes land in turn after them.
    added = frames([False, True, False, False, True, False, False])
    assert lags(added, [0, 2, 3, 6], 2) == [(1, 3), (4, 6)]
    assert lags(added, [0, 2, 3], 2) == [(1, 3), (4, None)]
    assert lags(added, [5], 0) == [(1, 5), (4, None)]


def stubbed_mapping(eng):
    """No mapping pass in the window: ``MapMaker.step`` does nothing from
    the window's first frame on (keyframes are queued and never
    integrated, the map stops growing)."""
    step, n = eng.process_frame, [0]
    n_setup = MIX["explore"]["opening"]

    def counted(im):
        n[0] += 1
        if n[0] > n_setup:
            eng.mapmaker.step = lambda newest_kf=None: None
        return step(im)
    eng.process_frame = counted


def test_an_exploring_run_without_mapping_is_not_correct(spec):
    out, ok, failed = run(spec, tamper=stubbed_mapping)
    assert not all(ok.values()) or failed > 0, (out.checks, out.notes)
    assert all(c is None for _, c in out.ctx["keyframes"])


def test_the_reference_in_bfloat16_is_not_correct_on_a_route(spec):
    """The control: the reference itself in bfloat16 in the program's
    place, over the rehearsal's route (its opening as set-up, the rest as
    the window, a keyframe every 20 frames of the route)."""
    limits = spec.limits(CELL)
    got = control.reference_bf16(spec, CELL, SEED, 0, "cpu")
    assert not all(got[k] <= limits[k] for k in limits), got
    assert got["kf_pyramid_max"] > limits["kf_pyramid_max"]
