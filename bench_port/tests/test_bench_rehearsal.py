"""A whole run of a cell on the CPU, through the kernels' plain versions, at
a small size: set-up, the window and the check. The sound run is correct;
each fault a cell can have, planted under the timed path, and the program's
lower-precision path (the control) come out not correct.

A frame is the engine's whole batch and the run uses one device, so of the
faults a run can have these apply: a step that returns its state unchanged
(each frame reports the pose the step was handed, the previous frame's),
and an answer altered where it is produced (a frame's pose; a keyframe's
stored image; the relocalizer's pose, or its verdict, after a cover).

The cover mix runs here with covers sized for the CPU's few frames a
second (``COVER``): its schedule, not its parameters, is what is tested.
Its cell is not in ``BENCHMARK.json`` until the program recovers soundly
after a cover (PERF.md, section 7): the tests run it from a checkout of
their own (``spec``), whose ``BENCHMARK.json`` adds the cell and whose
``recover30`` mix holds the CPU's covers."""

import dataclasses
import json
import math
import shutil

import pytest
import torch

from bench_port import cell as celllib
from bench_port import control
from bench_port import spec as speclib
from bench_port.spec import Spec

CELL = "tum_fr1_desk.offline"
SMALL = {"camera": {"image_size": [320, 240]},
         "path": {"angular_speed_deg_s": 60.0, "half_sweep_rad": 0.6},
         "engine": {"max_points": 1024, "max_kfs": 8, "auto_init_frames": 6}}
SEED = 2_900_000_123
# Long enough to hold a turn at an end of the (short, 18-frame) sweep even
# at two frames a second, as a loaded CPU runs: a stale pose keeps the
# motion between frames right until the camera turns.
WINDOW_S = 12.0
RECOVER = "tum_fr1_desk.recover30"
RECOVER_CELL = {"name": RECOVER, "config": "tum_fr1_desk",
                "traffic": "recover30", "chips": 1,
                "why": "the lens covered black 30-60 frames every 300"}
#: Covers of 9-11 frames (18-22 degrees of the small sweep's motion, beyond
#: what the tracker takes back unaided) every 24 from the window's 5th
#: frame: an event in a window of 20 frames, two in one of 45.
COVER = {"cover": {"every_frames": 24, "frames": [9, 11], "first_frame": 5}}
#: What the parent's offline rehearsal ran (this seed and size): set-up's
#: frames, and the numbers it computed.
OFFLINE_SETUP_FRAMES = 148
OFFLINE_CHECKS = ["kf_pos_max", "kf_pyramid_max", "kf_rel_rot_max",
                  "point_dist_p90", "pose_pos_max", "pose_rot_max",
                  "rel_dir_max", "rel_rot_max"]


@pytest.fixture(autouse=True)
def few_sweeps(monkeypatch):
    monkeypatch.setattr(celllib, "MIN_SWEEPS", 2)


def with_cover_cell(root) -> Spec:
    """A checkout in ``root``: the benchmark with the cover mix's cell
    added, its configurations, readers and mixes, the cover mix's
    schedule replaced by the CPU's (``COVER``), its limits kept."""
    here = root / speclib.HERE.name
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(speclib.HERE / d, here / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((speclib.ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append(RECOVER_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    mix = here / "traffic" / f"{RECOVER_CELL['traffic']}.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), **COVER)))
    return Spec(root, here)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return with_cover_cell(tmp_path_factory.mktemp("checkout"))


def run(spec, tamper=None, overrides=None, cell=CELL, seconds=WINDOW_S):
    over = celllib.merge(SMALL, overrides)
    out = celllib.run(spec, cell, SEED, seconds, False, "cpu", 0.0,
                      overrides=over, tamper=tamper)
    limits = spec.limits(cell)
    return out, {k: k in out.checks and out.checks[k] <= limits[k]
                 for k in limits}


def stale_state(eng):
    step, last = eng.process_frame, []

    def unchanged(im):
        info = step(im)
        pose = last[-1] if last else info.pose
        last.append(info.pose)
        return info._replace(pose=pose)
    eng.process_frame = unchanged


def altered_pose(eng):
    from ptam_cg_tpu_torch.utils.se3 import SE3
    step, n = eng.process_frame, [0]

    def altered(im):
        info = step(im)
        n[0] += 1
        if n[0] % 4:
            return info
        # A turn of 0.01 rad about the optical axis and a shift of 5% of
        # the distance to the map's origin: every fourth frame, so that
        # several land in the window whatever the CPU's rate.
        c, s = math.cos(0.01), math.sin(0.01)
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                            dtype=info.pose.R.dtype, device=info.pose.R.device)
        t = info.pose.t.clone()
        t[0] += 0.05 * torch.linalg.vector_norm(t)
        return info._replace(pose=SE3(turn @ info.pose.R, t))
    eng.process_frame = altered


def altered_keyframe(eng):
    snapshot = eng.snapshot

    def altered():
        m = snapshot()
        atlas = m.kf_atlas.clone()
        atlas[0, 5, 5] += 1.0
        return dataclasses.replace(m, kf_atlas=atlas)
    eng.snapshot = altered


@pytest.fixture(scope="module")
def sound(spec):
    """One sound run of the offline cell (its own MIN_SWEEPS: a module's
    fixture outlives ``few_sweeps``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(celllib, "MIN_SWEEPS", 2)
        return run(spec)


def test_a_sound_run_is_correct(sound):
    out, ok = sound
    assert all(ok.values()), out.checks
    assert len(out.infos) > 0 and out.ctx["frames"] == len(out.infos)
    assert out.window_s > WINDOW_S


def test_a_mix_without_cover_runs_the_parents_frames_and_checks(sound):
    """The offline cell: set-up as long as the parent's, the window's
    frames every one in turn from there, all attempted, none left out,
    and exactly the parent's numbers."""
    out, _ = sound
    n = len(out.infos)
    assert out.frame_idx == list(range(OFFLINE_SETUP_FRAMES,
                                       OFFLINE_SETUP_FRAMES + n))
    assert out.counted.all() and not out.lost.any()
    assert out.ctx["events"] == [] and sorted(out.checks) == OFFLINE_CHECKS
    assert out.notes[0].startswith(f"set-up: {OFFLINE_SETUP_FRAMES} frames")


@pytest.mark.parametrize("cell", [CELL, RECOVER])
@pytest.mark.parametrize("tamper", [stale_state, altered_pose,
                                    altered_keyframe])
def test_a_fault_under_the_timed_path_is_not_correct(spec, tamper, cell):
    out, ok = run(spec, tamper=tamper, cell=cell)
    assert not all(ok.values()), out.checks


def _relocalizer(eng, alter):
    """Alter each result of the engine's relocalizer where it is produced."""
    from ptam_cg_tpu_torch.models import programs
    call = eng._run

    def altered(prog, *a):
        out = call(prog, *a)
        return alter(out) if isinstance(prog, programs.RelocProgram) else out
    eng._run = altered


def never_recovers(eng):
    _relocalizer(eng, lambda r: dataclasses.replace(
        r, success=torch.zeros_like(r.success)))


def stops_recovering(eng):
    """The relocalizer never succeeds after set-up's cover."""
    step, seen = eng.process_frame, [0, False]

    def counted(im):
        covered = not im.any()
        seen[0] += covered and not seen[1]
        seen[1] = covered
        return step(im)
    eng.process_frame = counted
    _relocalizer(eng, lambda r: r if seen[0] < 2 else dataclasses.replace(
        r, success=torch.zeros_like(r.success)))


def turned_recovery(eng):
    """Each recovery lands 0.05 rad off, turned about the world's origin,
    and the frames after it keep that turn: the pose the engine returns,
    altered from each cover on (turned and back in turns). The relative
    motion between frames keeps no trace of it; only the motion across
    the cover does. (A relocalizer's own pose turned so is no fault of the
    output: the tracker takes it back on the next frame.)"""
    from ptam_cg_tpu_torch.utils.se3 import SE3
    step, state = eng.process_frame, dict(turned=False, covered=False)
    c, s = math.cos(0.05), math.sin(0.05)

    def altered(im):
        covered = not im.any()
        if covered and not state["covered"]:
            state["turned"] = not state["turned"]
        state["covered"] = covered
        info = step(im)
        if not state["turned"]:
            return info
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                            dtype=info.pose.R.dtype, device=info.pose.R.device)
        return info._replace(pose=SE3(info.pose.R @ turn, info.pose.t))
    eng.process_frame = altered


def dodgy_after_recovery(eng):
    """After each cover, the three frames that follow the report of the
    recovery come back turned 0.05 rad about the optical axis, each rated
    DODGY (by the frame after it, as the engine reports a frame's quality):
    poses the engine itself does not vouch for are judged all the same."""
    from ptam_cg_tpu_torch.utils.se3 import SE3
    step = eng.process_frame
    state = dict(covered=False, after=False, left=0)
    c, s = math.cos(0.05), math.sin(0.05)

    def altered(im):
        covered = not im.any()
        if state["covered"] and not covered:
            state["after"] = True
        state["covered"] = covered
        info = step(im)
        if state["left"]:
            state["left"] -= 1
            info = info._replace(quality=1)
            if not state["left"]:
                return info
            turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                                dtype=info.pose.R.dtype,
                                device=info.pose.R.device)
            return info._replace(pose=SE3(turn @ info.pose.R, info.pose.t))
        if (state["after"] and info.stage == "TRACKING"
                and info.quality == celllib.GOOD):
            state.update(after=False, left=4)
        return info
    eng.process_frame = altered


def test_a_sound_run_under_covers_is_correct_and_recovers(spec):
    out, ok = run(spec, cell=RECOVER)
    assert all(ok.values()), out.checks
    events = out.ctx["events"]
    done = [e for e in events if e["status"] == "recovered"]
    assert done and all(e["status"] != "unrecovered" for e in events), (
        out.notes)
    # A covered frame is not attempted; a frame after a cover, before the
    # recovered one, is attempted and lost; the recovered frame's quality
    # comes with the next frame.
    for e in events:
        s = e["start"]
        assert not out.counted[s:s + e["frames"]].any()
    for e in done:
        assert e["reported"] == e["recovered"] + 1 >= e["first"] + 1
        assert out.lost[e["first"]:e["recovered"]].all()
        assert not out.lost[e["recovered"]]
    assert out.lost.sum() == sum(e["recovered"] - e["first"] for e in done)
    assert out.checks["unrecovered"] == 0
    frames = sorted(e["reported"] - e["first"] + 1 for e in done)
    assert spec.reader("recovery_frames.recover30")(out.ctx) == (
        pytest.approx((frames[(len(frames) - 1) // 2]
                       + frames[len(frames) // 2]) / 2))


def test_a_traced_run_under_covers_traces_one_whole_event(spec):
    over = celllib.merge(SMALL, None)
    out = celllib.run(spec, RECOVER, SEED, WINDOW_S, True, "cpu", 0.0,
                      overrides=over)
    w0, w1 = out.ctx["trace_ns"]
    frames = out.ctx["spans"].of("process_frame")[out.ctx["n_setup"]:]
    whole = [e for e in out.ctx["events"] if e["status"] == "recovered"
             and w0 <= frames[e["start"]][1]
             and frames[e["reported"]][2] <= w1]
    assert whole, out.notes
    # The frames up to a recovery outside the traced stretch, timed.
    assert spec.reader("lost_frame_ms.recover30")(out.ctx) > 0, out.notes


def test_poses_after_a_recovery_rated_dodgy_are_still_judged(spec):
    out, ok = run(spec, tamper=dodgy_after_recovery, cell=RECOVER)
    assert [e for e in out.ctx["events"] if e["status"] == "recovered"], (
        out.notes)
    assert not ok["rel_rot_max"] and not all(ok.values()), out.checks


def test_a_run_whose_setup_does_not_recover_fails(spec):
    with pytest.raises(RuntimeError, match="did not recover"):
        run(spec, tamper=never_recovers, cell=RECOVER)


def test_a_relocalizer_that_never_succeeds_leaves_events_unrecovered(spec):
    # The tracker takes some events back unaided where the camera passes
    # the pose it lost (the window's first, at this seed): a window long
    # enough for the third cover to start even at three frames a second.
    out, ok = run(spec, tamper=stops_recovering, cell=RECOVER,
                  seconds=2.5 * WINDOW_S)
    assert out.checks["unrecovered"] > 0 and not ok["unrecovered"], out.notes
    assert not all(ok.values())


def test_a_relocalizer_pose_turned_fails_the_relocalization_check(spec):
    out, ok = run(spec, tamper=turned_recovery, cell=RECOVER)
    assert not ok["reloc_rel_rot_max"], out.checks


@pytest.mark.parametrize("cell", [CELL, RECOVER])
def test_the_lower_precision_control_is_not_correct(spec, cell):
    out, ok = run(spec, overrides=control.LOWER_PRECISION, cell=cell)
    assert not ok["kf_pyramid_max"], out.checks


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Spec().doc["workloads"]] + [RECOVER])
def test_the_reference_in_bfloat16_fails_each_compared_number(spec, cell):
    """The reference itself put in the program's place in bfloat16, at the
    cell's own size (a window's 3,300 frames, with its covers): each number
    that a lower precision of the poses or pyramids moves reads above its
    limit. The reference recovers on the first frame after each cover, so
    no event of it is unrecovered."""
    limits = spec.limits(cell)
    got = control.reference_bf16(spec, cell, SEED, 3300, "cpu")
    moved = [k for k in limits if k != "unrecovered"]
    assert all(got[k] > limits[k] for k in moved), got
    assert got.get("unrecovered", 0) == 0
