"""A whole run of a cell on the CPU, through the kernels' plain versions, at
a small size: set-up, the window and the check. The sound run is correct;
each fault a cell can have, planted under the timed path, and the program's
lower-precision path (the control) come out not correct.

A frame is the engine's whole batch and the run uses one device, so of the
faults a run can have these apply: a step that returns its state unchanged
(each frame reports the pose the step was handed, the previous frame's),
and an answer altered where it is produced (a frame's pose; a keyframe's
stored image)."""

import dataclasses
import math

import pytest
import torch

from bench_port import cell as celllib
from bench_port import control
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


@pytest.fixture(autouse=True)
def few_sweeps(monkeypatch):
    monkeypatch.setattr(celllib, "MIN_SWEEPS", 2)


def run(tamper=None, overrides=None):
    over = celllib.merge(SMALL, overrides)
    spec = Spec()
    out = celllib.run(spec, CELL, SEED, WINDOW_S, False, "cpu", 0.0,
                      overrides=over, tamper=tamper)
    limits = spec.config(spec.cell(CELL)["config"])["limits"]
    return out, {k: out.checks[k] <= limits[k] for k in limits}


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


def test_a_sound_run_is_correct():
    out, ok = run()
    assert all(ok.values()), out.checks
    assert len(out.infos) > 0 and out.ctx["frames"] == len(out.infos)
    assert out.window_s > WINDOW_S


@pytest.mark.parametrize("tamper", [stale_state, altered_pose,
                                    altered_keyframe])
def test_a_fault_under_the_timed_path_is_not_correct(tamper):
    out, ok = run(tamper=tamper)
    assert not all(ok.values()), out.checks


def test_the_lower_precision_control_is_not_correct():
    out, ok = run(overrides=control.LOWER_PRECISION)
    assert not ok["kf_pyramid_max"], out.checks


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Spec().doc["workloads"]])
def test_the_reference_in_bfloat16_fails_each_compared_number(cell):
    """The reference itself put in the program's place in bfloat16, at the
    cell's own size: each number that a lower precision of the poses or
    pyramids moves reads above its limit."""
    spec = Spec()
    limits = spec.config(spec.cell(cell)["config"])["limits"]
    got = control.reference_bf16(spec, cell, SEED, 600, "cpu")
    assert all(got[k] > limits[k] for k in limits), got
