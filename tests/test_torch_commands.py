"""The port's command console (tests/test_commands.py's cases, mirrored),
and its tunables table and script parser against the JAX package's."""

import numpy as np
import pytest
import torch

from ptam_cg_tpu.config import CameraConfig, EngineConfig, MapMakerConfig
from ptam_cg_tpu.io import checkpoint as jcheckpoint
from ptam_cg_tpu.io import commands as jcmdlib
from ptam_cg_tpu.models import engine as jengine
from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import checkpoint
from ptam_cg_tpu_torch.io import commands as cmdlib
from ptam_cg_tpu_torch.models import engine as tengine

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (160, 120)


def make_engine():
    cfg = tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(candidate_min_shi_tomasi_score=70.0))
    return tengine.SLAMEngine(cfg, image_size=SIZE, max_points=256,
                              max_kfs=4, auto_init_frames=None, device="cpu")


def test_tunables_are_jax_s_less_the_decision_interval():
    jeng = jengine.SLAMEngine(
        EngineConfig(camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
                     mapmaker=MapMakerConfig(
                         candidate_min_shi_tomasi_score=70.0)),
        image_size=SIZE, max_points=256, max_kfs=4, auto_init_frames=None)
    want = set(jcmdlib._tunables(jeng)) - {"Engine.DecisionInterval"}
    eng = make_engine()
    assert set(cmdlib._tunables(eng)) == want
    for name in sorted(want):
        assert (cmdlib._tunables(eng)[name][0]()
                == jcmdlib._tunables(jeng)[name][0]()), name


def test_tunable_assignment_and_get():
    eng = make_engine()
    con = cmdlib.CommandConsole(eng)
    con.execute("Tracker.MinFramesBetweenKFs=7")
    assert eng.cfg.tracker.min_frames_between_kfs == 7
    assert con.execute("MapMaker.MaxQueueSize=2") == "MapMaker.MaxQueueSize=2"
    assert eng.cfg.mapmaker.max_queue_size == 2
    con.execute("Bundle.MaxIterations=9")
    assert eng.mapmaker.ba_cfg.max_iterations == 9
    con.execute("Bundle.TierFloorMeas=8192")
    assert eng.mapmaker._tier_m_floor == 8192
    assert con.execute("Get Bundle.MaxIterations") \
        == "Bundle.MaxIterations=9"
    with pytest.raises(cmdlib.CommandError, match="Get"):
        con.execute("Get Nothing.Here")


def test_decision_interval_is_refused():
    """The JAX engine's decision interval has no counterpart: the port
    reads each frame's decisions at the next frame."""
    con = cmdlib.CommandConsole(make_engine())
    with pytest.raises(cmdlib.CommandError, match="decision interval"):
        con.execute("Engine.DecisionInterval=4")


def test_unknown_tunable_rejected():
    con = cmdlib.CommandConsole(make_engine())
    with pytest.raises(cmdlib.CommandError, match="compile-baked"):
        con.execute("Tracker.RotationEstimatorBlur=1.5")


def test_verbs_reset_poke_info():
    eng = make_engine()
    con = cmdlib.CommandConsole(eng)
    assert "init requested" in con.execute("PokeTracker")
    assert eng._init_requested
    assert "init requested" in con.execute("SpacePressed // a comment")
    assert "stage=NOT_STARTED" in con.execute("ShowInfo")
    assert "reset" in con.execute("Reset")
    assert not eng._init_requested
    for verb in ("DrawMap", "DrawAR", "GLWindow"):
        assert "no-op" in con.execute(verb)
    assert con.execute("   // only a comment") is None
    with pytest.raises(cmdlib.CommandError):
        con.execute("FlyToTheMoon")
    assert len(con.log) == 7


def test_save_and_dump_map_verbs(tmp_path):
    eng = make_engine()
    con = cmdlib.CommandConsole(eng)
    path = str(tmp_path / "m.npz")
    assert path in con.execute(f"SaveMap {path}")
    m, trk = checkpoint.load_map(path, device="cpu")
    assert m.point_pos.shape == eng.map.point_pos.shape
    assert torch.equal(trk.pose.R, eng.tracker_state.pose.R)
    jm, jtrk = jcheckpoint.load_map(path)       # the JAX package reads it
    np.testing.assert_array_equal(np.asarray(jm.kf_atlas),
                                  eng.map.kf_atlas.numpy())
    prefix = str(tmp_path) + "/d_"
    assert "dumped" in con.execute(f"DumpMap {prefix}")
    assert (tmp_path / "d_map.dump").exists()


def test_scripted_console_drives_run(tmp_path):
    """A command file changes live state as frames go by; its parse
    equals the JAX package's."""
    script = tmp_path / "cmds.txt"
    script.write_text(
        "MapMaker.MaxQueueSize=2   // comment\n"
        "@5 ShowInfo\n"
        "\n"
        "@3 Tracker.MinFramesBetweenKFs=9\n")
    parsed = cmdlib.load_command_script(str(script))
    assert parsed == jcmdlib.load_command_script(str(script))
    eng = make_engine()
    sc = cmdlib.ScriptedConsole(eng, parsed)
    ran = {i: sc.on_frame(i) for i in range(8)}
    assert eng.cfg.mapmaker.max_queue_size == 2
    assert eng.cfg.tracker.min_frames_between_kfs == 9
    assert [len(ran[i]) for i in range(8)] == [1, 0, 0, 1, 0, 1, 0, 0]
    assert "stage=" in ran[5][0]
