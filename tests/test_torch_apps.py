"""The port's entry points, in process on the CPU: ``apps.run_tum`` on a
TUM-layout dataset written from tests/test_slam_e2e.py's orbit (26
frames at 320x240, with ground truth), through the native frame pump and
through the Python reader, with a settings file, a console script, a
checkpoint, a map render and AR frames; and ``apps.run_synthetic`` with
the mapping worker."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch.apps import run_synthetic, run_tum
from ptam_cg_tpu_torch.io import checkpoint, synth, tum

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=26,
                                  seed=5, height=1.5, radius=0.35,
                                  sweep=1.3, device="cpu")
    tum.write_synthetic_dataset(str(root), [seq.frame(i) for i in range(26)],
                                poses=[seq.pose(i) for i in range(26)])
    (root / "settings.cfg").write_text(
        "Camera.Parameters = [ 1.0803 1.43987 0.519983 0.548655 0.244943 ]\n"
        "MapMaker.CandidateMinShiTomasiScore = 70\n")
    return root


@pytest.mark.parametrize("reader", ["native", "python"])
def test_run_tum(dataset, tmp_path, reader):
    script = tmp_path / "cmds.txt"
    script.write_text("@10 Bundle.MaxIterations=10\n"
                      f"@14 SaveMap {tmp_path / 'mid.npz'}\n"
                      "@18 ShowInfo\n")
    argv = [str(dataset), "--device", "cpu",
            "--settings", str(dataset / "settings.cfg"),
            "--commands", str(script),
            "--checkpoint", str(tmp_path / "final.npz"),
            "--map", str(tmp_path / "map.ppm"),
            "--ar", str(tmp_path / "ar"), "--ar-every", "5"]
    if reader == "native":
        argv.append("--native")
    out = run_tum.main(argv)
    eng = out["engine"]
    infos = out["infos"]
    assert len(infos) == 26
    tracked = [i for i in infos if i.stage == "TRACKING"]
    assert len(tracked) > 10
    assert sum(i.quality == 2 for i in tracked) > 0.8 * len(tracked)
    # tests/test_slam_e2e.py's ATE bar.
    assert out["ate"] < 0.05 * max(out["span"], 0.1), out
    # Every console line ran at its frame.
    assert [f for f, _ in out["console"]] == [10, 14, 18]
    assert out["console"][0][1] == "Bundle.MaxIterations=10"
    assert eng.mapmaker.ba_cfg.max_iterations == 10
    assert "stage=TRACKING" in out["console"][2][1]
    assert (tmp_path / "mid.npz").is_file()
    # The checkpoint is the engine's final map, array for array.
    m, trk = checkpoint.load_map(str(tmp_path / "final.npz"), device="cpu")
    final = eng.snapshot()
    for f in dataclasses.fields(m):
        assert torch.equal(getattr(m, f.name), getattr(final, f.name)), f
    assert torch.equal(trk.pose.R, eng.tracker_state.pose.R)
    assert (tmp_path / "map.ppm").read_bytes().startswith(b"P6 800 800 255")
    ar_frames = sorted((tmp_path / "ar").iterdir())
    assert [p.name for p in ar_frames] == [
        f"ar_{i:05d}.ppm" for i in range(26) if i % 5 == 0
        and infos[i].stage == "TRACKING"]
    raw = ar_frames[0].read_bytes()
    pixels = np.frombuffer(raw[len(b"P6 320 240 255\n"):], np.uint8)
    assert raw.startswith(b"P6 320 240 255") and pixels.std() > 10


def test_run_synthetic_with_the_mapping_worker():
    out = run_synthetic.main(["--async-mapping", "--device", "cpu",
                              "--frames", "26"])
    assert out["engine"].async_mapping
    assert out["ate"] < 0.05 * max(out["span"], 0.1)
    assert out["engine"]._map_thread is None      # closed


def test_run_tum_defaults_to_the_card(dataset):
    """Without ``--device cpu`` the engine is made on the card: with no
    card that raises, and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        run_tum.main([str(dataset), "--frames", "2"])


def test_run_tum_help_from_the_command_line():
    """The module runs as ``python -m`` with examples/run_tum.py's flags
    (less the TPU's) and ``--device``."""
    proc = subprocess.run(
        [sys.executable, "-m", "ptam_cg_tpu_torch.apps.run_tum", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for flag in ("--settings", "--frames", "--native", "--ar", "--ar-every",
                 "--map", "--checkpoint", "--commands", "--rate",
                 "--device"):
        assert flag in proc.stdout, flag
